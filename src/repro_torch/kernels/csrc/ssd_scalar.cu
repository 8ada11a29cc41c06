// The chunked Mamba2 SSD scan, scalar form: the kernel ssd.cu held
// before its tensor-core redesign, kept beside it for the chunks that
// design's layout cannot hold.
//
//   h_t = exp(la_t) h_{t-1} + dtx_t (x) B_t;   y_t = h_t . C_t
//
// evaluated chunk by chunk (Lc tokens, the last chunk identity-padded:
// la = 0, dtx = B = C = 0), with cum = cumsum(la) inside the chunk and
// tot = cum[Lc - 1]:
//
//   y_i   = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dtx_j
//           + exp(cum_i) (h . C_i)                       (carried state)
//   h'    = exp(tot) h + sum_j exp(tot - cum_j) dtx_j (x) B_j
//
// la (B, S, H) float32; dtx (B, S, H, hd), B and C (B, S, N) in float32 or
// bfloat16 (upcast on load); h0 (B, H, hd, N) float32.  Writes y (B, S, H,
// hd) float32 and the final state once.
//
// Replaces: src/repro/kernels/ssd.py::ssd_kernel, with ssd.cu, where
// ssd.cu's layout does not fit: ops.ssd takes ssd.cu's kernel wherever
// its ssd_smem_bytes(hd, N, Lc) fits a block, and this one elsewhere when
// ssd_scalar_smem_bytes does: hd <= 32 with N >= 249 and chunks up to 82
// tokens, 11,563 of the 8.8 M (hd, N, Lc) up to (256, 2048, 256) this
// kernel takes (scripts/ssd_shapes.py).  Both launches count under
// ops.LAUNCHES["ssd"].
//
// Design: grid (H, B), 256 threads, everything of one chunk in shared
// memory (opted in past 48 KB): la -> cum, exp(cum), exp(tot - cum) (3 Lc),
// dtx (Lc x hd), B and C (Lc x (N + 1), padded against bank conflicts), the
// masked tile W_ij = exp(cum_i - cum_j) (C_i . B_j) (Lc x Lc) and the state
// (hd x (N + 1)).  Per chunk: one thread takes the cumulative sum in
// order; the threads form W (one dot over N per pair), then y (thread (i,
// d): a sum over j <= i and one over n; consecutive threads take
// consecutive d, so y is written coalesced), then the state update
// (consecutive threads take consecutive n).  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn): the result differs from the
// plain version (torch.cumsum and einsums) only in the order of its sums,
// and the order is set by the shapes alone, so a row alone gives what it
// gives in a batch.
//
// Bound: operations at these shapes (a dot over N for every pair of a
// chunk, on the CUDA cores in float32); each (b, h) block recomputes C.B,
// which does not depend on h, and one block per (b, h) runs the chunks in
// order.  It runs on no model path of the repository (their chunks fit
// ssd.cu).
#include "recurrent.cuh"

#define SSD_THREADS 256

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_kernel_scalar(const float *__restrict__ la, const T *__restrict__ dtx,
           const T *__restrict__ Bf, const T *__restrict__ Cf,
           const float *__restrict__ h0, float *__restrict__ y,
           float *__restrict__ hout, int S, int H, int hd, int N, int Lc) {
  extern __shared__ float sm[];
  const int NP = N + 1;
  float *cum = sm;                   // Lc
  float *ecum = cum + Lc;            // Lc: exp(cum_i)
  float *wj = ecum + Lc;             // Lc: exp(tot - cum_j)
  float *xs = wj + Lc;               // Lc x hd
  float *bs = xs + Lc * hd;          // Lc x NP
  float *cs = bs + Lc * NP;          // Lc x NP
  float *W = cs + Lc * NP;           // Lc x Lc
  float *hs = W + Lc * Lc;           // hd x NP
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bh = (size_t)b * H + h;
  for (int p = tid; p < hd * N; p += SSD_THREADS)
    hs[(p / N) * NP + p % N] = h0[bh * hd * N + p];
  const int n_chunks = (S + Lc - 1) / Lc;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Lc;
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < Lc; i += SSD_THREADS) {
      const int t = t0 + i;
      cum[i] = t < S ? la[((size_t)b * S + t) * H + h] : 0.f;
    }
    for (int p = tid; p < Lc * hd; p += SSD_THREADS) {
      const int t = t0 + p / hd;
      xs[p] = t < S ? rec_ld(dtx + (((size_t)b * S + t) * H + h) * hd +
                             p % hd)
                    : 0.f;
    }
    for (int p = tid; p < Lc * N; p += SSD_THREADS) {
      const int i = p / N, n = p % N, t = t0 + i;
      const size_t o = ((size_t)b * S + t) * N + n;
      bs[i * NP + n] = t < S ? rec_ld(Bf + o) : 0.f;
      cs[i * NP + n] = t < S ? rec_ld(Cf + o) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Lc; ++i) {
        run = __fadd_rn(run, cum[i]);
        cum[i] = run;
      }
    }
    __syncthreads();
    const float tot = cum[Lc - 1];
    for (int i = tid; i < Lc; i += SSD_THREADS) {
      ecum[i] = expf(cum[i]);
      wj[i] = expf(__fsub_rn(tot, cum[i]));
    }
    for (int p = tid; p < Lc * Lc; p += SSD_THREADS) {
      const int i = p / Lc, j = p % Lc;
      float v = 0.f;
      if (j <= i) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n)
          cb = __fadd_rn(cb, __fmul_rn(cs[i * NP + n], bs[j * NP + n]));
        v = __fmul_rn(expf(__fsub_rn(cum[i], cum[j])), cb);
      }
      W[p] = v;
    }
    __syncthreads();
    // y of the chunk: intra-chunk part plus the carried state's
    for (int p = tid; p < Lc * hd; p += SSD_THREADS) {
      const int i = p / hd, d = p % hd, t = t0 + i;
      if (t >= S)
        continue;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j)
        intra = __fadd_rn(intra, __fmul_rn(W[i * Lc + j], xs[j * hd + d]));
      float yh = 0.f;
      for (int n = 0; n < N; ++n)
        yh = __fadd_rn(yh, __fmul_rn(hs[d * NP + n], cs[i * NP + n]));
      y[(((size_t)b * S + t) * H + h) * hd + d] =
          __fadd_rn(intra, __fmul_rn(ecum[i], yh));
    }
    __syncthreads();  // y has read the carried state
    const float etot = expf(tot);
    for (int p = tid; p < hd * N; p += SSD_THREADS) {
      const int d = p / N, n = p % N;
      float X = 0.f;
      for (int j = 0; j < Lc; ++j)
        X = __fadd_rn(X, __fmul_rn(__fmul_rn(wj[j], xs[j * hd + d]),
                                   bs[j * NP + n]));
      hs[d * NP + n] = __fadd_rn(__fmul_rn(etot, hs[d * NP + n]), X);
    }
  }
  __syncthreads();
  for (int p = tid; p < hd * N; p += SSD_THREADS)
    hout[bh * hd * N + p] = hs[(p / N) * NP + p % N];
}

// Shared memory of one block: cum, exp(cum), exp(tot - cum), the chunk's
// dtx, its B and C (rows padded to N + 1), the decay tile and the state.
// The wrapper reads it to choose this kernel or refuse the chunk.
extern "C" int ssd_scalar_smem_bytes(int hd, int N, int Lc) {
  return (int)(sizeof(float) * ((size_t)3 * Lc + (size_t)Lc * hd +
                                (size_t)2 * Lc * (N + 1) + (size_t)Lc * Lc +
                                (size_t)hd * (N + 1)));
}

template <typename T>
static int launch(const void *la, const void *dtx, const void *Bf,
                  const void *Cf, const void *h0, void *y, void *hout, int B,
                  int S, int H, int hd, int N, int Lc, cudaStream_t st) {
  const size_t smem = ssd_scalar_smem_bytes(hd, N, Lc);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_scalar<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  ssd_kernel_scalar<T><<<dim3(H, B), SSD_THREADS, smem, st>>>(
      (const float *)la, (const T *)dtx, (const T *)Bf, (const T *)Cf,
      (const float *)h0, (float *)y, (float *)hout, S, H, hd, N, Lc);
  return (int)cudaGetLastError();
}

extern "C" int ssd_scalar_launch(const void *la, const void *dtx,
                                 const void *Bf, const void *Cf,
                                 const void *h0, void *y, void *hout, int B,
                                 int S, int H, int hd, int N, int Lc,
                                 int bf16, void *stream) {
  if (bf16)
    return launch<__nv_bfloat16>(la, dtx, Bf, Cf, h0, y, hout, B, S, H, hd,
                                 N, Lc, (cudaStream_t)stream);
  return launch<float>(la, dtx, Bf, Cf, h0, y, hout, B, S, H, hd, N, Lc,
                       (cudaStream_t)stream);
}
