// The RWKV6 WKV recurrence over a sequence, the state resident for the
// whole of it: for each (row b, head h), t = 0..S-1,
//
//   y_t,j = sum_i r_t,i (S_ij + u_i k_t,i v_t,j)
//   S_ij <- w_t,i S_ij + k_t,i v_t,j
//
// r, k, v (B, S, H, hd) and u (H, hd) in float32 or bfloat16 (upcast on
// load), w (B, S, H, hd) float32, s0 (B, H, hd, hd) float32.  Writes y
// (B, S, H, hd) float32 and the final state once.
//
// Replaces: src/repro/kernels/wkv.py::wkv_kernel.  The TPU kernel blocks S
// into grid steps that carry the state in VMEM; its body is the exact
// per-timestep recurrence, so the blocking is tiling only.  In the port
// this kernel runs every sequence-mode WKV (prefill and admission chunks
// of an RWKV6 model, any S), where a plain time loop would issue thousands
// of launches.
//
// Design: grid (H, B), one block of hd threads per (b, h); thread j keeps
// value column j of the state in hd registers for the whole sequence
// (head sizes 16, 32, 64, 128; at 128 nvcc -Xptxas -v reports 255
// registers and 28 bytes of spill stores and loads a thread, no spills
// below that).
// Tiles of WKV_TS timesteps of r, k, v, w are staged in shared memory
// (each thread loads its own element j of every timestep: coalesced), and
// every thread then walks the tile's timesteps and the key axis in order.
// The products and sums are the plain version's, rounded one operation at
// a time (__fmul_rn / __fadd_rn), so the state follows ref.wkv_ref bit for
// bit and y differs only in the order of its sum over i.
//
// Bound: bytes.  It reads r, k, v, w once and writes y once (4 * S * hd
// elements per (b, h) in, S * hd floats out) and the state once each way.
// At B=1, S=32, H=40 (an rwkv6-3b admission chunk in bf16) that is about
// 1.7 MB, 0.5 us.  The walk is serial in t: each timestep costs a chain of
// hd dependent adds per thread, and only B * H blocks of hd threads run
// (40 of 132 SMs at B=1).  Splitting S into chunks with a state pass
// between them (the chunked WKV form) is the first speed work.
#include "recurrent.cuh"

#define WKV_TS 16

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const T *__restrict__ r, const T *__restrict__ k,
           const T *__restrict__ v, const float *__restrict__ w,
           const T *__restrict__ u, const float *__restrict__ s0,
           float *__restrict__ y, float *__restrict__ sout, int S, int H) {
  __shared__ float rs[WKV_TS][HD], ks[WKV_TS][HD], vs[WKV_TS][HD],
      ws[WKV_TS][HD], us[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  us[j] = rec_ld(u + (size_t)h * HD + j);
  const size_t sbase = ((size_t)b * H + h) * HD * HD;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    s[i] = s0[sbase + (size_t)i * HD + j];
  const size_t row = (size_t)H * HD;  // stride of one timestep
  const size_t base = (size_t)b * S * row + (size_t)h * HD + j;
  for (int t0 = 0; t0 < S; t0 += WKV_TS) {
    const int n = min(WKV_TS, S - t0);
    __syncthreads();  // the previous tile has been consumed
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = base + (size_t)(t0 + tt) * row;
      rs[tt][j] = rec_ld(r + off);
      ks[tt][j] = rec_ld(k + off);
      vs[tt][j] = rec_ld(v + off);
      ws[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = __fmul_rn(ks[tt][i], vj);
        const float x = __fadd_rn(s[i], __fmul_rn(us[i], kv));
        acc = __fadd_rn(acc, __fmul_rn(rs[tt][i], x));
        s[i] = __fadd_rn(__fmul_rn(ws[tt][i], s[i]), kv);
      }
      y[base + (size_t)(t0 + tt) * row] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i)
    sout[sbase + (size_t)i * HD + j] = s[i];
}

template <typename T>
static int launch(const void *r, const void *k, const void *v,
                  const void *w, const void *u, const void *s0, void *y,
                  void *sout, int B, int S, int H, int hd, cudaStream_t st) {
  const dim3 grid(H, B);
#define WKV_CASE(HDV)                                                        \
  case HDV:                                                                  \
    wkv_kernel<T, HDV><<<grid, HDV, 0, st>>>(                                \
        (const T *)r, (const T *)k, (const T *)v, (const float *)w,          \
        (const T *)u, (const float *)s0, (float *)y, (float *)sout, S, H);   \
    break;
  switch (hd) {
    WKV_CASE(16)
    WKV_CASE(32)
    WKV_CASE(64)
    WKV_CASE(128)
  default:
    return (int)cudaErrorInvalidValue;
  }
#undef WKV_CASE
  return (int)cudaGetLastError();
}

extern "C" int wkv_launch(const void *r, const void *k, const void *v,
                          const void *w, const void *u, const void *s0,
                          void *y, void *sout, int B, int S, int H, int hd,
                          int bf16, void *stream) {
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, S, H, hd,
                                 (cudaStream_t)stream);
  return launch<float>(r, k, v, w, u, s0, y, sout, B, S, H, hd,
                       (cudaStream_t)stream);
}
