// Unkeyed verification of Alg. 1, one block per row:
//   a_s = min(1, p_s(d_s) / q_s(d_s)), prefix = cumprod(u < a), n_acc,
//   then the residual token argmax_w log(U_w)/(p_w − q_w)_+ at slot
//   min(n_acc, K − 1) with that slot's host seed, and its U.  As in the
//   reference kernel, a row that accepts all K drafts still races slot
//   K − 1 (there is no bonus row here).
//
// Replaces: src/repro/kernels/spec_verify.py::spec_verify_kernel.
//
// Bound: bytes.  The accept test reads 2·K floats; the race reads one
// slot's p and q rows, 8·V bytes per row (the wrapper's inputs are the
// whole (B, K, V) p and q, 8·B·K·V bytes, 4 MB at B=4, K=4, V=32000:
// 1.2 us at 3.35 TB/s, but only one slot of each row is needed).  Design:
// spec_verify_wm.cu's race branch without the bonus row, the key chain
// or the seen switch: thread 0 gathers the 2·K probabilities directly
// (no one-hot pass over K·V), then the block streams one slot's rows
// through block_argmax.  Only B of the 132 SMs are busy.
#include <cuda_runtime.h>

#include "prf.cuh"

__global__ void __launch_bounds__(REPRO_THREADS)
spec_verify_kernel(const float *__restrict__ p, const float *__restrict__ q,
                   const long long *__restrict__ tokens,
                   const float *__restrict__ u,
                   const long long *__restrict__ seeds, int K, int V,
                   long long *__restrict__ n_acc,
                   long long *__restrict__ prefix,
                   long long *__restrict__ rtok, float *__restrict__ ru) {
  __shared__ int s_nacc;
  const size_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    int ok = 1, n = 0;
    for (int s = 0; s < K; ++s) {
      const size_t row = b * K + s;
      const long long d = tokens[row];
      const float pt = p[row * V + d];
      const float qt = q[row * V + d];
      const float acc = fminf(1.0f, pt / fmaxf(qt, REPRO_EPS));
      ok = ok && (u[row] < acc);
      prefix[row] = ok;
      n += ok;
    }
    n_acc[b] = n;
    s_nacc = n;
  }
  __syncthreads();
  const size_t row = b * K + (s_nacc < K - 1 ? s_nacc : K - 1);
  const uint32_t seed = (uint32_t)seeds[row];
  const float *ps = p + row * V;
  const float *qs = q + row * V;
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int w = threadIdx.x; w < V; w += blockDim.x) {
    const float r = fmaxf(ps[w] - qs[w], 0.f);
    arg_better(race_score(r, seed, (uint32_t)w), w, best, bi);
  }
  block_argmax(best, bi);
  if (threadIdx.x == 0) {
    rtok[b] = bi;
    ru[b] = prf_uniform(seed, (uint32_t)bi);
  }
}

extern "C" int spec_verify_launch(const void *p, const void *q,
                                  const void *tokens, const void *u,
                                  const void *seeds, int B, int K, int V,
                                  void *n_acc, void *prefix, void *rtok,
                                  void *ru, void *stream) {
  spec_verify_kernel<<<B, REPRO_THREADS, 0, (cudaStream_t)stream>>>(
      (const float *)p, (const float *)q, (const long long *)tokens,
      (const float *)u, (const long long *)seeds, K, V, (long long *)n_acc,
      (long long *)prefix, (long long *)rtok, (float *)ru);
  return (int)cudaGetLastError();
}
