// Seeded Gumbel-max race per row: tok_b = argmax_w log(U_w)/P_w with
// U_w = prf_uniform(seed_b, w); also returns U at the winner.
//
// Replaces: src/repro/kernels/gumbel_argmax.py::gumbel_argmax_kernel.
// In the port it samples every draft token, the first token and the
// unfused tail's tokens (the reference computes the same race in jnp).
//
// Bound: it reads the (B, V) probs once, 4·B·V bytes (512 KB at B=4,
// V=32000: 0.15 us at 3.35 TB/s), and does one hash, one logf and one
// division per entry, so at serving shapes it is bound by launch latency,
// not by bytes or operations.  Design: one block of 1024 threads per row,
// one strided coalesced pass, no intermediate ever written; the uniforms
// are recomputed in-register instead of being stored.  Only B of the 132
// SMs are busy: splitting a row over several blocks is the first thing a
// later change should do.
#include <cuda_runtime.h>

#include "prf.cuh"

__global__ void __launch_bounds__(REPRO_THREADS)
gumbel_argmax_kernel(const float *__restrict__ probs,
                     const long long *__restrict__ seeds, int V,
                     long long *__restrict__ tok, float *__restrict__ u) {
  const int b = blockIdx.x;
  const uint32_t seed = (uint32_t)seeds[b];
  const int t = block_race(probs + (size_t)b * V, V, seed);
  if (threadIdx.x == 0) {
    tok[b] = t;
    u[b] = prf_uniform(seed, (uint32_t)t);
  }
}

extern "C" int gumbel_argmax_launch(const void *probs, const void *seeds,
                                    int B, int V, void *tok, void *u,
                                    void *stream) {
  gumbel_argmax_kernel<<<B, REPRO_THREADS, 0, (cudaStream_t)stream>>>(
      (const float *)probs, (const long long *)seeds, V, (long long *)tok,
      (float *)u);
  return (int)cudaGetLastError();
}
