// Keyed SynthID tournament: m rounds p <- p·((1+g) − Σ p·g) over each
// (B, V) row, with the g-seed chained in-kernel from the row's key word,
// the stream and the row's context hash.  The row is NOT normalised here
// (callers normalise first, as the reference's draft sampler does).  Also
// writes the argmax of the final row (ties to the smaller index), the
// token of the degenerate m->inf scheme, when `arg` is not null.
//
// Replaces: src/repro/kernels/tournament.py::tournament_keyed_kernel.
//
// Bound: one read and one write of the row, 8·B·V bytes (1 MB at B=4,
// V=32000: 0.3 us at 3.35 TB/s), and m·V g-bit hashes per row; each round
// needs the full-row mass first, so the m rounds are serial.  Design: one
// block per row keeps the row in dynamic shared memory (128 KB at
// V=32000) across all m rounds when it fits; past that (Gemma's V=256128,
// 1 MB) the output row itself is the working buffer and stays in L2.  Only
// B of 132 SMs work; a split-row design with a cluster-wide mass is the
// next step.
#include <cuda_runtime.h>

#include "prf.cuh"

__global__ void __launch_bounds__(REPRO_THREADS)
tournament_keyed_kernel(const float *__restrict__ probs,
                        const long long *__restrict__ keys,
                        const long long *__restrict__ ctx, int V, int m,
                        uint32_t stream, int use_smem,
                        float *__restrict__ out, long long *__restrict__ arg) {
  extern __shared__ float smem_row[];
  const int b = blockIdx.x;
  const uint32_t seed =
      seed_chain(seed_chain((uint32_t)keys[b], stream), (uint32_t)ctx[b]);
  const float *src = probs + (size_t)b * V;
  float *dst = out + (size_t)b * V;
  float *row = use_smem ? smem_row : dst;
  for (int w = threadIdx.x; w < V; w += blockDim.x) row[w] = src[w];
  block_tournament(row, V, m, seed);
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int w = threadIdx.x; w < V; w += blockDim.x) {
    if (use_smem) dst[w] = row[w];
    arg_better(row[w], w, best, bi);
  }
  if (arg != nullptr) {
    block_argmax(best, bi);
    if (threadIdx.x == 0) arg[b] = bi;
  }
}

// smem_bytes == 0 selects the in-place global-memory row.
extern "C" int tournament_keyed_launch(const void *probs, const void *keys,
                                       const void *ctx, int B, int V, int m,
                                       unsigned int stream_id, int smem_bytes,
                                       void *out, void *arg, void *stream) {
  cudaError_t e = allow_smem(tournament_keyed_kernel, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  tournament_keyed_kernel<<<B, REPRO_THREADS, smem_bytes,
                            (cudaStream_t)stream>>>(
      (const float *)probs, (const long long *)keys, (const long long *)ctx,
      V, m, (uint32_t)stream_id, smem_bytes > 0, (float *)out,
      (long long *)arg);
  return (int)cudaGetLastError();
}
