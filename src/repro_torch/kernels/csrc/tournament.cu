// Unkeyed SynthID tournament: m rounds p <- p·((1+g) − Σ p·g) over each
// (B, V) row, g = gbit(seed_b, w + V·l) with the row's host seed.  The
// row is NOT normalised here (callers normalise first).  It is the Monte
// Carlo engine of the paper's measures: one row per pseudorandom context,
// so B is the number of seeds (16384 for Def. 3.1 strength at V=32000,
// 20000 per chunk of the Fig. 1 curves at V=10).
//
// Replaces: src/repro/kernels/tournament.py::tournament_kernel.
//
// Bound: m·V g-bit hashes per row (operations); its bytes are one read
// and one write of the row, 8·B·V.  Each round needs the full-row mass
// first, so the m rounds of a row are serial.  Design: block_tournament
// (prf.cuh) with the seed read from a (B,) int64 row instead of chained
// from key/stream/context, one block per row; the row lives in dynamic
// shared memory when 4·V bytes fit (V=32000: 128 KB), else the output row
// itself is the working buffer (it stays in L2), as tournament_keyed.cu
// does.  The block is as wide as the row rounded up to a warp, at most
// 1024 threads, so a 10-entry row takes one warp, not 32; many rows fill
// all 132 SMs.
#include <cuda_runtime.h>

#include "prf.cuh"

__global__ void __launch_bounds__(REPRO_THREADS)
tournament_kernel(const float *__restrict__ probs,
                  const long long *__restrict__ seeds, int V, int m,
                  int use_smem, float *__restrict__ out) {
  extern __shared__ float smem_row[];
  const size_t b = blockIdx.x;
  const uint32_t seed = (uint32_t)seeds[b];
  const float *src = probs + b * (size_t)V;
  float *dst = out + b * (size_t)V;
  float *row = use_smem ? smem_row : dst;
  for (int w = threadIdx.x; w < V; w += blockDim.x) row[w] = src[w];
  block_tournament(row, V, m, seed);
  if (use_smem)
    for (int w = threadIdx.x; w < V; w += blockDim.x) dst[w] = row[w];
}

// smem_bytes == 0 selects the in-place global-memory row.
extern "C" int tournament_launch(const void *probs, const void *seeds, int B,
                                 int V, int m, int smem_bytes, void *out,
                                 void *stream) {
  cudaError_t e = allow_smem(tournament_kernel, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int threads =
      V >= REPRO_THREADS ? REPRO_THREADS : ((V + 31) / 32) * 32;
  tournament_kernel<<<B, threads > 0 ? threads : 32, smem_bytes,
                      (cudaStream_t)stream>>>(
      (const float *)probs, (const long long *)seeds, V, m, smem_bytes > 0,
      (float *)out);
  return (int)cudaGetLastError();
}
