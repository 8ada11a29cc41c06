// Seeded Gumbel-max race per row: tok_b = argmax_w log(U_w)/P_w with
// U_w = prf_uniform(seed_b, w); also returns U at the winner.
//
// Replaces: src/repro/kernels/gumbel_argmax.py::gumbel_argmax_kernel.
// In the port it samples every draft token, the first token, SynthID's
// draw and the unfused tail's tokens, and it is the Monte-Carlo engine of
// gumbel's modified_dist (one row per context: Def. 3.1 strength at
// (16384, 32000), Fig. 1's chunks at (20000, 10)).
//
// Bound: it reads the (B, V) probs once, 4·B·V bytes (512 KB at B=4,
// V=32000: 0.15 us at 3.35 TB/s), and does one seed-chain hash, one logf
// and one IEEE division per entry.  The first port ran one block of 1024
// threads per row: at the serving shapes (B = 1-8) B of the 132 SMs raced
// 32000 entries each alone (15.6 us at B=4), and a Fig. 1 chunk ran
// 20,000 blocks of which 10 threads each worked.
//
// Design.  The merge of (score, index) pairs is exact (no float sums;
// ties go to the smaller index, arg_better), so any split of a row gives
// the same token and the same U bit for bit, and the launch shape is
// chosen from (B, V) alone by the wrapper (ops.race_split):
//   split 0   rows of up to 1024 entries in segments of a warp, the row's
//             width rounded up to a power of two, at most 32 lanes (two
//             10-entry rows a warp, 16 a block), a shuffle argmax inside
//             the segment: a Fig. 1 chunk fills the card in one wave;
//   split C>1 a row over a cluster of C blocks (the serving rows: 16 up
//             to 4 rows, a non-portable cluster, 8 up to 8): each
//             member races its race_bounds slice straight from global
//             memory (race_slice: 16-byte loads, one piece a thread), the
//             members' winners go to member 0 over distributed shared
//             memory (cluster_merge), which writes the token and U; the
//             cluster barrier's arrival is made at the start, so only its
//             wait is left after the race;
//   split 1   one row a block of GA_ROW_THREADS threads, several blocks a
//             SM (the Monte-Carlo rows, which fill the card themselves).
// What bounds it (scripts/kernel_trace.py): at the serving rows a
// cluster's start, the slice (1.2 us at V=32000) and the block argmax,
// barrier wait and merge (1.7 us); at the Monte-Carlo rows the ~70
// instructions an entry (the hash, logf, division) on every SM, twice the
// time of its bytes.
#include <cuda_runtime.h>

#include "cluster_tournament.cuh"

#define GA_SEG_THREADS 256   // segment kernel: threads a block
#define GA_ROW_THREADS 256   // one row a block: at most this many threads
#define GA_MAX_CLUSTER 16    // the largest (non-portable) cluster

__global__ void __launch_bounds__(GA_SEG_THREADS)
gumbel_argmax_rows_kernel(const float *__restrict__ probs,
                          const long long *__restrict__ seeds, int B, int V,
                          int seg_log2, long long *__restrict__ tok,
                          float *__restrict__ u) {
  const int width = 1 << seg_log2;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = g >> seg_log2;
  const int lane = (int)(g & (width - 1));
  float best = -INFINITY;
  int bi = INT_MAX;
  uint32_t seed = 0;
  if (b < B) {
    seed = (uint32_t)seeds[b];
    const float *row = probs + (size_t)b * V;
    for (int w = lane; w < V; w += width)
      arg_better(race_score(row[w], seed, (uint32_t)w), w, best, bi);
  }
  // the segment's butterfly: xor offsets below its width stay inside it
  for (int o = width >> 1; o > 0; o >>= 1)
    arg_better(__shfl_xor_sync(0xffffffffu, best, o),
               __shfl_xor_sync(0xffffffffu, bi, o), best, bi);
  if (b < B && lane == 0) {
    tok[b] = bi;
    u[b] = prf_uniform(seed, (uint32_t)bi);
  }
}

__global__ void __launch_bounds__(REPRO_THREADS)
gumbel_argmax_kernel(const float *__restrict__ probs,
                     const long long *__restrict__ seeds, int V, int C,
                     long long *__restrict__ tok, float *__restrict__ u) {
  __shared__ float s_best[GA_MAX_CLUSTER];
  __shared__ int s_idx[GA_MAX_CLUSTER];
  if (C > 1) ct_arrive();  // this member has started
  const int b = blockIdx.x / C, rank = blockIdx.x % C;
  const uint32_t seed = (uint32_t)seeds[b];
  int lo, hi;
  race_bounds(V, C, rank, lo, hi);
  float best;
  int bi;
  race_slice(probs + (size_t)b * V, nullptr, lo, hi, seed, best, bi);
  block_argmax(best, bi);
  if (C > 1) {
    ct_wait();  // every member has started: member 0 may be written
    bi = cluster_merge(best, bi, s_best, s_idx);
  }
  if (rank == 0 && threadIdx.x == 0) {
    tok[b] = bi;
    u[b] = prf_uniform(seed, (uint32_t)bi);
  }
}

// split: 0 for segments of a warp, else the blocks of a row (a cluster
// when above 1, at most GA_MAX_CLUSTER).
extern "C" int gumbel_argmax_launch(const void *probs, const void *seeds,
                                    int B, int V, int split, void *tok,
                                    void *u, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (split == 0) {
    int seg_log2 = 0;
    while ((1 << seg_log2) < V && seg_log2 < 5) ++seg_log2;
    const int rows = GA_SEG_THREADS >> seg_log2;  // rows a block
    gumbel_argmax_rows_kernel<<<(B + rows - 1) / rows, GA_SEG_THREADS, 0,
                                st>>>((const float *)probs,
                                      (const long long *)seeds, B, V,
                                      seg_log2, (long long *)tok, (float *)u);
    return (int)cudaGetLastError();
  }
  if (split < 0 || split > GA_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  return ct_launch(
      gumbel_argmax_kernel, B, split,
      race_threads(V, split, split > 1 ? REPRO_THREADS : GA_ROW_THREADS), 0,
      st, (const float *)probs, (const long long *)seeds, V, split,
      (long long *)tok, (float *)u);
}
