// Keyed SynthID tournament: m rounds p <- p·((1+g) − Σ p·g) over each
// (B, V) row, with the g-seed chained in-kernel from the row's key word,
// the stream and the row's context hash.  The row is NOT normalised here
// (callers normalise first, as the reference's draft sampler does).  Also
// writes the argmax of the final row (ties to the smaller index), the
// token of the degenerate m->inf scheme, when `arg` is not null.
//
// Replaces: src/repro/kernels/tournament.py::tournament_keyed_kernel.
//
// Bound: operations.  Its bytes are one read and one write of the row,
// 8·B·V (1 MB at B=4, V=32000: 0.3 us at 3.35 TB/s); its work is m·V
// g-bit hashes a row (about 18 integer operations each, 0.96 M hashes a
// row at V=32000, m=30), and each round needs the whole row's mass before
// it can update, so the m rounds of a row are serial.  The first port ran
// one 1024-thread block per row: B=4 rows kept 4 of 132 SMs busy, hashed
// every g-bit twice a round and paid two block barriers a round (0.27 ms,
// one SM's integer rate).
//
// Design: one cluster of TK_CLUSTER = 8 blocks per row (16, with the
// non-portable opt-in, was faster at B=4 but not all of B=8's clusters fit
// the card at once), each block a contiguous slice of V held in dynamic
// shared memory (128 KB at V=256128) or, past TK_SMEM_MAX, in the output
// row itself; cluster_tournament
// (cluster_tournament.cuh) hashes each g-bit once and sends the C partial
// masses of a round through distributed shared memory (st.async onto each
// member's mbarrier, no cluster-wide barrier a round); the final argmax is
// taken across the cluster.  The block is the slice rounded up to a warp,
// at most 1024 threads.  A row's arithmetic depends on V and the cluster
// size only, not on B.  What bounds it now: at V=32000 each of the 30
// rounds is a chain of a block reduction and a one-way exchange between
// SMs (about 2 us); at V=256128 the hashing, 32016 g-bits a block a
// round.
#include <cuda_runtime.h>

#include "cluster_tournament.cuh"

#define TK_CLUSTER 8                 // blocks a row; fixes the sum order
#define TK_SMEM_MAX (200 * 1024)     // a slice in shared memory up to this

__global__ void __launch_bounds__(REPRO_THREADS)
tournament_keyed_kernel(const float *__restrict__ probs,
                        const long long *__restrict__ keys,
                        const long long *__restrict__ ctx, int V, int m,
                        uint32_t stream, int use_smem,
                        float *__restrict__ out, long long *__restrict__ arg) {
  extern __shared__ float smem_row[];
  __shared__ ClusterTournamentShared sh;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const uint32_t seed =
      seed_chain(seed_chain((uint32_t)keys[b], stream), (uint32_t)ctx[b]);
  int lo, hi;
  ct_slice(V, C, rank, lo, hi);
  const float *src = probs + (size_t)b * V;
  float *dst = out + (size_t)b * V;
  float *row = use_smem ? smem_row : dst + lo;
  for (int w = lo + threadIdx.x; w < hi; w += blockDim.x) row[w - lo] = src[w];
  cluster_tournament(row, lo, hi, V, m, seed, sh);
  if (use_smem)
    for (int w = lo + threadIdx.x; w < hi; w += blockDim.x)
      dst[w] = row[w - lo];
  if (arg != nullptr) {
    const int bi = cluster_argmax(row, lo, hi, sh);
    if (rank == 0 && threadIdx.x == 0) arg[b] = bi;
  }
}

// One cluster of TK_CLUSTER blocks per row, each with its slice of the
// row in shared memory when the slice fits TK_SMEM_MAX, else in `out`.
extern "C" int tournament_keyed_launch(const void *probs, const void *keys,
                                       const void *ctx, int B, int V, int m,
                                       unsigned int stream_id, void *out,
                                       void *arg, void *stream) {
  const int slice = (V + TK_CLUSTER - 1) / TK_CLUSTER;
  const int smem_bytes = 4 * slice <= TK_SMEM_MAX ? 4 * slice : 0;
  const int threads =
      slice >= REPRO_THREADS ? REPRO_THREADS : ((slice + 31) / 32) * 32;
  return ct_launch(tournament_keyed_kernel, B, TK_CLUSTER,
                   threads > 0 ? threads : 32, smem_bytes,
                   (cudaStream_t)stream, (const float *)probs,
                   (const long long *)keys, (const long long *)ctx, V, m,
                   (uint32_t)stream_id, smem_bytes > 0 ? 1 : 0, (float *)out,
                   (long long *)arg);
}
