// One SynthID tournament row split over a thread-block cluster.
//
// m rounds p <- p·((1 + g) − Σ p·g), g = gbit(seed, w + V·l), over a row
// of V entries held by the C blocks of one cluster: block `rank` owns the
// contiguous slice [lo, hi) of ct_slice, thread t the entries lo + t,
// lo + t + blockDim.x, ...  Each round needs the whole row's mass first,
// so the rounds are serial; what a round costs is its share of the m·V
// g-bit hashes (split over C SMs instead of one) and one exchange of C
// partial masses.
//
// Each g-bit is hashed once: a round's bits of a thread's first CT_BITS
// entries stay in a register bit mask between the mass and the update
// (entries past that are hashed again in the update; none are at C=8 up
// to V=524288 with 1024 threads), and the next round's bits are hashed
// while the partial masses travel.  The block's partial mass (its
// threads' sums in entry order, the warps' butterflies, then warp 0's
// butterfly over the warps) goes to every member with st.async, which
// completes its bytes on the receiver's mbarrier; each member waits on
// its own mbarrier for the C partials (no cluster-wide barrier a round)
// and adds them in member order 0..C-1, so all members hold the same mass
// bit for bit.  Partials and mbarriers are double-buffered by round
// parity: a member sends round l + 2's partial only after it has all of
// round l + 1's, which every member sends after reading round l's.  The
// sums depend only on V, C and blockDim.x, never on the number of rows or
// the SM count.
//
// Used by tournament_keyed.cu, by spec_verify_wm.cu's tournament branch
// (with cluster_sum for the normalisation and cluster_race for the draw)
// and by tournament.cu for slices past its registers (tournament.cu keeps
// a slice in registers otherwise, with the same exchange).  The Gumbel
// races of gumbel_argmax.cu, spec_verify.cu and spec_verify_wm.cu's race
// branch split a row over a cluster too: race_slice races a slice
// straight from global memory and cluster_merge takes the members'
// winners to member 0; ct_launch launches any of these kernels.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prf.cuh"

#define CT_MAX_CLUSTER 8                // the portable cluster size
#define CT_BITS 64

struct ClusterTournamentShared {
  unsigned long long mbar[2];     // one mbarrier per round parity
  float part[2][CT_MAX_CLUSTER];  // partial masses, by round parity
  float warp[32];                 // the block's warp sums
  float best_s[CT_MAX_CLUSTER];   // each member's argmax, at member 0
  int best_i[CT_MAX_CLUSTER];
  float sum[CT_MAX_CLUSTER];      // each member's cluster_sum part
};

__device__ __forceinline__ void ct_slice(int V, int C, int rank, int &lo,
                                         int &hi) {
  const int L = (V + C - 1) / C;
  lo = min(V, rank * L);
  hi = min(V, lo + L);
}

__device__ __forceinline__ unsigned ct_smem(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned ct_mapa(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void ct_st_async(unsigned raddr, float v,
                                            unsigned rmbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(raddr), "f"(v), "r"(rmbar)
      : "memory");
}
__device__ __forceinline__ void ct_mbar_init(unsigned a, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void ct_mbar_expect(unsigned a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(a),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool ct_mbar_try(unsigned a, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred P;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      " selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(a), "r"(parity)
      : "memory");
  return ok != 0;
}

// this thread's g-bits of round l for its first CT_BITS entries
__device__ __forceinline__ uint64_t ct_bits(int lo, int hi, int V, int l,
                                            uint32_t seed) {
  const uint32_t off = (uint32_t)V * (uint32_t)l;
  uint64_t bits = 0;
  int k = 0;
  for (int w = lo + threadIdx.x; w < hi && k < CT_BITS;
       w += blockDim.x, ++k)
    bits |= (uint64_t)(seed_chain(seed, (uint32_t)w + off) >> 31) << k;
  return bits;
}

__device__ __forceinline__ float ct_g(uint64_t bits, int k, uint32_t seed,
                                      uint32_t ctr) {
  return k < CT_BITS ? (float)((bits >> k) & 1u) : prf_gbit(seed, ctr);
}

// m rounds in place over this block's slice row[0, hi − lo) (shared or
// global memory, this thread's entries only).  Every thread of every
// block of the cluster must call it; it starts with a cluster barrier
// (after the mbarriers are set up), so no member is written to before it
// runs.
__device__ __forceinline__ void cluster_tournament(
    float *row, int lo, int hi, int V, int m, uint32_t seed,
    ClusterTournamentShared &sh) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT >> 5;
  if (tid == 0) {
    ct_mbar_init(ct_smem(&sh.mbar[0]), 1);
    ct_mbar_init(ct_smem(&sh.mbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();
  uint64_t bits = m > 0 ? ct_bits(lo, hi, V, 0, seed) : 0;
  float part = 0.f;
  {
    int k = 0;
    for (int w = lo + tid; w < hi; w += NT, ++k)
      part += row[w - lo] * ct_g(bits, k, seed, (uint32_t)w);
  }
  for (int l = 0; l < m; ++l) {
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) sh.warp[warp] = part;
    __syncthreads();
    if (warp == 0) {
      float v = lane < nw ? sh.warp[lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < C)
        ct_st_async(ct_mapa(ct_smem(&sh.part[l & 1][rank]), lane), v,
                    ct_mapa(ct_smem(&sh.mbar[l & 1]), lane));
    }
    if (tid == 0) ct_mbar_expect(ct_smem(&sh.mbar[l & 1]), 4 * C);
    const uint64_t next = l + 1 < m ? ct_bits(lo, hi, V, l + 1, seed) : 0;
    while (!ct_mbar_try(ct_smem(&sh.mbar[l & 1]), (l >> 1) & 1)) {
    }
    float mass = 0.f;
    for (int c = 0; c < C; ++c) mass += sh.part[l & 1][c];
    const uint32_t off = (uint32_t)V * (uint32_t)l;
    const uint32_t off_n = off + (uint32_t)V;
    part = 0.f;
    int k = 0;
    for (int w = lo + tid; w < hi; w += NT, ++k) {
      const float g = ct_g(bits, k, seed, (uint32_t)w + off);
      const float p = row[w - lo] * ((1.0f + g) - mass);
      row[w - lo] = p;
      if (l + 1 < m) part += p * ct_g(next, k, seed, (uint32_t)w + off_n);
    }
    bits = next;
  }
}

// The sum over the cluster of each block's `part` (thread 0's value is
// sent to every member), added in member order 0..C-1, so every member
// returns the same float bit for bit.  Every thread of every block must
// call it; it starts with a cluster barrier (every member has started, so
// its shared memory may be written) and ends with one.
__device__ __forceinline__ float cluster_sum(float part,
                                             ClusterTournamentShared &sh) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  cluster.sync();
  if (threadIdx.x == 0) {
    const unsigned rank = cluster.block_rank();
    for (int c = 0; c < C; ++c)
      *cluster.map_shared_rank(&sh.sum[rank], (unsigned)c) = part;
  }
  cluster.sync();
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += sh.sum[c];
  return s;
}

// The two halves of a cluster barrier, for a barrier whose wait can come
// later than its arrival (every thread of every member calls both, in
// turn): after the wait every member has arrived, so has started.
__device__ __forceinline__ void ct_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ct_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster's best (score, index) from each block's winner (best, bi at
// thread 0, as block_argmax leaves them): thread 0 of every member writes
// them into member 0's s_best[rank] / s_idx[rank] (arrays of at least C
// entries), a cluster barrier, and member 0 returns the cluster's winner
// (ties to the smaller index, as arg_better; other members' value is
// unspecified).  Every thread of every block must call it, after a
// cluster barrier (or its wait) that follows every member's start.
__device__ __forceinline__ int cluster_merge(float best, int bi,
                                             float *s_best, int *s_idx) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  if (threadIdx.x == 0) {
    const unsigned rank = cluster.block_rank();
    *cluster.map_shared_rank(&s_best[rank], 0u) = best;
    *cluster.map_shared_rank(&s_idx[rank], 0u) = bi;
  }
  cluster.sync();
  best = -INFINITY;
  bi = INT_MAX;
  for (int c = 0; c < C; ++c) arg_better(s_best[c], s_idx[c], best, bi);
  return bi;
}

// The cluster's best (score, index) from each thread's own, at member 0
// (block_argmax, then cluster_merge).  Every thread of every block must
// call it, after a cluster barrier that follows the blocks' start.
__device__ __forceinline__ int cluster_pick(float best, int bi,
                                            ClusterTournamentShared &sh) {
  block_argmax(best, bi);
  return cluster_merge(best, bi, sh.best_s, sh.best_i);
}

// The argmax of the final row over the cluster (ties to the smaller
// index), at member 0.
__device__ __forceinline__ int cluster_argmax(const float *row, int lo,
                                              int hi,
                                              ClusterTournamentShared &sh) {
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int w = lo + threadIdx.x; w < hi; w += blockDim.x)
    arg_better(row[w - lo], w, best, bi);
  return cluster_pick(best, bi, sh);
}

// The Gumbel race log(U_w)/p_w over the cluster's row with `seed` (ties
// to the smaller index, as arg_better), the winner at member 0.
__device__ __forceinline__ int cluster_race(const float *row, int lo, int hi,
                                           uint32_t seed,
                                           ClusterTournamentShared &sh) {
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int w = lo + threadIdx.x; w < hi; w += blockDim.x)
    arg_better(race_score(row[w - lo], seed, (uint32_t)w), w, best, bi);
  return cluster_pick(best, bi, sh);
}

// The entries of a member's slice of a race over V entries split C ways:
// ceil(V / C) rounded up to a multiple of 4, so that a row on the 16-byte
// grid keeps every slice on it.  (A race's winner does not depend on the
// split; a tournament's sums do, and keep ct_slice.)
__host__ __device__ inline int race_len(int V, int C) {
  return ((V + C - 1) / C + 3) & ~3;
}

// Member `rank`'s slice [lo, hi) of a race over V entries split C ways.
__device__ __forceinline__ void race_bounds(int V, int C, int rank, int &lo,
                                            int &hi) {
  const int L = race_len(V, C);
  lo = min(V, rank * L);
  hi = min(V, lo + L);
}

// This thread's best (score, index) of the Gumbel race over the entries
// [lo, hi) of a row in global memory: r_w = p_w, or (p_w − q_w)_+ when q
// is not null, scored race_score(r_w, seed, w).  16-byte loads over the
// part of the slice on the 16-byte grid (where p and q sit at the same
// offset from it), single loads before and after it.  The (score, index)
// order is total, so neither the order of the visits nor the split of a
// row changes the winner.
__device__ __forceinline__ void race_slice(const float *__restrict__ p,
                                           const float *__restrict__ q,
                                           int lo, int hi, uint32_t seed,
                                           float &best, int &bi) {
  best = -INFINITY;
  bi = INT_MAX;
  const int tid = threadIdx.x, NT = blockDim.x;
  const unsigned off = (unsigned)((uintptr_t)(p + lo) & 15u);
  int a0 = hi, a1 = hi;  // [a0, a1): 16-byte pieces
  if (q == nullptr || (unsigned)((uintptr_t)(q + lo) & 15u) == off) {
    a0 = min(hi, lo + (int)(((16u - off) & 15u) >> 2));
    a1 = a0 + ((hi - a0) & ~3);
  }
  auto visit = [&](int w, float pw, float qw) {
    const float r = q != nullptr ? fmaxf(pw - qw, 0.f) : pw;
    arg_better(race_score(r, seed, (uint32_t)w), w, best, bi);
  };
  for (int w = lo + tid; w < a0; w += NT) visit(w, p[w], q ? q[w] : 0.f);
  for (int w = a0 + 4 * tid; w < a1; w += 4 * NT) {
    const float4 pv = *reinterpret_cast<const float4 *>(p + w);
    const float4 qv = q != nullptr
                          ? *reinterpret_cast<const float4 *>(q + w)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    visit(w, pv.x, qv.x);
    visit(w + 1, pv.y, qv.y);
    visit(w + 2, pv.z, qv.z);
    visit(w + 3, pv.w, qv.w);
  }
  for (int w = a1 + tid; w < hi; w += NT) visit(w, p[w], q ? q[w] : 0.f);
}

// Threads of a block that races a slice of V entries split C ways: one
// 16-byte piece each, rounded up to a warp, between 32 and `cap`.
inline int race_threads(int V, int C, int cap) {
  const int t = (race_len(V, C) / 4 + 31) / 32 * 32;
  return t < 32 ? 32 : t > cap ? cap : t;
}

// Launch `kernel` as n clusters of C blocks (blockIdx.x / C the cluster,
// blockIdx.x % C the member) of `threads` threads and `smem` bytes of
// dynamic shared memory; C = 1 is a plain launch, C past CT_MAX_CLUSTER
// (the portable size) is opted into first.  A refused launch's error is
// returned and cleared.
template <typename... Params, typename... Args>
inline int ct_launch(void (*kernel)(Params...), int n, int C, int threads,
                     int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess && C > CT_MAX_CLUSTER)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return (int)cudaGetLastError();
}
