// Unkeyed SynthID tournament: m rounds p <- p·((1+g) − Σ p·g) over each
// (B, V) row, g = gbit(seed_b, w + V·l) with the row's host seed.  The
// row is NOT normalised here (callers normalise first).  It is the Monte
// Carlo engine of the paper's measures: one row per pseudorandom context,
// so B is the number of seeds (16384 for Def. 3.1 strength at V=32000,
// 20000 per chunk of the Fig. 1 curves at V=10), and the rows are often
// one row repeated (`modified_dist` expands one distribution to (n, V)).
//
// Replaces: src/repro/kernels/tournament.py::tournament_kernel.
//
// Bound: operations, m·V g-bit hashes a row (about 18 integer operations
// each); its bytes are one read and one write of the rows, 8·B·V, or 4·V
// + 4·B·V when the input is one row read at row stride 0.  Each round
// needs the whole row's mass first, so the m rounds of a row are serial.
// The first port ran one block per row: B=4 rows kept 4 of 132 SMs busy,
// every g-bit was hashed twice a round, and a V=32000 row's 128 KB of
// shared memory left one 1024-thread block an SM (half its warps) with
// two block barriers a round; a V=10 row took a block of one warp.
//
// Design.  The launch shape comes from V alone (ops.tournament_shape), so
// a row's sums, and so its floats, are the same at any B:
//   segments, V <= TU_SEG_MAX_V = 1024: one row to a segment of a warp, its
//     lanes (a power of two up to 32) holding up to 32 entries each in
//     registers; a round's mass is a butterfly inside the segment, so a
//     Fig. 1 chunk of 20,000 rows fills the card in one wave;
//   a cluster of C = 8 blocks, V > 1024: block `rank` owns the
//     ct_slice slice [lo, hi) of the row, thread t the entries lo + t +
//     k·NT in registers (PER of them, 4 or 8);
//     each g-bit is hashed once, the next round's while the block's
//     partial mass travels to every member (st.async onto each member's
//     mbarrier, double-buffered by round parity, as cluster_tournament
//     does); each member adds the C partials in member order, so every
//     member holds the same mass bit for bit.  A cluster holds R rows at
//     once (1 or 4, from B: ops.tournament_rows): they share the
//     counters' hashes and each round's exchange, and no row's sums depend
//     on R.  No shared-memory row, so two clusters share an SM and hide
//     each other's exchange;
//   slices past the registers (V=256128): the slice in dynamic shared
//     memory, or past TU_SMEM_MAX in the output row, through
//     cluster_tournament, as tournament_keyed.cu does.
// A g-bit's counter hash is shared by all rows (tu_ctr), and a thread's
// bits of a round are kept as a mask per row (tu_bit), so the update
// needs no second hash.  The input row is read at `row_stride` floats a
// row: 0 reads one row for every b (from L2) where the caller expanded
// one distribution.
#include <cuda_runtime.h>

#include "cluster_tournament.cuh"

#define TU_SEG_THREADS 256          // segment kernel: threads a block
#define TU_SEG_MAX_V 1024           // rows up to this many entries: segments
#define TU_CLUSTER 8                // blocks a wider row's cluster
#define TU_MAX_PER 8                // register path: entries a thread
#define TU_MAX_ROWS 4               // rows a cluster holds at once
#define TU_SMEM_MAX (200 * 1024)    // a slice in shared memory up to this

// gbit(seed, ctr), the top bit of seed_chain(seed, ctr) =
// hash_u32((seed·φ) ^ hash_u32(ctr)), split so that a counter is hashed
// once for all the rows that share it.  With s = seed·φ, h = hash_u32(ctr)
// and y = h before hash_u32's last xorshift (so h ^ (h >> 16) = y), the
// first xorshift of s ^ h is (s ^ (s >> 16)) ^ y; the last xorshift of
// the outer hash leaves its top bit alone.
__device__ __forceinline__ uint32_t tu_ctr(uint32_t x) {  // y of a counter
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return x * 0x846CA68Bu;
}
__device__ __forceinline__ uint32_t tu_seed(uint32_t seed) {  // s ^ (s >> 16)
  const uint32_t s = seed * 0x9E3779B9u;
  return s ^ (s >> 16);
}
// a word whose top bit is gbit(seed, ctr), from tu_seed(seed), tu_ctr(ctr)
__device__ __forceinline__ uint32_t tu_word(uint32_t sx, uint32_t y) {
  uint32_t x = (sx ^ y) * 0x7FEB352Du;
  x ^= x >> 15;
  return x * 0x846CA68Bu;
}
// A thread's g-bits of a round are a mask per row: entry k's bit is
// shifted in at bit 0 (funnel shift), so after PER entries it sits at
// bit PER − 1 − k.
template <int PER>
__device__ __forceinline__ bool tu_bit(uint32_t mask, int k) {
  return (mask >> (PER - 1 - k)) & 1u;
}

// One row to a segment of `width` lanes (a power of two up to 32): lane j
// holds the entries j + k·width, k < PER.
template <int PER>
__global__ void __launch_bounds__(TU_SEG_THREADS)
tournament_seg_kernel(const float *__restrict__ probs, long long row_stride,
                      const long long *__restrict__ seeds, int B, int V,
                      int m, int seg_log2, float *__restrict__ out) {
  const int width = 1 << seg_log2;
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = gt >> seg_log2;
  const int lane = (int)(gt & (width - 1));
  const uint32_t sx = tu_seed(b < B ? (uint32_t)seeds[b] : 0u);
  const float *src = probs + (b < B ? b : 0) * row_stride;
  float p[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int w = lane + k * width;
    p[k] = b < B && w < V ? src[w] : 0.f;
  }
  for (int l = 0; l < m; ++l) {
    const uint32_t off = (uint32_t)V * (uint32_t)l;
    float mass = 0.f;
    uint32_t g = 0u;
    // entries past the row (and rows past B) hold p = 0: their bits are
    // hashed but move no sum
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const uint32_t word =
          tu_word(sx, tu_ctr((uint32_t)(lane + k * width) + off));
      g = __funnelshift_l(word, g, 1);
      if (word >> 31) mass += p[k];
    }
    // the segment's butterfly: xor offsets below its width stay inside it
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < width) mass += __shfl_xor_sync(0xffffffffu, mass, o);
    // (1 + g) − mass for g = 0 and 1: 1 + g is exact either way
    const float f0 = 1.0f - mass, f1 = 2.0f - mass;
#pragma unroll
    for (int k = 0; k < PER; ++k) p[k] = p[k] * (tu_bit<PER>(g, k) ? f1 : f0);
  }
  if (b >= B) return;
  float *dst = out + b * (long long)V;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int w = lane + k * width;
    if (w < V) dst[w] = p[k];
  }
}

struct __align__(16) TuShared {
  unsigned long long mbar[2];                   // one per round parity
  float part[2][TU_CLUSTER][TU_MAX_ROWS];       // partial masses
  float warp[TU_MAX_ROWS][32];                  // the block's warp sums
};

// R rows over a cluster of C = TU_CLUSTER blocks, the block's slices in
// registers: thread t holds the entries lo + t + k·NT, k < PER, of each
// of the R rows.
template <int PER, int R>
__global__ void __launch_bounds__(PER * R > 8 ? 512 : REPRO_THREADS,
                                  PER * R > 8 ? 2 : 1)
tournament_cluster_kernel(const float *__restrict__ probs,
                          long long row_stride,
                          const long long *__restrict__ seeds, int B, int V,
                          int m, float *__restrict__ out) {
  constexpr int C = TU_CLUSTER;
  __shared__ TuShared sh;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT >> 5;
  const long long b0 = (long long)(blockIdx.x / C) * R;
  int lo, hi;
  ct_slice(V, C, (int)rank, lo, hi);
  float p[R][PER];
  uint32_t sx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long b = b0 + r;
    sx[r] = tu_seed(b < B ? (uint32_t)seeds[b] : 0u);
    const float *src = probs + (b < B ? b : 0) * row_stride;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lo + tid + k * NT;
      p[r][k] = b < B && w < hi ? src[w] : 0.f;
    }
  }
  if (tid == 0) {
    ct_mbar_init(ct_smem(&sh.mbar[0]), 1);
    ct_mbar_init(ct_smem(&sh.mbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every member has started and set up its mbarriers
  uint32_t g[R];   // this round's g-bits (tu_bit)
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    g[r] = 0u;
    part[r] = 0.f;
  }
  // entries past the slice (and rows past B) hold p = 0: their bits are
  // hashed but move no sum
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const uint32_t y = tu_ctr((uint32_t)(lo + tid + k * NT));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t word = tu_word(sx[r], y);
      g[r] = __funnelshift_l(word, g[r], 1);
      if (word >> 31) part[r] += p[r][k];
    }
  }
  for (int l = 0; l < m; ++l) {
    // the block's partial masses (warp butterflies, then warp 0's over
    // the warps) go to every member
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (int o = 16; o > 0; o >>= 1)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
      if (lane == 0) sh.warp[r][warp] = part[r];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = lane < nw ? sh.warp[r][lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane < C)
          ct_st_async(ct_mapa(ct_smem(&sh.part[l & 1][rank][r]), lane), v,
                      ct_mapa(ct_smem(&sh.mbar[l & 1]), lane));
      }
    }
    if (tid == 0) ct_mbar_expect(ct_smem(&sh.mbar[l & 1]), 4 * C * R);
    // the next round's g-bits, hashed while the partials travel
    const uint32_t off_n = (uint32_t)V * (uint32_t)(l + 1);
    uint32_t gn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gn[r] = 0u;
    if (l + 1 < m) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const uint32_t y = tu_ctr((uint32_t)(lo + tid + k * NT) + off_n);
#pragma unroll
        for (int r = 0; r < R; ++r)
          gn[r] = __funnelshift_l(tu_word(sx[r], y), gn[r], 1);
      }
    }
    while (!ct_mbar_try(ct_smem(&sh.mbar[l & 1]), (l >> 1) & 1)) {
    }
    // the members' partials in member order, four rows to a vector
    float mass[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mass[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 v = *reinterpret_cast<const float4 *>(sh.part[l & 1][c]);
      const float pc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < R; ++r) mass[r] += pc[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // (1 + g) − mass for g = 0 and 1: 1 + g is exact either way
      const float f0 = 1.0f - mass[r], f1 = 2.0f - mass[r];
      part[r] = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        p[r][k] = p[r][k] * (tu_bit<PER>(g[r], k) ? f1 : f0);
        if (tu_bit<PER>(gn[r], k)) part[r] += p[r][k];
      }
      g[r] = gn[r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long b = b0 + r;
    if (b >= B) break;
    float *dst = out + b * (long long)V;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int w = lo + tid + k * NT;
      if (w < hi) dst[w] = p[r][k];
    }
  }
}

// One row over a cluster, the block's slice in shared memory (use_smem)
// or in the output row.
__global__ void __launch_bounds__(REPRO_THREADS)
tournament_slice_kernel(const float *__restrict__ probs, long long row_stride,
                        const long long *__restrict__ seeds, int V, int m,
                        int use_smem, float *__restrict__ out) {
  extern __shared__ float smem_row[];
  __shared__ ClusterTournamentShared sh;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / C;
  int lo, hi;
  ct_slice(V, C, rank, lo, hi);
  const float *src = probs + b * row_stride;
  float *dst = out + b * (long long)V;
  float *row = use_smem ? smem_row : dst + lo;
  for (int w = lo + threadIdx.x; w < hi; w += blockDim.x) row[w - lo] = src[w];
  cluster_tournament(row, lo, hi, V, m, (uint32_t)seeds[b], sh);
  if (use_smem)
    for (int w = lo + threadIdx.x; w < hi; w += blockDim.x)
      dst[w] = row[w - lo];
}

__host__ inline int tu_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int PER>
inline int tu_seg_launch(const float *probs, long long row_stride,
                         const long long *seeds, int B, int V, int m,
                         int seg_log2, float *out, cudaStream_t st) {
  const int rows = TU_SEG_THREADS >> seg_log2;  // rows a block
  tournament_seg_kernel<PER><<<(B + rows - 1) / rows, TU_SEG_THREADS, 0,
                               st>>>(probs, row_stride, seeds, B, V, m,
                                     seg_log2, out);
  return (int)cudaGetLastError();
}

template <int PER, int R>
inline int tu_cluster_launch(const float *probs, long long row_stride,
                             const long long *seeds, int B, int V, int m,
                             int NT, float *out, cudaStream_t st) {
  if (PER * R > 8 && NT > 512) return (int)cudaErrorInvalidValue;
  return ct_launch(tournament_cluster_kernel<PER, R>, (B + R - 1) / R,
                   TU_CLUSTER, NT, 0, st, probs, row_stride, seeds, B, V, m,
                   out);
}

template <int PER>
inline int tu_cluster_rows(int R, const float *probs, long long rs,
                           const long long *seeds, int B, int V, int m,
                           int NT, float *out, cudaStream_t st) {
  return R == 4 ? tu_cluster_launch<PER, 4>(probs, rs, seeds, B, V, m, NT, out, st)
                : tu_cluster_launch<PER, 1>(probs, rs, seeds, B, V, m, NT, out, st);
}

// V <= TU_SEG_MAX_V: rows of up to 32 entries a lane in segments of
// `threads` lanes (a power of two up to 32); else one row over a cluster
// of TU_CLUSTER blocks of `threads` threads (a multiple of 32 up to 1024):
// the slice in registers where it is at most TU_MAX_PER entries a thread,
// else in shared memory, or in the output row past TU_SMEM_MAX.
// rows (1 or 4): rows a cluster holds at once, sharing the counters'
// hashes and each round's exchange; no row's sums depend on it, so it is
// lowered to 1 where a thread's entries of its rows would pass 8 in
// 1024-thread blocks, and taken as 1 by segments and the shared-memory
// path.
// row_stride: floats between input rows (0: one row for every b).
extern "C" int tournament_launch(const void *probs_, const void *seeds_,
                                 int B, int V, int row_stride, int m,
                                 int threads, int rows, void *out_,
                                 void *stream) {
  const float *probs = (const float *)probs_;
  const long long *seeds = (const long long *)seeds_;
  float *out = (float *)out_;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rs = row_stride;
  if (B <= 0) return 0;
  if (rows != 1 && rows != 4) return (int)cudaErrorInvalidValue;
  if (V <= TU_SEG_MAX_V) {
    int seg_log2 = 0;  // threads: the segment's width, a power of two
    while ((1 << seg_log2) < threads && seg_log2 < 5) ++seg_log2;
    if (threads != 1 << seg_log2) return (int)cudaErrorInvalidValue;
    const int per = tu_pow2((V + threads - 1) >> seg_log2);
    switch (per) {
      case 1: return tu_seg_launch<1>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      case 2: return tu_seg_launch<2>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      case 4: return tu_seg_launch<4>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      case 8: return tu_seg_launch<8>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      case 16: return tu_seg_launch<16>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      case 32: return tu_seg_launch<32>(probs, rs, seeds, B, V, m, seg_log2, out, st);
      default: return (int)cudaErrorInvalidValue;  // past 32 entries a lane
    }
  }
  if (threads < 32 || threads > REPRO_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int slice = (V + TU_CLUSTER - 1) / TU_CLUSTER;
  const int per = (slice + threads - 1) / threads;
  if (per <= TU_MAX_PER) {
    // PER 4 or 8: entries past the slice hold p = 0 and move no sum, so
    // a slice of up to 2 entries a thread (which ops.tournament_shape
    // never sends) gives the same floats at PER 4
    const int PER = per <= 4 ? 4 : 8;
    // at most 8 entries a thread in 1024-thread blocks
    const int R = PER * rows > 8 && threads > 512 ? 1 : rows;
    return PER == 4
               ? tu_cluster_rows<4>(R, probs, rs, seeds, B, V, m, threads, out, st)
               : tu_cluster_rows<8>(R, probs, rs, seeds, B, V, m, threads, out, st);
  }
  const int smem = 4 * slice <= TU_SMEM_MAX ? 4 * slice : 0;
  return ct_launch(tournament_slice_kernel, B, TU_CLUSTER, threads, smem, st,
                   probs, rs, seeds, V, m, smem > 0 ? 1 : 0, out);
}
