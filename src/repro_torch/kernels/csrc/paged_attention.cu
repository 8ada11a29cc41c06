// Paged-decode attention: GQA attention of q (B, Sq, H, hd) over a
// block-paged KV pool (P, page_size, Hkv, hd) through per-slot page tables
// (B, max_pages) of physical page ids (page 0 = the null page).  Query i
// of slot b, head h attends the logical kv positions < pos[b] + i of kv
// head h / n_rep; masked lanes take the finfo(float32).min score, so they
// add exact zeros and a row never depends on pages past its limit.  The
// output is in the pool's type (float32 or bfloat16).
//
// Sliding window (window > 0, passed only below the extent max_pages ·
// page_size): as layers.decode_attention, every query of slot b reads one
// slice of `window` positions from lo_b = clamp(pos[b] + Sq − 1 − window,
// 0, extent − window), and query i attends the positions of it in
// [max(lo_b, pos[b] + i − window), pos[b] + i).  A tile reads only the
// slice's positions (chunks below lo_b are never visited), and a row with
// no valid position averages v over the slice, as the plain version's
// uniform masked softmax does.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_kernel
// (body _paged_attn_body).  The TPU kernel walks all max_pages pages of
// the table in grid order, stashes every score and v page in VMEM and
// runs one softmax at the last page; on Hopper no block holds that extent
// and the grid runs in parallel, so the kv axis is split over a cluster.
//
// Bound: bytes.  It must read the k/v positions each slot's rows attend
// once per (slot, kv head), plus q, and write out: at the target's verify
// shape (B=8, Sq=5, H=Hkv=32, hd=128, pos 17-1000, bf16) about 38 MB,
// 11.5 us at 3.35 TB/s.  q·k and p·v are at most Sq·n_rep rows against
// each position (5 at the target's verify shape, about 5 flops a byte
// read): far under the tensor cores' line, so they stay on the CUDA cores
// (mma.sync would only pay at the prefill chunk's 32 rows).  The first
// port ran one block per (row tile, kv head, slot) that walked the slot's
// pages one after another with one page in flight: the longest slot set
// the time, and the draft's Hkv=12, Sq=1 filled 96 of 132 SMs.
//
// Design: split-KV over a thread-block cluster.  Grid (PA_CLUSTER × row
// tiles, Hkv, B); each (row tile, kv head, slot) is one cluster of
// PA_CLUSTER blocks ("members") on neighbouring SMs.  A row is one of the
// Sq·n_rep query rows (r = i·n_rep + g), PA_ROWS per tile, one warp each
// while scoring.  Logical positions are cut into chunks of PA_CHUNK
// positions; chunk j belongs to member j mod PA_CLUSTER, and position p is
// read from row p % page_size of page table[b, p / page_size], so any page
// size works and nothing is instantiated per page size.  A tile visits
// positions below the largest limit of its rows (the whole extent, or the
// window's slice, if a row has no valid position, as the plain version
// averages v over it there).
// Each member streams its chunks' k (pass one) and v (pass two) tiles
// through a ring of pa_stages() shared-memory stages (4 up to hd 128, 3
// past it) filled with 16-byte cp.async copies, all but one stage in
// flight; the ring runs on across the cluster exchange, so the first v
// tiles load while the row's statistics travel.  The first tiles' pages
// are read from the table at once and copied before q and the later
// chunks' pages are staged in shared memory.  Pass one scores a chunk
// (lane = position, the dot over hd in float32 from q in shared memory),
// keeps the scores of its first PA_SCORE_CHUNKS chunks in shared memory
// (k is read once) and a running (max, sum of exp) of later ones.  Each
// member then forms its (max m_c, sum l_c of exp(s − m_c)) of every row
// and pushes it into every member's shared memory (distributed shared
// memory, one cluster barrier); every member takes M = max m_c and
// l = Σ_c l_c·exp(m_c − M) in member order 0..PA_CLUSTER-1, so all hold
// the same M and l bit for bit.  Pass two forms p = round(exp(s − M) / l)
// and sums p·v in float32 (each thread one 16-byte column of v for a
// quarter of a chunk's positions); the PA_PG position groups are added in
// order, each row's partial is pushed to the member that writes that row
// (member c writes row c of the tile), and after a second barrier that
// member adds the partials in member order.  Past PA_CLUSTER ·
// PA_SCORE_CHUNKS · PA_CHUNK = 1024 positions a member's later scores do
// not fit: their chunks keep the online (max, sum) in pass one and pass
// two recomputes their scores, reading k a second time.
//
// What bounds it on the card: latency, not bytes.  A member's work at the
// serving shapes is a few chunks; its life (scripts/kernel_trace.py marks
// each phase) is three dependent global round trips (pos, the table, the
// first k tile) and two cluster barriers, and four 256-thread blocks of 64
// registers fit an SM, so the target's verify shape (2048 blocks) runs in
// about four waves.
//
// Rounding points are the plain version's (layers._masked_attention): each
// q·k dot rounded to the pool's type, then scaled in float32; masked lanes
// finfo(float32).min; the normalised probabilities rounded to the pool's
// type; p·v summed in float32; the output in the pool's type.  (The sum l
// is formed online, as the first port's was.)
//
// Determinism: every sum's order is fixed by the row's positions, its
// slot's window base and the compile-time constants (chunk, member, lane,
// position group); positions outside a row's keys add exact zeros, and a
// member with none of the row's valid positions adds l_c·exp(finfo.min −
// M) = 0.  A row's output therefore does not depend on B, the other rows
// of its tile, the SM count or the schedule.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

#define PA_CLUSTER 8                   // members per cluster (portable max)
#define PA_CHUNK 32                    // positions per chunk (one per lane)
#define PA_ROWS 8                      // query rows per tile, a warp each
#define PA_THREADS (PA_ROWS * 32)
#define PA_SCORE_CHUNKS 4              // chunks per member with kept scores
#define PA_SCORES (PA_SCORE_CHUNKS * PA_CHUNK)
#define PA_PAGE_CHUNKS 32              // chunks per member with staged pages
#define PA_PG 4                        // position groups of the p·v pass
#define PA_MAX_HD 256
static_assert(PA_CLUSTER == PA_ROWS, "member c writes row c of a tile");

template <typename T> struct Vec;
// 16 bytes of float32: 4 values
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static __forceinline__ void unpack(uint4 v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
// 16 bytes of bfloat16: 8 values, element 0 in the low half of each word
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static __forceinline__ void unpack(uint4 v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round a float32 value to T and back (the plain version's einsum output
// type and its probs.to(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct PagedArgs {
  const void *q, *kp, *vp;
  const long long *table, *pos;
  void *out;
  int Sq, H, Hkv, hd, ps, max_pages;
  int window;  // > 0: the sliding window (below the extent)
  float scale;
};

// bytes of one position of a k / v tile: hd values padded to an odd
// number of 16-byte vectors, so the 8 lanes of a quarter warp reading one
// vector of 8 consecutive positions hit 8 distinct bank groups
__host__ __device__ inline int pa_stride(int hd, int el) {
  const int vpr = hd * el / 16;
  return 16 * (vpr | 1);
}

// the ring's depth: 4 tiles for hd up to 128 (about 52 KB of shared memory
// in bf16, four blocks an SM), 3 past it
__host__ __device__ constexpr int pa_stages(int max_hd) {
  return max_hd <= 128 ? 4 : 3;
}

__host__ inline size_t pa_smem_bytes(int hd, int el, int stages) {
  return (size_t)stages * PA_CHUNK * pa_stride(hd, el) +
         sizeof(float) * (2 * (size_t)PA_ROWS * hd + PA_ROWS * PA_SCORES +
                          PA_ROWS * PA_CHUNK) +
         sizeof(int) * PA_PAGE_CHUNKS * PA_CHUNK;
}

// the ring's item i: pass one reads k of local chunks 0..n_c-1; pass two
// reads v of the chunks with kept scores, then k and v of each later one
__device__ __forceinline__ void item_of(int i, int n_c, int n_st, bool &is_v,
                                        int &k) {
  if (i < n_c) {
    is_v = false;
    k = i;
    return;
  }
  i -= n_c;
  if (i < n_st) {
    is_v = true;
    k = i;
    return;
  }
  i -= n_st;
  is_v = i & 1;
  k = n_st + (i >> 1);
}

// acc + q[0, PER) · one 16-byte vector of k, in order
template <typename T>
__device__ __forceinline__ float dot_vec(const float *qr,
                                         const unsigned char *kr, float acc) {
  constexpr int PER = Vec<T>::N;
  float f[PER];
  Vec<T>::unpack(*reinterpret_cast<const uint4 *>(kr), f);
  const float4 *q4 = reinterpret_cast<const float4 *>(qr);
#pragma unroll
  for (int e = 0; e < PER / 4; ++e) {
    const float4 x = q4[e];
    acc = fmaf(x.x, f[4 * e], acc);
    acc = fmaf(x.y, f[4 * e + 1], acc);
    acc = fmaf(x.z, f[4 * e + 2], acc);
    acc = fmaf(x.w, f[4 * e + 3], acc);
  }
  return acc;
}

// the float32 dot of q's row (shared memory, float) with one position of
// a k tile (hd values of T): two chains over alternate 16-byte vectors
template <typename T>
__device__ __forceinline__ float dot_row(const float *qr,
                                         const unsigned char *kr, int vpr) {
  constexpr int PER = Vec<T>::N;
  float a0 = 0.f, a1 = 0.f;
  int v = 0;
  for (; v + 1 < vpr; v += 2) {
    a0 = dot_vec<T>(qr + PER * v, kr + 16 * v, a0);
    a1 = dot_vec<T>(qr + PER * (v + 1), kr + 16 * (v + 1), a1);
  }
  if (v < vpr) a0 = dot_vec<T>(qr + PER * v, kr + 16 * v, a0);
  return a0 + a1;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// MAX_HD: 128 or 256, the widest head this instantiation takes (it sizes
// the per-thread p·v accumulators and the ring's depth, not the sums)
template <typename T, int MAX_HD>
__global__ void __cluster_dims__(PA_CLUSTER, 1, 1)
    __launch_bounds__(PA_THREADS, MAX_HD <= 128 ? 4 : 2)
        paged_attention_kernel(PagedArgs a) {
  constexpr int PER = Vec<T>::N;
  constexpr int STAGES = pa_stages(MAX_HD);
  // p·v items per thread: (position group, row, 16-byte column)
  constexpr int MAXI = PA_PG * PA_ROWS * (MAX_HD / PER) / PA_THREADS;
  // 16-byte vectors of one chunk tile per thread
  constexpr int MAXV = PA_CHUNK * (MAX_HD / PER) / PA_THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_xmax[PA_CLUSTER][PA_ROWS], s_xsum[PA_CLUSTER][PA_ROWS];
  cg::cluster_group cluster = cg::this_cluster();
  // every member must have started before another writes its shared
  // memory: arrive now, wait before the first push
  cluster_arrive_relaxed();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / PA_CLUSTER;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, ps = a.ps, Hkv = a.Hkv;
  const int n_rep = a.H / Hkv;
  const int R = a.Sq * n_rep;
  const int r0 = tile * PA_ROWS;
  const int rows = min(PA_ROWS, R - r0);
  const int vpr = hd / PER;                    // 16-byte vectors a position
  const int stride = pa_stride(hd, (int)sizeof(T));
  const int tile_bytes = PA_CHUNK * stride;
  unsigned char *ring = smem;
  float *s_q = reinterpret_cast<float *>(smem + STAGES * tile_bytes);
  float *s_recv = s_q + PA_ROWS * hd;          // (PA_CLUSTER, hd): my row
  float *s_sc = s_recv + PA_ROWS * hd;         // (PA_ROWS, PA_SCORES)
  float *s_p = s_sc + PA_ROWS * PA_SCORES;     // (PA_ROWS, PA_CHUNK)
  int *s_page = reinterpret_cast<int *>(s_p + PA_ROWS * PA_CHUNK);
  float *s_red = reinterpret_cast<float *>(ring);  // after the ring's last use

  const long long p_b = a.pos[b];
  const long long extent = (long long)a.max_pages * ps;
  // the positions a tile may read, [base, base + span): the window's
  // slice, else the whole extent; a row of limit lim attends [lower(lim),
  // upper(lim)) of them (layers.window_valid's rule; lim − window passes
  // base only where the slice is clamped at the extent's end)
  const bool win = a.window > 0;
  const long long base =
      win ? min(max(p_b + a.Sq - 1 - a.window, 0LL), extent - a.window) : 0;
  const long long span = win ? (long long)a.window : extent;
  auto lower = [&](long long lim) {
    return win ? max(base, lim - a.window) : 0LL;
  };
  auto upper = [&](long long lim) {
    return win ? min(base + a.window, lim) : lim;
  };
  // n_pos positions from base: to the tile's largest upper bound, or the
  // whole span when one of its rows has no valid position
  bool any_empty = false;
  long long hi = base;
  for (int rr = 0; rr < rows; ++rr) {
    const long long l = p_b + (r0 + rr) / n_rep;
    if (upper(l) <= lower(l)) any_empty = true;
    else hi = max(hi, upper(l));
  }
  const int n_pos = (int)(any_empty ? span : min(span, hi - base));
  const int n_chunks = (n_pos + PA_CHUNK - 1) / PA_CHUNK;
  const int n_c =
      rank < n_chunks ? (n_chunks - 1 - rank) / PA_CLUSTER + 1 : 0;
  const int n_st = min(n_c, PA_SCORE_CHUNKS);
  const int n_items = 2 * n_c + (n_c - n_st);
  const bool has_row = warp < rows;
  const long long lim = p_b + (r0 + warp) / n_rep;
  const long long lo_w = lower(lim), up_w = upper(lim);
  const long long *trow = a.table + (size_t)b * a.max_pages;
  const float scale = a.scale;

  // the ring's item i into its stage: vector u of this thread (element
  // e = tid + u·PA_THREADS of the tile) from page page_of(u, k, j, p) of
  // position p = chunk k's j-th, zeros past n_pos
  auto issue_with = [&](int i, auto page_of) {
    if (i < n_items) {
      bool is_v;
      int k;
      item_of(i, n_c, n_st, is_v, k);
      const T *pool = static_cast<const T *>(is_v ? a.vp : a.kp);
      unsigned char *dst = ring + (i % STAGES) * tile_bytes;
      const int p0 = (rank + PA_CLUSTER * k) * PA_CHUNK;
#pragma unroll
      for (int u = 0; u < MAXV; ++u) {
        const int e = tid + u * PA_THREADS;
        if (e >= PA_CHUNK * vpr) break;
        const int j = e / vpr, vi = e % vpr;
        const int p = p0 + j;
        unsigned char *d = dst + j * stride + 16 * vi;
        if (p < n_pos) {
          const long long ap = base + p;        // the logical position
          const long long page = page_of(u, k, j, ap);
          cp_async16(d, pool + (((size_t)page * ps + ap % ps) * Hkv + kvh) *
                                   hd + PER * vi);
        } else {
          *reinterpret_cast<uint4 *>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();  // one group per item, empty past the last
  };
  // the first STAGES - 1 tiles: their pages read from the table all at
  // once, then copied; q and the pages of this member's first
  // PA_PAGE_CHUNKS chunks are staged while those tiles load (later chunks
  // read the table per copy)
  {
    long long pre[STAGES - 1][MAXV];
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      bool is_v = false;
      int k = 0;
      if (i < n_items) item_of(i, n_c, n_st, is_v, k);
      const int p0 = (rank + PA_CLUSTER * k) * PA_CHUNK;
#pragma unroll
      for (int u = 0; u < MAXV; ++u) {
        const int e = tid + u * PA_THREADS;
        const int p = p0 + e / vpr;
        pre[i][u] = i < n_items && e < PA_CHUNK * vpr && p < n_pos
                        ? trow[(base + p) / ps] : 0;
      }
    }
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i)
      issue_with(i, [&](int u, int, int, int) { return pre[i][u]; });
  }
  auto issue = [&](int i) {
    issue_with(i, [&](int, int k, int j, long long ap) {
      return k < PA_PAGE_CHUNKS ? (long long)s_page[k * PA_CHUNK + j]
                                : trow[ap / ps];
    });
  };
  for (int e = tid; e < min(n_c, PA_PAGE_CHUNKS) * PA_CHUNK;
       e += PA_THREADS) {
    const int p = (rank + PA_CLUSTER * (e / PA_CHUNK)) * PA_CHUNK +
                  e % PA_CHUNK;
    s_page[e] = p < n_pos ? (int)trow[(base + p) / ps] : 0;
  }
  const T *q = static_cast<const T *>(a.q);
  for (int e = tid; e < PA_ROWS * hd; e += PA_THREADS) {
    const int rr = e / hd, d = e % hd;
    float x = 0.f;
    if (rr < rows) {
      const int r = r0 + rr, i = r / n_rep, h = kvh * n_rep + r % n_rep;
      x = to_f(q[(((size_t)b * a.Sq + i) * a.H + h) * hd + d]);
    }
    s_q[e] = x;
  }

  // the masked, scaled score of position base + p0 + lane for this
  // warp's row
  auto score = [&](const unsigned char *kt, int p0) {
    const int p = p0 + lane;
    if (p >= n_pos) return -INFINITY;          // absent: adds nothing
    const long long ap = base + p;
    if (ap >= up_w || ap < lo_w) return -FLT_MAX;  // masked: finfo.min
    return round_to<T>(dot_row<T>(s_q + warp * hd, kt + lane * stride, vpr)) *
           scale;
  };

  // pass one: scores; the lane's max over kept scores, and the running
  // (max, sum of exp) of the chunks past PA_SCORE_CHUNKS
  float m_lane = -INFINITY, mo = -INFINITY, lo = 0.f;
  for (int i = 0; i < n_c; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    if (has_row) {
      const int p0 = (rank + PA_CLUSTER * i) * PA_CHUNK;
      const float s = score(ring + (i % STAGES) * tile_bytes, p0);
      if (i < n_st) {
        s_sc[warp * PA_SCORES + i * PA_CHUNK + lane] = s;
        m_lane = fmaxf(m_lane, s);
      } else {
        const float cm = warp_max(s);
        const float cs = warp_sum(expf(s - cm));
        const float nm = fmaxf(mo, cm);
        lo = lo * expf(mo - nm) + cs * expf(cm - nm);
        mo = nm;
      }
    }
  }

  // this member's (max m_c, sum of exp(s − m_c)) of the row, pushed by
  // lane c into member c; then the row's max M (order-free) and its sum
  // l = Σ_c l_c · exp(m_c − M), added in member order 0..PA_CLUSTER-1
  const float m_mem = fmaxf(warp_max(m_lane), mo);
  float l_mem = 0.f;
  if (has_row) {
    float e = 0.f;
    for (int k = 0; k < n_st; ++k)
      e += expf(s_sc[warp * PA_SCORES + k * PA_CHUNK + lane] - m_mem);
    l_mem = warp_sum(e);
    if (n_c > n_st) l_mem += lo * expf(mo - m_mem);
  }
  cluster_wait();
  if (lane < PA_CLUSTER) {
    *cluster.map_shared_rank(&s_xmax[rank][warp], lane) = m_mem;
    *cluster.map_shared_rank(&s_xsum[rank][warp], lane) = l_mem;
  }
  cluster.sync();
  const float M =
      warp_max(lane < PA_CLUSTER ? s_xmax[lane][warp] : -INFINITY);
  float l = 0.f;
#pragma unroll
  for (int c = 0; c < PA_CLUSTER; ++c)
    l += s_xsum[c][warp] * expf(s_xmax[c][warp] - M);
  // kept scores become probabilities in place
  if (has_row)
    for (int k = 0; k < n_st; ++k) {
      float *sp = s_sc + warp * PA_SCORES + k * PA_CHUNK + lane;
      *sp = round_to<T>(expf(*sp - M) / l);
    }

  // pass two: p·v in float32; item u of this thread is (position group
  // pg, row rr, 16-byte column vi), its positions pg·8 .. pg·8 + 7 of
  // every chunk, summed chunk after chunk
  const int n_it = PA_PG * PA_ROWS * vpr;
  float acc[MAXI][PER];
#pragma unroll
  for (int u = 0; u < MAXI; ++u)
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[u][e] = 0.f;
  for (int i = n_c; i < n_items; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(i + STAGES - 1);
    bool is_v;
    int k;
    item_of(i, n_c, n_st, is_v, k);
    const unsigned char *kt = ring + (i % STAGES) * tile_bytes;
    if (!is_v) {
      // a chunk past the kept scores: score it again, same arithmetic
      if (has_row) {
        const int p0 = (rank + PA_CLUSTER * k) * PA_CHUNK;
        const float s = score(kt, p0);
        s_p[warp * PA_CHUNK + lane] = round_to<T>(expf(s - M) / l);
      }
      continue;
    }
#pragma unroll
    for (int u = 0; u < MAXI; ++u) {
      const int it = tid + u * PA_THREADS;
      if (it >= n_it) break;
      const int vi = it % vpr, rr = (it / vpr) % PA_ROWS;
      const int pg = it / (vpr * PA_ROWS);
      if (rr >= rows) continue;
      const float *pr = k < n_st ? s_sc + rr * PA_SCORES + k * PA_CHUNK
                                 : s_p + rr * PA_CHUNK;
#pragma unroll
      for (int jj = 0; jj < PA_CHUNK / PA_PG; ++jj) {
        const int j = pg * (PA_CHUNK / PA_PG) + jj;
        const float pj = pr[j];
        float f[PER];
        Vec<T>::unpack(
            *reinterpret_cast<const uint4 *>(kt + j * stride + 16 * vi), f);
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[u][e] = fmaf(pj, f[e], acc[u][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it now holds the partial outputs

  // position groups in order, then each row's partial pushed to the
  // member that writes it (member c writes row r0 + c)
#pragma unroll
  for (int u = 0; u < MAXI; ++u) {
    const int it = tid + u * PA_THREADS;
    if (it >= n_it) break;
    const int vi = it % vpr, rest = it / vpr;  // rest = pg·PA_ROWS + rr
#pragma unroll
    for (int e = 0; e < PER; ++e) s_red[rest * hd + PER * vi + e] = acc[u][e];
  }
  __syncthreads();
  for (int o = tid; o < rows * hd; o += PA_THREADS) {
    float s = s_red[o];
#pragma unroll
    for (int pg = 1; pg < PA_PG; ++pg) s += s_red[pg * PA_ROWS * hd + o];
    *cluster.map_shared_rank(s_recv + rank * hd + o % hd, o / hd) = s;
  }
  cluster.sync();
  // my row: the members' partials in member order
  if (rank < rows) {
    T *out = static_cast<T *>(a.out);
    const int r = r0 + rank, i = r / n_rep, h = kvh * n_rep + r % n_rep;
    for (int d = tid; d < hd; d += PA_THREADS) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < PA_CLUSTER; ++c) s += s_recv[c * hd + d];
      out[(((size_t)b * a.Sq + i) * a.H + h) * hd + d] = from_f<T>(s);
    }
  }
}

template <typename T, int MAX_HD>
static int launch(const PagedArgs &a, int B, cudaStream_t stream) {
  static size_t opted = 48 * 1024;
  const size_t smem =
      pa_smem_bytes(a.hd, (int)sizeof(T), pa_stages(MAX_HD));
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, MAX_HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  const int R = a.Sq * (a.H / a.Hkv);
  const dim3 grid(((R + PA_ROWS - 1) / PA_ROWS) * PA_CLUSTER, a.Hkv, B);
  paged_attention_kernel<T, MAX_HD><<<grid, PA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_hd(const PagedArgs &a, int B, cudaStream_t stream) {
  if (a.hd <= 128) return launch<T, 128>(a, B, stream);
  return launch<T, PA_MAX_HD>(a, B, stream);
}

// bf16 != 0: q, pools and out are bfloat16, else float32.  table (B,
// max_pages) and pos (B,) are int64; window 0 (full causal) or in (0,
// max_pages · ps).  The wrapper checks that H % Hkv == 0,
// hd is a multiple of 8 up to 256 and the pools are 16-byte aligned; any
// page size >= 1.
extern "C" int paged_attention_launch(const void *q, const void *kp,
                                      const void *vp, const void *table,
                                      const void *pos, void *out, int B,
                                      int Sq, int H, int Hkv, int hd, int ps,
                                      int max_pages, int window, int bf16,
                                      float scale, void *stream) {
  PagedArgs a;
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.table = static_cast<const long long *>(table);
  a.pos = static_cast<const long long *>(pos);
  a.out = out;
  a.Sq = Sq;
  a.H = H;
  a.Hkv = Hkv;
  a.hd = hd;
  a.ps = ps;
  a.max_pages = max_pages;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_hd<__nv_bfloat16>(a, B, s);
  return launch_hd<float>(a, B, s);
}
