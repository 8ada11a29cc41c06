// The RWKV6 WKV recurrence over a sequence, the state resident for the
// whole of it: for each (row b, head h), t = 0..S-1,
//
//   y_t,j = sum_i r_t,i (S_ij + u_i k_t,i v_t,j)
//   S_ij <- w_t,i S_ij + k_t,i v_t,j
//
// r, k, v (B, S, H, hd) and u (H, hd) in float32 or bfloat16 (upcast on
// use), w (B, S, H, hd) float32, s0 (B, H, hd, hd) float32.  Writes y
// (B, S, H, hd) float32 and the final state once.
//
// Replaces: src/repro/kernels/wkv.py::wkv_kernel.  The TPU kernel blocks S
// into grid steps that carry the state in VMEM; its body is the exact
// per-timestep recurrence, so the blocking is tiling only.  In the port
// this kernel runs every sequence-mode WKV (prefill and admission chunks
// of an RWKV6 model, any S), where a plain time loop would issue thousands
// of launches.
//
// Design: the state update S_ij <- w_i S_ij + k_i v_j is elementwise, a
// chain of two operations a timestep; only y sums over the key axis, and
// that sum can be formed after the fact.  So the state is spread over
// (key, value) elements: a block takes one (b, h) and a tile of WKV_JT
// value columns, on a grid (hd / WKV_JT, H, B) (160 blocks of 256 threads
// at rwkv6-3b's H=40, hd=64, B=1); thread (g, j) keeps keys g·KPT .. g·KPT
// + KPT - 1 of column j in registers (KPT = hd / 16: 1, 2, 4 or 8, no
// spill at 128).  Per timestep a thread updates its KPT state elements
// (__fmul_rn then __fadd_rn, the plain version's two roundings, so the
// state equals ref.wkv_ref's bit for bit) and forms its partial of y over
// its keys (FMA allowed), which it writes to shared memory.  After each
// tile of WKV_TS timesteps the partials are summed over the 16 key groups
// in group order, one output a thread.  y's summation order is thus set
// by hd alone (keys in order within a group, then groups in order), never
// by B, S or the grid: a row alone gives what it gives in a batch.
// Tiles of r, k, w (every key) and v (the block's columns) come through
// two shared-memory buffers filled by cp.async in 16-byte pieces, the
// next tile's copies in flight while the current one is walked; each
// thread copies the same pieces of every tile, their addresses set up
// once.  Where a base is off the 16-byte grid (another instantiation),
// a thread holds its elements of the next tile in registers during a
// walk, stores them after it and loads the tile after.  The walk
// loads four timesteps' inputs before it computes and stores their
// partials.
//
// Bound: bytes.  It reads r, k, v, w once and writes y once (4 * S * hd
// elements per (b, h) in, S * hd floats out) and the state once each way.
// At B=1, S=32, H=40 (an rwkv6-3b admission chunk in bf16) that is about
// 1.7 MB, 0.5 us.  What holds it (scripts/kernel_trace.py): the walk, five
// float operations per state element and timestep and four shared-memory
// loads a thread, issued by 8 warps on an SM (at B=1, 28 of the 132 SMs
// take two of the 160 blocks and set the launch's span); the copies and
// the reduction take a fifth of a block's life.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "recurrent.cuh"

#define WKV_TS 16              // timesteps a tile
#define WKV_STAGES 2           // tile buffers: the next tile's copies in flight
#define WKV_JT 16              // value columns a block
#define WKV_G 16               // key groups a column is split over
#define WKV_THREADS (WKV_JT * WKV_G)
#define WKV_PCOL (WKV_G + 1)   // a column's partials, padded
#define WKV_PART (WKV_JT * WKV_PCOL)  // a timestep's partials

static_assert(WKV_TS * WKV_JT == WKV_THREADS,
              "the reduction takes one (timestep, column) a thread");

// One tile of a (b, h)'s inputs: r, k, w of every key and v of the block's
// columns, WKV_TS timesteps (rows 16-byte aligned for cp.async).
template <typename T, int HD>
struct WkvTile {
  T r[WKV_TS][HD], k[WKV_TS][HD];
  float w[WKV_TS][HD];
  T v[WKV_TS][WKV_JT];
};

// K consecutive values from shared memory (aligned to their width) as
// float
template <int K>
__device__ __forceinline__ void wkv_ld(const float *p, float out[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      const float4 f = *(const float4 *)(p + q);
      out[q] = f.x;
      out[q + 1] = f.y;
      out[q + 2] = f.z;
      out[q + 3] = f.w;
    }
  } else if constexpr (K == 2) {
    const float2 f = *(const float2 *)p;
    out[0] = f.x;
    out[1] = f.y;
  } else {
    out[0] = *p;
  }
}
template <int K>
__device__ __forceinline__ void wkv_ld(const __nv_bfloat16 *p,
                                       float out[K]) {
  if constexpr (K % 2 == 0) {
    unsigned u[K / 2];
    if constexpr (K == 8) {
      const uint4 v = *(const uint4 *)p;
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    } else if constexpr (K == 4) {
      const uint2 v = *(const uint2 *)p;
      u[0] = v.x, u[1] = v.y;
    } else {
      u[0] = *(const unsigned *)p;
    }
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      out[2 * q] = __uint_as_float(u[q] << 16);
      out[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
    }
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// The 16-byte pieces of a tile that a thread copies by cp.async, set up
// once: its pieces are c = tid + u * WKV_THREADS of a tile's CPT pieces
// a timestep; src is a piece's address at t0 = 0, and dst packs its byte
// offset in the tile, its timestep in the tile (WKV_TS: no piece) and
// whether it is a piece of w (whose timestep stride is that of float).
template <typename T, int HD>
struct WkvCopies {
  static constexpr int CR = HD * (int)sizeof(T) / 16, CW = HD / 4,
                       CV = WKV_JT * (int)sizeof(T) / 16;
  static constexpr int CPT = 2 * CR + CW + CV;
  static constexpr int PPT = (WKV_TS * CPT + WKV_THREADS - 1) / WKV_THREADS;
  const char *src[PPT];
  unsigned dst[PPT];

  __device__ __forceinline__ WkvCopies(const T *r, const T *k, const T *v,
                                       const float *w, size_t base,
                                       size_t row, int j0, int tid) {
    using Tile = WkvTile<T, HD>;
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      const int c = tid + u * WKV_THREADS, t = c / CPT;
      int q = c % CPT;
      const size_t off = base + (size_t)t * row;
      unsigned o, isw = 0;
      if (t >= WKV_TS) {
        src[u] = nullptr;
        dst[u] = (unsigned)WKV_TS << 16;
        continue;
      }
      if (q < CR) {
        src[u] = (const char *)(r + off) + 16 * q;
        o = offsetof(Tile, r) + t * HD * sizeof(T);
      } else if ((q -= CR) < CR) {
        src[u] = (const char *)(k + off) + 16 * q;
        o = offsetof(Tile, k) + t * HD * sizeof(T);
      } else if ((q -= CR) < CW) {
        src[u] = (const char *)(w + off) + 16 * q;
        o = offsetof(Tile, w) + t * HD * 4;
        isw = 1;
      } else {
        q -= CW;
        src[u] = (const char *)(v + off + j0) + 16 * q;
        o = offsetof(Tile, v) + t * WKV_JT * sizeof(T);
      }
      dst[u] = (o + 16 * q) | (unsigned)t << 16 | isw << 24;
    }
  }

  // copy timesteps [t0, t0 + n) into the tile at smem (a shared address)
  __device__ __forceinline__ void issue(unsigned smem, int t0, int n,
                                        size_t row) const {
    const size_t st = (size_t)t0 * row * sizeof(T),
                 sw = (size_t)t0 * row * sizeof(float);
#pragma unroll
    for (int u = 0; u < PPT; ++u) {
      if ((int)((dst[u] >> 16) & 0xff) >= n) continue;
      const char *p = src[u] + (dst[u] >> 24 ? sw : st);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem + (dst[u] & 0xffff)),
                   "l"(p)
                   : "memory");
    }
  }
};

// The tiles of a (b, h) whose inputs lie off the 16-byte grid (cp.async
// copies no piece under 4 bytes, so a bfloat16 input at an odd element
// offset cannot take it): a thread loads its elements of a tile into
// registers (fetch) a tile ahead and stores them (put) after the walk of
// the tile before, so the loads are in flight during a walk.  Its
// elements of r, k and w are e = tid + u * WKV_THREADS of a tile's
// WKV_TS x HD (timestep e / HD, key e % HD), of v the one at tid.
template <typename T, int HD>
struct WkvStaged {
  static constexpr int NR = WKV_TS * HD / WKV_THREADS;
  static_assert(NR * WKV_THREADS == WKV_TS * HD &&
                    WKV_TS * WKV_JT == WKV_THREADS,
                "every thread takes as many elements");
  const T *r, *k, *v;
  const float *w;
  size_t base, row;
  int j0, tid;
  T rv[NR], kv[NR], vv;
  float wv[NR];

  __device__ __forceinline__ WkvStaged(const T *r, const T *k, const T *v,
                                       const float *w, size_t base,
                                       size_t row, int j0, int tid)
      : r(r), k(k), v(v), w(w), base(base), row(row), j0(j0), tid(tid) {}

  // timesteps [t0, t0 + n) into the registers
  __device__ __forceinline__ void fetch(int t0, int n) {
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int e = tid + u * WKV_THREADS, tt = e / HD;
      if (tt >= n) continue;
      const size_t off = base + (size_t)(t0 + tt) * row + e % HD;
      rv[u] = r[off];
      kv[u] = k[off];
      wv[u] = w[off];
    }
    const int tt = tid / WKV_JT;
    if (tt < n) vv = v[base + (size_t)(t0 + tt) * row + j0 + tid % WKV_JT];
  }

  // the fetched n timesteps into a tile
  __device__ __forceinline__ void put(WkvTile<T, HD> &tile, int n) const {
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int e = tid + u * WKV_THREADS, tt = e / HD;
      if (tt >= n) continue;
      tile.r[tt][e % HD] = rv[u];
      tile.k[tt][e % HD] = kv[u];
      tile.w[tt][e % HD] = wv[u];
    }
    const int tt = tid / WKV_JT;
    if (tt < n) tile.v[tt][tid % WKV_JT] = vv;
  }
};

// VEC: every base on the 16-byte grid (the tiles by cp.async), else the
// tiles through registers (WkvStaged)
template <typename T, int HD, bool VEC>
__global__ void __launch_bounds__(WKV_THREADS, 2)
wkv_kernel(const T *__restrict__ r, const T *__restrict__ k,
           const T *__restrict__ v, const float *__restrict__ w,
           const T *__restrict__ u, const float *__restrict__ s0,
           float *__restrict__ y, float *__restrict__ sout, int S, int H) {
  constexpr int KPT = HD / WKV_G;  // keys a thread holds
  extern __shared__ __align__(16) char wkv_smem[];
  WkvTile<T, HD> *tiles = (WkvTile<T, HD> *)wkv_smem;
  // the partials of y: [timestep][column][key group], a column's 16
  // padded to 17 floats so that neither the walk's stores nor the
  // reduction's loads meet on a bank
  float *part =
      (float *)(wkv_smem + WKV_STAGES * sizeof(WkvTile<T, HD>));
  const int j0 = blockIdx.x * WKV_JT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, j = tid % WKV_JT, g = tid / WKV_JT;
  const int i0 = g * KPT;
  const size_t row = (size_t)H * HD;  // stride of one timestep
  const size_t base = (size_t)b * S * row + (size_t)h * HD;
  const int n_tiles = (S + WKV_TS - 1) / WKV_TS;
  auto steps = [&](int c) { return min(WKV_TS, S - c * WKV_TS); };
  std::conditional_t<VEC, WkvCopies<T, HD>, WkvStaged<T, HD>> io(
      r, k, v, w, base, row, j0, tid);
  auto stage = [&](int c) {  // tile c into its buffer
    if constexpr (VEC)
      io.issue((unsigned)__cvta_generic_to_shared(&tiles[c % WKV_STAGES]),
               c * WKV_TS, steps(c), row);
  };
  if constexpr (VEC) {
    for (int c = 0; c < WKV_STAGES - 1; ++c) {
      if (c < n_tiles) stage(c);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  } else {
    static_assert(WKV_STAGES == 2, "a tile is put while the other is walked");
    io.fetch(0, steps(0));
    io.put(tiles[0], steps(0));
    if (n_tiles > 1) io.fetch(WKV_TS, steps(1));
  }
  float uq[KPT], s[KPT];
  const size_t sbase = ((size_t)b * H + h) * HD * HD + j0 + j;
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    uq[q] = rec_ld(u + (size_t)h * HD + i0 + q);
    s[q] = s0[sbase + (size_t)(i0 + q) * HD];
  }
  for (int c = 0; c < n_tiles; ++c) {
    const int t0 = c * WKV_TS, n = steps(c);
    if constexpr (VEC) {
      const int cn = c + WKV_STAGES - 1;  // its buffer was last read before
      if (cn < n_tiles) stage(cn);        // the barrier of tile c - 1
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" ::"n"(WKV_STAGES - 1)
                   : "memory");
    }
    __syncthreads();  // tile c has landed; the last reduction is done
    const WkvTile<T, HD> &tl = tiles[c % WKV_STAGES];
    // WG timesteps at a time: every load of the group before the first
    // partial is stored (the stores could alias the loads otherwise);
    // the tile's last n % WG one at a time
    auto walk = [&](auto count, int t1) {
      constexpr int CN = decltype(count)::value;
      float rq[CN][KPT], kq[CN][KPT], wq[CN][KPT], vj[CN][1], acc[CN];
#pragma unroll
      for (int e = 0; e < CN; ++e) {
        wkv_ld<KPT>(&tl.r[t1 + e][i0], rq[e]);
        wkv_ld<KPT>(&tl.k[t1 + e][i0], kq[e]);
        wkv_ld<KPT>(&tl.w[t1 + e][i0], wq[e]);
        wkv_ld<1>(&tl.v[t1 + e][j], vj[e]);
      }
#pragma unroll
      for (int e = 0; e < CN; ++e) {
        acc[e] = 0.f;
#pragma unroll
        for (int q = 0; q < KPT; ++q) {
          const float kv = __fmul_rn(kq[e][q], vj[e][0]);
          acc[e] = fmaf(rq[e][q], fmaf(uq[q], kv, s[q]), acc[e]);
          s[q] = __fadd_rn(__fmul_rn(wq[e][q], s[q]), kv);
        }
      }
#pragma unroll
      for (int e = 0; e < CN; ++e)
        part[(t1 + e) * WKV_PART + j * WKV_PCOL + g] = acc[e];
    };
    constexpr int WG = KPT >= 8 ? 2 : 4;
    int t1 = 0;
    for (; t1 + WG <= n; t1 += WG) walk(std::integral_constant<int, WG>(), t1);
    for (; t1 < n; ++t1) walk(std::integral_constant<int, 1>(), t1);
    if constexpr (!VEC) {  // tile c + 1 into the buffer tile c - 1 left
      if (c + 1 < n_tiles) io.put(tiles[(c + 1) % WKV_STAGES], steps(c + 1));
      if (c + 2 < n_tiles) io.fetch((c + 2) * WKV_TS, steps(c + 2));
    }
    __syncthreads();  // every partial of the tile is written
    const int tt = tid / WKV_JT, jj = tid % WKV_JT;
    if (tt < n) {
      const float *pt = part + tt * WKV_PART + jj * WKV_PCOL;
      float p[WKV_G];
#pragma unroll
      for (int gg = 0; gg < WKV_G; ++gg) p[gg] = pt[gg];
      float acc = p[0];
#pragma unroll
      for (int gg = 1; gg < WKV_G; ++gg) acc = __fadd_rn(acc, p[gg]);
      y[base + (size_t)(t0 + tt) * row + j0 + jj] = acc;
    }
  }
#pragma unroll
  for (int q = 0; q < KPT; ++q) sout[sbase + (size_t)(i0 + q) * HD] = s[q];
}

template <typename T>
static int launch(const void *r, const void *k, const void *v,
                  const void *w, const void *u, const void *s0, void *y,
                  void *sout, int B, int S, int H, int hd, cudaStream_t st) {
  const int vec = (((uintptr_t)r | (uintptr_t)k | (uintptr_t)v |
                    (uintptr_t)w) & 15) == 0;
  const dim3 grid(hd / WKV_JT, H, B);
#define WKV_CASE(HDV)                                                        \
  case HDV: {                                                                \
    const int smem = WKV_STAGES * (int)sizeof(WkvTile<T, HDV>) +             \
                     4 * WKV_TS * WKV_PART;                                  \
    auto kern = vec ? wkv_kernel<T, HDV, true> : wkv_kernel<T, HDV, false>;   \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);            \
    if (e != cudaSuccess) {                                                  \
      cudaGetLastError();                                                    \
      return (int)e;                                                         \
    }                                                                        \
    kern<<<grid, WKV_THREADS, smem, st>>>(                                   \
        (const T *)r, (const T *)k, (const T *)v, (const float *)w,          \
        (const T *)u, (const float *)s0, (float *)y, (float *)sout, S, H);   \
    break;                                                                   \
  }
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
