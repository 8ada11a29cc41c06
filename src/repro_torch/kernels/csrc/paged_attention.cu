// Paged-decode attention: GQA attention of q (B, Sq, H, hd) over a
// block-paged KV pool (P, page_size, Hkv, hd) through per-slot page tables
// (B, max_pages) of physical page ids (page 0 = the null page).  Query i
// of slot b, head h attends the logical kv positions < pos[b] + i of kv
// head h / n_rep; masked lanes take the finfo(float32).min score, so they
// add exact zeros and a row never depends on pages past its limit.  The
// output is in the pool's type (float32 or bfloat16).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_kernel
// (body _paged_attn_body).  The TPU kernel walks all max_pages pages of
// the table, stashes every score and v page in VMEM and runs one softmax
// at the last page; that extent does not fit a block's shared memory.
//
// Design: grid (row tile, kv head, slot), 8 warps, up to 16 query rows
// (Sq·n_rep rows, row r = i·n_rep + g) per block, one warp per row; each
// block reads its own page ids and pos (no scalar prefetch).  It visits
// only the pages that hold a position some row of the block may attend,
// ceil((pos[b] + i_max) / page_size), not max_pages: the skipped pages
// are masked for every row and would add exact zeros.  (A row with no
// valid position — pos + i <= 0 — averages v over the whole extent in the
// plain version, so such a block visits every page.)  Shared memory holds
// one k page and one v page at a time (16 × 128 × 4 B = 8 KB each at
// LLAMA_7B's hd, page_size 16, kept as float).  A page is read in 16-byte
// vectors (k and v together in pass two) into registers while the block
// works on the page before it, so the walk overlaps its memory latency
// with the scoring (a page of one kv head must fit the threads' 16 KB of
// vectors: 8192 bf16 or 4096 float values).
//
// Two passes keep the plain version's rounding points
// (layers._masked_attention): each q·k dot is rounded to the pool's type,
// then scaled in float32; pass one reads k and finds every row's max and
// sum of exp (rescaled online); pass two reads k again, forms the
// normalised probabilities, rounds them to the pool's type and
// accumulates p·v in float32.  Lane c of a row's warp holds q's dims c,
// c+32, ... in registers and sums them against every position of the
// page (page_size independent chains); a butterfly of shuffles then halves
// the positions each lane carries at every step, so page_size 16 costs 16
// shuffles for 16 dot products and lane L ends with position
// L / (32 / page_size).  Page sizes are the powers of two up to 32 (one
// instantiation each); lane c also sums output dims c, c+32, ...
//
// Bound: bytes.  It must read the live k/v pages once per (slot, kv head)
// plus q and write out: at B=8, Hkv=32, hd=128, pos ~500, bf16 that is
// about 67 MB, 20 us at 3.35 TB/s, while the 2·(q·k + p·v) float32
// operations take about 5 us at 67 TFLOP/s.  One block per (slot, kv
// head, tile) fills B·Hkv·tiles blocks: 256 at B=8, Hkv=32, Sq=5, but only
// 96 of the 132 SMs at the draft's Hkv=12, Sq=1, and a block walks its
// slot's pages one after another, so the longest slot sets the time.
// Splitting along the kv axis (split-KV online softmax, flash-decoding) is
// the first speed work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

#define PA_WARPS 8
#define PA_THREADS (PA_WARPS * 32)
#define PA_RPW 2                      // query rows per warp
#define PA_TILE (PA_WARPS * PA_RPW)   // query rows per block
#define PA_MAXC 8                     // hd / 32, hd <= 256
#define PA_INFLIGHT 4                 // 16-byte vectors per thread per page

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
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// unpack a 16-byte vector of T into float shared memory
__device__ __forceinline__ void store_vec(float *dst, uint4 v, float) {
  const float *f = reinterpret_cast<const float *>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];
}
__device__ __forceinline__ void store_vec(float *dst, uint4 v,
                                          __nv_bfloat16) {
  const __nv_bfloat16 *h = reinterpret_cast<const __nv_bfloat16 *>(&v);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

// one page of kv head kvh from NP pools: this thread's 16-byte vectors of
// it (at most PA_INFLIGHT per pool; the wrapper checks that a page fits),
// loaded into registers, where they stay in flight while the block works
// on the previous page.  Rows start at multiples of hd (a multiple of 32)
// elements, so with 16-byte aligned pools every vector is aligned.
template <typename T, int NP, int PS>
__device__ __forceinline__ void fetch_page(uint4 (&buf)[NP][PA_INFLIGHT],
                                           const T *const (&pool)[NP],
                                           long long phys, int kvh, int Hkv,
                                           int hd) {
  constexpr int PER = 16 / sizeof(T);
  const int vpr = hd / PER;                     // vectors per row
#pragma unroll
  for (int u = 0; u < PA_INFLIGHT; ++u) {
    const int i = u * PA_THREADS + threadIdx.x;
    if (i < PS * vpr) {
      const size_t off =
          (((size_t)phys * PS + i / vpr) * Hkv + kvh) * hd + (i % vpr) * PER;
#pragma unroll
      for (int w = 0; w < NP; ++w)
        buf[w][u] = __ldg(reinterpret_cast<const uint4 *>(pool[w] + off));
    }
  }
}

// the fetched vectors into NP float tiles (PS, hd) in shared memory
template <typename T, int NP, int PS>
__device__ __forceinline__ void stash_page(float *const (&dst)[NP],
                                           const uint4 (&buf)[NP][PA_INFLIGHT],
                                           int hd) {
  constexpr int PER = 16 / sizeof(T);
  const int vpr = hd / PER;
#pragma unroll
  for (int u = 0; u < PA_INFLIGHT; ++u) {
    const int i = u * PA_THREADS + threadIdx.x;
    if (i < PS * vpr) {
#pragma unroll
      for (int w = 0; w < NP; ++w)
        store_vec(dst[w] + i * PER, buf[w][u], T());
    }
  }
}

// Sum N per-lane values (one per position) over the warp: each step at
// offset O keeps half of them (the upper half where lane bit O is set) and
// adds the partner's matching half, so after log2(N) steps a lane holds
// one position's sum over N lanes, and the remaining steps add the other
// lanes'.  Lane L ends with the full sum of position L / (32 / N).
template <int N, int O>
__device__ __forceinline__ float butterfly(float *v, int lane) {
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (N > 1) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? v[i] : v[i + N / 2];
      const float keep = upper ? v[i + N / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return butterfly<N / 2, O / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    return butterfly<1, O / 2>(v, lane);
  }
}

// the masked, scaled score of position lane / (32 / PS) of the page in
// shared memory (PS, hd) for the query row whose dims lane + 32c are in
// qv; every lane of the warp must call it
template <typename T, int PS>
__device__ __forceinline__ float page_score(const float (&qv)[PA_MAXC],
                                            const float *s_k, int hd, int nc,
                                            int lane, float scale,
                                            bool valid) {
  float v[PS];
#pragma unroll
  for (int j = 0; j < PS; ++j) {
    float a = 0.f;
#pragma unroll
    for (int c = 0; c < PA_MAXC; ++c)
      if (c < nc) a = fmaf(qv[c], s_k[j * hd + lane + 32 * c], a);
    v[j] = a;
  }
  const float dot = butterfly<PS, 16>(v, lane);
  return valid ? round_to<T>(dot) * scale : -FLT_MAX;
}

template <typename T, int PS>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const T *__restrict__ q, const T *__restrict__ kp,
                       const T *__restrict__ vp,
                       const long long *__restrict__ table,
                       const long long *__restrict__ pos, T *__restrict__ out,
                       int Sq, int H, int Hkv, int hd, int max_pages,
                       float scale) {
  constexpr int LPP = 32 / PS;            // lanes holding one position
  extern __shared__ float smem[];
  const int n_rep = H / Hkv;
  const int R = Sq * n_rep;
  const int r0 = blockIdx.x * PA_TILE;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nrows = min(PA_TILE, R - r0);
  float *s_k = smem;                      // (PS, hd)
  float *s_v = s_k + PS * hd;             // (PS, hd)
  float *s_p = s_v + PS * hd;             // (PA_TILE, PS)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int jl = lane / LPP;              // the position this lane scores
  const bool lead = lane % LPP == 0;
  const int nc = hd / 32;
  float *const k_dst[1] = {s_k};
  const T *const k_src[1] = {kp};
  float *const kv_dst[2] = {s_k, s_v};
  const T *const kv_src[2] = {kp, vp};

  float qv[PA_RPW][PA_MAXC];
#pragma unroll
  for (int t = 0; t < PA_RPW; ++t) {
    const int r = r0 + warp + t * PA_WARPS;
    const int qi = r / n_rep, h = kvh * n_rep + r % n_rep;
#pragma unroll
    for (int c = 0; c < PA_MAXC; ++c)
      qv[t][c] = (c < nc && r < r0 + nrows)
                     ? to_f(q[(((size_t)b * Sq + qi) * H + h) * hd + lane +
                              32 * c])
                     : 0.f;
  }
  const long long p_b = pos[b];
  const long long lim_lo = p_b + r0 / n_rep;
  const long long lim_hi = p_b + (r0 + nrows - 1) / n_rep;
  const int n_vis =
      lim_lo <= 0 ? max_pages
                  : (int)min((long long)max_pages, (lim_hi + PS - 1) / PS);
  const long long *trow = table + (size_t)b * max_pages;

  float m[PA_RPW], l[PA_RPW];
#pragma unroll
  for (int t = 0; t < PA_RPW; ++t) {
    m[t] = -INFINITY;
    l[t] = 0.f;
  }

  // pass one: every row's max and sum of exp over the visited pages
  uint4 kb[1][PA_INFLIGHT];
  fetch_page<T, 1, PS>(kb, k_src, trow[0], kvh, Hkv, hd);
  long long id_next = n_vis > 1 ? trow[1] : 0;
  for (int pg = 0; pg < n_vis; ++pg) {
    __syncthreads();
    stash_page<T, 1, PS>(k_dst, kb, hd);
    __syncthreads();
    if (pg + 1 < n_vis) {
      fetch_page<T, 1, PS>(kb, k_src, id_next, kvh, Hkv, hd);
      id_next = pg + 2 < n_vis ? trow[pg + 2] : 0;
    }
#pragma unroll
    for (int t = 0; t < PA_RPW; ++t) {
      const int rr = warp + t * PA_WARPS;
      if (rr >= nrows) continue;
      const long long lim = p_b + (r0 + rr) / n_rep;
      const float s = page_score<T, PS>(qv[t], s_k, hd, nc, lane, scale,
                                        (long long)pg * PS + jl < lim);
      const float m_new = fmaxf(m[t], warp_max(s));
      const float part = warp_sum(lead ? expf(s - m_new) : 0.f);
      l[t] = l[t] * expf(m[t] - m_new) + part;
      m[t] = m_new;
    }
  }

  // pass two: normalised probabilities in T, p·v summed in float32
  float acc[PA_RPW][PA_MAXC];
#pragma unroll
  for (int t = 0; t < PA_RPW; ++t)
#pragma unroll
    for (int c = 0; c < PA_MAXC; ++c) acc[t][c] = 0.f;
  uint4 kvb[2][PA_INFLIGHT];
  fetch_page<T, 2, PS>(kvb, kv_src, trow[0], kvh, Hkv, hd);
  id_next = n_vis > 1 ? trow[1] : 0;
  for (int pg = 0; pg < n_vis; ++pg) {
    __syncthreads();
    stash_page<T, 2, PS>(kv_dst, kvb, hd);
    __syncthreads();
    if (pg + 1 < n_vis) {
      fetch_page<T, 2, PS>(kvb, kv_src, id_next, kvh, Hkv, hd);
      id_next = pg + 2 < n_vis ? trow[pg + 2] : 0;
    }
#pragma unroll
    for (int t = 0; t < PA_RPW; ++t) {
      const int rr = warp + t * PA_WARPS;
      if (rr >= nrows) continue;
      const long long lim = p_b + (r0 + rr) / n_rep;
      float *sp = s_p + rr * PS;
      const float s = page_score<T, PS>(qv[t], s_k, hd, nc, lane, scale,
                                        (long long)pg * PS + jl < lim);
      if (lead) sp[jl] = round_to<T>(expf(s - m[t]) / l[t]);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < PS; ++j) {
        const float pj = sp[j];
        const float *vr = s_v + j * hd + lane;
#pragma unroll
        for (int c = 0; c < PA_MAXC; ++c)
          if (c < nc) acc[t][c] = fmaf(pj, vr[32 * c], acc[t][c]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < PA_RPW; ++t) {
    const int rr = warp + t * PA_WARPS;
    if (rr >= nrows) continue;
    const int r = r0 + rr, qi = r / n_rep, h = kvh * n_rep + r % n_rep;
    T *o = out + (((size_t)b * Sq + qi) * H + h) * hd + lane;
#pragma unroll
    for (int c = 0; c < PA_MAXC; ++c)
      if (c < nc) o[32 * c] = from_f<T>(acc[t][c]);
  }
}

template <typename T, int PS>
static int launch(const void *q, const void *kp, const void *vp,
                  const void *table, const void *pos, void *out, int B,
                  int Sq, int H, int Hkv, int hd, int max_pages, float scale,
                  cudaStream_t stream) {
  const int R = Sq * (H / Hkv);
  const dim3 grid((R + PA_TILE - 1) / PA_TILE, Hkv, B);
  const size_t smem = sizeof(float) * (2 * (size_t)PS * hd + PA_TILE * PS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, PS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<T, PS><<<grid, PA_THREADS, smem, stream>>>(
      (const T *)q, (const T *)kp, (const T *)vp, (const long long *)table,
      (const long long *)pos, (T *)out, Sq, H, Hkv, hd, max_pages, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_ps(const void *q, const void *kp, const void *vp,
                     const void *table, const void *pos, void *out, int B,
                     int Sq, int H, int Hkv, int hd, int ps, int max_pages,
                     float scale, cudaStream_t s) {
  switch (ps) {
  case 1: return launch<T, 1>(q, kp, vp, table, pos, out, B, Sq, H, Hkv, hd,
                              max_pages, scale, s);
  case 2: return launch<T, 2>(q, kp, vp, table, pos, out, B, Sq, H, Hkv, hd,
                              max_pages, scale, s);
  case 4: return launch<T, 4>(q, kp, vp, table, pos, out, B, Sq, H, Hkv, hd,
                              max_pages, scale, s);
  case 8: return launch<T, 8>(q, kp, vp, table, pos, out, B, Sq, H, Hkv, hd,
                              max_pages, scale, s);
  case 16: return launch<T, 16>(q, kp, vp, table, pos, out, B, Sq, H, Hkv,
                                hd, max_pages, scale, s);
  case 32: return launch<T, 32>(q, kp, vp, table, pos, out, B, Sq, H, Hkv,
                                hd, max_pages, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 != 0: q, pools and out are bfloat16, else float32.  table (B,
// max_pages) and pos (B,) are int64.  The wrapper checks that H % Hkv == 0,
// hd is a multiple of 32 up to 256, ps a power of two up to 32, a page of
// one kv head fits PA_THREADS·PA_INFLIGHT 16-byte vectors and the pools
// are 16-byte aligned.
extern "C" int paged_attention_launch(const void *q, const void *kp,
                                      const void *vp, const void *table,
                                      const void *pos, void *out, int B,
                                      int Sq, int H, int Hkv, int hd, int ps,
                                      int max_pages, int bf16, float scale,
                                      void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_ps<__nv_bfloat16>(q, kp, vp, table, pos, out, B, Sq, H,
                                    Hkv, hd, ps, max_pages, scale, s);
  return launch_ps<float>(q, kp, vp, table, pos, out, B, Sq, H, Hkv, hd, ps,
                          max_pages, scale, s);
}
