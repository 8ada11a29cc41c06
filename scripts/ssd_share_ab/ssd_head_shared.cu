// The chunked Mamba2 SSD scan with C.B^T shared over heads: the design
// that csrc/ssd.cu was measured against (scripts/ssd_share_ab.py builds
// this file with the options below and times it beside the library's
// kernel; it is not part of the library).  Same interface, same
// arithmetic as csrc/ssd.cu: the chunked scan, the products in the 3xTF32
// split on mma.sync, exp(cum_i - cum_j) per pair.
//
// C.B^T depends neither on h nor on d, so the blocks of one b form
// thread-block clusters of up to SSD_CMAX (ssd_cluster: heads first, then
// row tiles), and per chunk each member computes its share of the raw
// lower-triangle 16x8 tiles of C.B^T (tile x at member x mod the
// cluster's size).  Each member applies its own head's decay to every
// tile: as it loads them for y over distributed shared memory, or, with
// SSD_GATHER, in one pass that copies them all into its own shared memory
// first.  A block owns one (b, h) and SSD_DT of its rows: 256 threads, 16
// rows, two blocks a SM by default (92 KB of shared memory at hd = N = 64,
// chunk 128), or -DSSD_THREADS=512 -DSSD_DT=32 -DSSD_MINB=1 for the
// library kernel's geometry.  ssd_occ reports how many clusters the card
// holds at once.
#include <cooperative_groups.h>
#include <cstdint>

#include "recurrent.cuh"

namespace cg = cooperative_groups;

#ifndef SSD_THREADS
#define SSD_THREADS 256
#define SSD_DT 16    // state rows (y columns) a block owns: two n8 tiles
#define SSD_MINB 2   // blocks an SM holds
#endif
#define SSD_WARPS (SSD_THREADS / 32)
#ifndef SSD_CMAX
#define SSD_CMAX 8
#endif
#define SSD_SMEM_MAX (227 * 1024)  // a block's shared memory, opted in

// The cluster over the blocks of one b: cy heads by cx row tiles, the
// largest powers of two that divide H, then the row tiles' count, with
// cx cy <= SSD_CMAX <= 8 (the portable cluster size)
__host__ __device__ inline void ssd_cluster(int hd, int H, int &cx,
                                            int &cy) {
  const int D = (hd + SSD_DT - 1) / SSD_DT;
  cy = SSD_CMAX;
  while (H % cy) cy >>= 1;
  cx = SSD_CMAX / cy;
  while (D % cx) cx >>= 1;
}

// Float offsets of one block's shared memory, the same in every block of
// a cluster (the tiles are read at the same offset in another member).
// Lp = Lc rounded up to the 16-row tiles, Np = N to the 8-column k steps.
// Row strides keep a fragment's reads on 32 banks: ldbc = Np + 4 for B,
// C and the state, ldx = 8 or 24 for dtx; where that does not fit, Np
// and the width of the block's rows (a bank conflict, not a refusal).
struct SsdLayout {
  int Lp, Np, ldbc, ldx, ndm, R, tiles, slots;
  int ws, cum, ecum, wj, xs, bs, cs, hs, floats, wl;
  __host__ __device__ SsdLayout(int hd, int N, int Lc, int csz) {
    Lp = (Lc + 15) & ~15;
    Np = (N + 7) & ~7;
    ndm = hd < SSD_DT ? hd : SSD_DT;   // rows of the widest block
    R = Lp / 16;                       // row tiles of the chunk
    tiles = R * (R + 1);               // 16x8 tiles on or below the diagonal
    slots = (tiles + csz - 1) / csz;   // tiles a member owns, at most
    place(Np + 4, ndm <= 8 ? 8 : ndm <= 16 ? 24 : 40, Lc);
    if (4 * (size_t)floats > SSD_SMEM_MAX) place(Np, (ndm + 3) & ~3, Lc);
  }
  __host__ __device__ void place(int ld, int lx, int Lc) {
    ldbc = ld;
    ldx = lx;
    ws = 0;                            // owned C.B^T tiles, 128 floats each
    cum = ws + slots * 128;            // la, then its cumulative sum
    ecum = cum + Lp;                   // exp(cum_i)
    wj = ecum + Lp;                    // exp(tot - cum_j)
    xs = wj + Lp;                      // dtx: Lp x ldx
    bs = xs + Lp * ldx;                // B: Lc x ldbc
    cs = bs + Lc * ldbc;               // C: Lc x ldbc
    hs = cs + Lc * ldbc;               // the state tile: ndm x ldbc
    floats = hs + ndm * ldbc;
#ifdef SSD_GATHER
    wl = floats;
    floats += tiles * 128;
#endif
  }
};

// x = hi + lo: hi is x rounded to TF32 (half an ulp up in magnitude, two
// integer operations; the inputs are finite and far from overflow), lo =
// x - hi exactly, handed to the tensor core as it is (it reads the top 19
// bits: lo is off by under 2^-21 |x|)
__device__ __forceinline__ void ssd_split(float x, unsigned &hi,
                                          unsigned &lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One m16n8k8 output tile in the 3xTF32 split, its three products in
// accumulators of their own (a_hi b_hi, a_hi b_lo, a_lo b_hi), so that
// consecutive products do not wait on each other; a thread holds rows g,
// g + 8 by columns 2 t, 2 t + 1 of each.
struct SsdAcc {
  float hh[4], hl[4], lh[4];
  __device__ __forceinline__ SsdAcc() {
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[e] = hl[e] = lh[e] = 0.f;
  }
};

#define SSD_MMA(D, A, B)                                                     \
  asm volatile(                                                              \
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "   \
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"                             \
      : "+f"(D[0]), "+f"(D[1]), "+f"(D[2]), "+f"(D[3])                       \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "r"(B[0]), "r"(B[1]))

// acc += a.b for one k step, a and b float32 fragments (a: rows g, g + 8
// by columns t, t + 4; b: rows t, t + 4 of column g)
__device__ __forceinline__ void ssd_mma3(SsdAcc &acc, const float a[4],
                                         const float b[2]) {
  unsigned ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) ssd_split(a[e], ah[e], al[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) ssd_split(b[e], bh[e], bl[e]);
  SSD_MMA(acc.lh, al, bh);
  SSD_MMA(acc.hl, ah, bl);
  SSD_MMA(acc.hh, ah, bh);
}

// acc[k & 1] += A_k . B_k for k = 0 .. nk - 1, two k steps in flight
// (their loads issued before either's products); ld_a(k, a) and ld_b(k,
// b) fetch step k's fragments
template <class LdA, class LdB>
__device__ __forceinline__ void ssd_gemm(SsdAcc acc[2], int nk, LdA ld_a,
                                         LdB ld_b) {
  int k = 0;
  for (; k + 1 < nk; k += 2) {
    float a0[4], b0[2], a1[4], b1[2];
    ld_a(k, a0);
    ld_b(k, b0);
    ld_a(k + 1, a1);
    ld_b(k + 1, b1);
    ssd_mma3(acc[0], a0, b0);
    ssd_mma3(acc[1], a1, b1);
  }
  if (k < nk) {
    float a0[4], b0[2];
    ld_a(k, a0);
    ld_b(k, b0);
    ssd_mma3(acc[0], a0, b0);
  }
}

// the tile's value: the two k parities' products, small ones first
__device__ __forceinline__ float ssd_sum(const SsdAcc acc[2], int e) {
  return (acc[0].hh[e] + acc[1].hh[e]) +
         ((acc[0].hl[e] + acc[0].lh[e]) + (acc[1].hl[e] + acc[1].lh[e]));
}

__device__ __forceinline__ void ssd_cp(float *dst, const float *src,
                                       int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// Rows [0, n) of a region: row i takes `cols` values from src + i *
// stride (elements), rows [n, Lc) are zeroed (the identity-padded tail);
// rows past Lc and columns past cols stay the zeros they were set to.
// Rows go over the warps, a row's values over the lanes.  float32 goes by
// cp.async (16-byte pieces where vec), bfloat16 by plain loads (four rows
// a lane in flight), upcast.
__device__ __forceinline__ void ssd_rows(float *dst, int ld,
                                         const float *src, long long stride,
                                         int n, int Lc, int cols, bool vec,
                                         int warp, int lane) {
  const int step = vec ? 4 : 1;
  for (int i = warp; i < Lc; i += SSD_WARPS)
    for (int q = step * lane; q < cols; q += 32 * step) {
      float *d = dst + i * ld + q;
      if (i >= n) {
        if (vec)
          *(float4 *)d = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          *d = 0.f;
      } else {
        ssd_cp(d, src + i * stride + q, vec ? 16 : 4);
      }
    }
}
__device__ __forceinline__ void ssd_rows(float *dst, int ld,
                                         const __nv_bfloat16 *src,
                                         long long stride, int n, int Lc,
                                         int cols, bool, int warp, int lane) {
  constexpr int U = 4;
  for (int i0 = U * warp; i0 < Lc; i0 += U * SSD_WARPS)
    for (int q = lane; q < cols; q += 32) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u] = i0 + u < n ? __bfloat162float(__ldg(src + (i0 + u) * stride + q))
                          : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + u < Lc) dst[(i0 + u) * ld + q] = v[u];
    }
}

__device__ __forceinline__ void ssd_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void ssd_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void ssd_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// vec bit 0: dtx in 16-byte pieces; bit 1: B and C in 16-byte pieces
template <typename T>
__global__ void __launch_bounds__(SSD_THREADS, SSD_MINB)
ssd_kernel(const float *__restrict__ la, const T *__restrict__ dtx,
           const T *__restrict__ Bf, const T *__restrict__ Cf,
           const float *__restrict__ h0, float *__restrict__ y,
           float *__restrict__ hout, int S, int H, int hd, int N, int Lc,
           int vec) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csz = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int lcs = __ffs(csz) - 1;  // csz is a power of two
  const SsdLayout L(hd, N, Lc, csz);
  const int Lp = L.Lp, Np = L.Np, ld = L.ldbc, ldx = L.ldx;
  float *cum = sm + L.cum, *ecum = sm + L.ecum, *wj = sm + L.wj;
  float *xs = sm + L.xs, *bs = sm + L.bs, *cs = sm + L.cs, *hs = sm + L.hs;
  float *ws = sm + L.ws;
  const int d0 = blockIdx.x * SSD_DT, h = blockIdx.y, b = blockIdx.z;
  const int nd = min(SSD_DT, hd - d0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // zeros everywhere first: the padding rows and columns stay zero
  for (int p = 4 * tid; p < L.floats; p += 4 * SSD_THREADS)
    *(float4 *)(sm + p) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const size_t bh = (size_t)b * H + h;
  for (int r = warp; r < nd; r += SSD_WARPS)
    for (int q = lane; q < N; q += 32)
      hs[r * ld + q] = h0[(bh * hd + d0 + r) * N + q];

  const long long xrow = (long long)H * hd;
  auto load_la = [&](int t0, int n) {
    const float *src = la + ((size_t)b * S + t0) * H + h;
    for (int i = tid; i < Lc; i += SSD_THREADS) {
      if (i < n)
        ssd_cp(cum + i, src + (size_t)i * H, 4);
      else
        cum[i] = 0.f;
    }
  };
  auto load_x = [&](int t0, int n) {
    ssd_rows(xs, ldx, dtx + (((size_t)b * S + t0) * H + h) * hd + d0, xrow,
             n, Lc, nd, vec & 1, warp, lane);
  };
  auto load_bc = [&](float *dst, const T *src, int t0, int n) {
    ssd_rows(dst, ld, src + ((size_t)b * S + t0) * N, N, n, Lc, N, vec & 2,
             warp, lane);
  };
  // row i of B or C, of the state (reads past the last row take it)
  auto bc_row = [&](const float *m, int i) { return m + min(i, Lc - 1) * ld; };
  auto h_row = [&](int r) { return hs + min(r, nd - 1) * ld; };
  const int nc = (S + Lc - 1) / Lc;
  load_la(0, min(Lc, S));
  load_x(0, min(Lc, S));
  load_bc(bs, Bf, 0, min(Lc, S));
  load_bc(cs, Cf, 0, min(Lc, S));
  ssd_commit();

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Lc, n = min(Lc, S - t0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the chunk's inputs have landed
    if (warp == 0) {  // cum = cumsum(la) over the padded chunk (rows
                      // past Lc hold the last chunk's sums: la = 0 there)
      float carry = 0.f;
      for (int i0 = 0; i0 < Lp; i0 += 32) {
        float v = i0 + lane < Lc ? cum[i0 + lane] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (i0 + lane < Lp) cum[i0 + lane] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float tot = cum[Lp - 1];
    for (int i = tid; i < Lp; i += SSD_THREADS) {
      ecum[i] = expf(cum[i]);
      wj[i] = expf(tot - cum[i]);
    }
    if (c > 0) ssd_cluster_wait();  // every reader is done with my tiles
    // my C.B^T tiles: tile x = s·csz + rank, row tile rt, column tile kt
    for (int s = warp; s < L.slots; s += SSD_WARPS) {
      const int x = s * csz + rank;
      if (x >= L.tiles) break;
      int rt = 0;
      while ((rt + 1) * (rt + 2) <= x) ++rt;
      const int kt = x - rt * (rt + 1);
      const float *c0 = bc_row(cs, rt * 16 + g) + t4,
                  *c1 = bc_row(cs, rt * 16 + g + 8) + t4,
                  *b0 = bc_row(bs, kt * 8 + g) + t4;
      SsdAcc acc[2];
      ssd_gemm(
          acc, Np / 8,
          [&](int k, float a[4]) {
            a[0] = c0[8 * k], a[1] = c1[8 * k], a[2] = c0[8 * k + 4],
            a[3] = c1[8 * k + 4];
          },
          [&](int k, float bb[2]) {
            bb[0] = b0[8 * k], bb[1] = b0[8 * k + 4];
          });
      // element e of the accumulator is (row g + 8 (e >> 1), column 2 t4 +
      // (e & 1)); store it where lane (row & 7) * 4 + (col & 3) of an A
      // fragment reads it, as its element (row >> 3) + 2 (col >> 2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), cc = 2 * t4 + (e & 1);
        ws[s * 128 + ((r & 7) * 4 + (cc & 3)) * 4 + (r >> 3) + 2 * (cc >> 2)] =
            ssd_sum(acc, e);
      }
    }
    ssd_cluster_arrive();
    ssd_cluster_wait();  // every C.B^T tile of the chunk is published
#ifdef SSD_GATHER
    for (int q = tid; q < L.tiles * 32; q += SSD_THREADS) {
      const int x = q >> 5, ln = q & 31;
      int rt = 0;
      while ((rt + 1) * (rt + 2) <= x) ++rt;
      const int kt = x - rt * (rt + 1);
      const float4 cb = *(const float4 *)(
          cluster.map_shared_rank(ws, x & (csz - 1)) + (x >> lcs) * 128 +
          ln * 4);
      const int i0 = rt * 16 + (ln >> 2), j = kt * 8 + (ln & 3);
      const float ci0 = cum[i0], ci1 = cum[i0 + 8], cj0 = cum[j],
                  cj1 = cum[j + 4];
      float4 w;
      w.x = j <= i0 ? expf(ci0 - cj0) * cb.x : 0.f;
      w.y = j <= i0 + 8 ? expf(ci1 - cj0) * cb.y : 0.f;
      w.z = j + 4 <= i0 ? expf(ci0 - cj1) * cb.z : 0.f;
      w.w = j + 4 <= i0 + 8 ? expf(ci1 - cj1) * cb.w : 0.f;
      *(float4 *)(sm + L.wl + q * 4) = w;
    }
    ssd_cluster_arrive();  // done reading the members' tiles
    __syncthreads();
#endif
    // y: warp (p, nt) takes column tile nt and row tiles p, 7 - p, 8 + p,
    // 15 - p, ...
    {
      const int nt = warp % (SSD_DT / 8), p = warp / (SSD_DT / 8);
      if (nt * 8 < nd) {
        const float *hr = h_row(nt * 8 + g) + t4;
        for (int rt = 0; rt < L.R; ++rt) {
          if ((rt & 7) != p && (rt & 7) != 7 - p) continue;
          const int i0 = rt * 16 + g;
          const float ci0 = cum[i0], ci1 = cum[i0 + 8];
          SsdAcc acc[2];
          const int x0 = rt * (rt + 1);  // the row tile's first tile
          ssd_gemm(
              acc, 2 * rt + 2,
              [&](int kt, float a[4]) {  // W: the tile, decayed and masked
#ifdef SSD_GATHER
                const float4 w = *(const float4 *)(sm + L.wl + (x0 + kt) * 128 +
                                                   lane * 4);
                a[0] = w.x, a[1] = w.y, a[2] = w.z, a[3] = w.w;
#else
                const int x = x0 + kt, j = kt * 8 + t4;
                const float4 cb = *(const float4 *)(
                    cluster.map_shared_rank(ws, x & (csz - 1)) +
                    (x >> lcs) * 128 + lane * 4);
                const float cj0 = cum[j], cj1 = cum[j + 4];
                a[0] = j <= i0 ? expf(ci0 - cj0) * cb.x : 0.f;
                a[1] = j <= i0 + 8 ? expf(ci1 - cj0) * cb.y : 0.f;
                a[2] = j + 4 <= i0 ? expf(ci0 - cj1) * cb.z : 0.f;
                a[3] = j + 4 <= i0 + 8 ? expf(ci1 - cj1) * cb.w : 0.f;
#endif
              },
              [&](int kt, float bb[2]) {
                const float *xr = xs + (kt * 8 + t4) * ldx + nt * 8 + g;
                bb[0] = xr[0], bb[1] = xr[4 * ldx];
              });
          const float e0 = ecum[i0], e1 = ecum[i0 + 8];
          const float *c0 = bc_row(cs, i0) + t4, *c1 = bc_row(cs, i0 + 8) + t4;
          ssd_gemm(
              acc, Np / 8,
              [&](int k, float a[4]) {
                a[0] = e0 * c0[8 * k], a[1] = e1 * c1[8 * k],
                a[2] = e0 * c0[8 * k + 4], a[3] = e1 * c1[8 * k + 4];
              },
              [&](int k, float bb[2]) {
                bb[0] = hr[8 * k], bb[1] = hr[8 * k + 4];
              });
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + 8 * (e >> 1), d = nt * 8 + 2 * t4 + (e & 1);
            if (i < n && d < nd)
              y[(((size_t)b * S + t0 + i) * H + h) * hd + d0 + d] =
                  ssd_sum(acc, e);
          }
        }
      }
    }
#ifndef SSD_GATHER
    ssd_cluster_arrive();  // done reading the members' tiles
#endif
    __syncthreads();       // every warp has read C and the state
    if (c + 1 < nc) {
      load_bc(cs, Cf, t0 + Lc, min(Lc, S - t0 - Lc));
      ssd_commit();
    }
    // h' = exp(tot) h + (wj o X)^T B: warp w takes the block's column
    // tiles w, w + 8, ... (rows g and g + 8 of each, those below nd)
    const float etot = expf(tot);
    const int MT = (L.ndm + 15) / 16;
    for (int task = warp; task < MT * Np / 8; task += SSD_WARPS) {
      const int m = task % MT, nt = task / MT;
      const bool r0 = 16 * m + g < nd, r1 = 16 * m + g + 8 < nd;
      float *h0r = hs + (16 * m + g) * ld + nt * 8 + 2 * t4,
            *h1r = h0r + 8 * ld;
      SsdAcc acc[2];
      if (r0) acc[0].hh[0] = etot * h0r[0], acc[0].hh[1] = etot * h0r[1];
      if (r1) acc[0].hh[2] = etot * h1r[0], acc[0].hh[3] = etot * h1r[1];
      ssd_gemm(
          acc, Lp / 8,
          [&](int k, float a[4]) {
            const int j = 8 * k + t4;
            const float wa = wj[j], wb = wj[j + 4];
            const float *x0 = xs + j * ldx + 16 * m + g, *x1 = x0 + 4 * ldx;
            a[0] = wa * x0[0], a[1] = wa * x0[8], a[2] = wb * x1[0],
            a[3] = wb * x1[8];
          },
          [&](int k, float bb[2]) {
            const int j = 8 * k + t4;
            bb[0] = bc_row(bs, j)[nt * 8 + g];
            bb[1] = bc_row(bs, j + 4)[nt * 8 + g];
          });
      if (r0) h0r[0] = ssd_sum(acc, 0), h0r[1] = ssd_sum(acc, 1);
      if (r1) h1r[0] = ssd_sum(acc, 2), h1r[1] = ssd_sum(acc, 3);
    }
    __syncthreads();  // the state is updated; la, dtx and B are free
    if (c + 1 < nc) {
      const int n1 = min(Lc, S - t0 - Lc);
      load_la(t0 + Lc, n1);
      load_x(t0 + Lc, n1);
      load_bc(bs, Bf, t0 + Lc, n1);
      ssd_commit();
    }
  }
  ssd_cluster_wait();  // no member leaves while another reads its tiles
  for (int r = warp; r < nd; r += SSD_WARPS)
    for (int q = lane; q < N; q += 32)
      hout[(bh * hd + d0 + r) * N + q] = hs[r * ld + q];
}

// Shared memory of one block (SsdLayout) in a cluster of one, the most a
// block takes at (hd, N, Lc): its C.B^T tiles, the chunk's la / cum,
// exp(cum), exp(tot - cum), its dtx rows, B and C and the state tile.
// The wrapper reads it to refuse a chunk past the block's limit.
extern "C" int ssd_smem_bytes(int hd, int N, int Lc) {
  return (int)(sizeof(float) * (size_t)SsdLayout(hd, N, Lc, 1).floats);
}

template <typename T>
static int launch(const void *la, const void *dtx, const void *Bf,
                  const void *Cf, const void *h0, void *y, void *hout, int B,
                  int S, int H, int hd, int N, int Lc, cudaStream_t st) {
  int cx, cy;
  ssd_cluster(hd, H, cx, cy);
  const size_t smem =
      sizeof(float) * (size_t)SsdLayout(hd, N, Lc, cx * cy).floats;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not see it
    return (int)err;
  }
  const bool f32 = sizeof(T) == 4;
  const int vec =
      (f32 && ((uintptr_t)dtx & 15) == 0 && hd % 4 == 0 ? 1 : 0) |
      (f32 && (((uintptr_t)Bf | (uintptr_t)Cf) & 15) == 0 && N % 4 == 0 ? 2
                                                                          : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hd + SSD_DT - 1) / SSD_DT, H, B);
  cfg.blockDim = dim3(SSD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_kernel<T>, (const float *)la,
                           (const T *)dtx, (const T *)Bf, (const T *)Cf,
                           (const float *)h0, (float *)y, (float *)hout, S,
                           H, hd, N, Lc, vec);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int ssd_launch(const void *la, const void *dtx, const void *Bf,
                          const void *Cf, const void *h0, void *y,
                          void *hout, int B, int S, int H, int hd, int N,
                          int Lc, int bf16, void *stream) {
  if (bf16)
    return launch<__nv_bfloat16>(la, dtx, Bf, Cf, h0, y, hout, B, S, H, hd,
                                 N, Lc, (cudaStream_t)stream);
  return launch<float>(la, dtx, Bf, Cf, h0, y, hout, B, S, H, hd, N, Lc,
                       (cudaStream_t)stream);
}

// Clusters of the launch that fit on the card at once (times 1000) plus the
// cluster's size, at float32 inputs; a negative CUDA error where the query
// fails.
extern "C" int ssd_occ(int hd, int N, int Lc, int H, int B) {
  int cx, cy;
  ssd_cluster(hd, H, cx, cy);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hd + SSD_DT - 1) / SSD_DT, H, B);
  cfg.blockDim = dim3(SSD_THREADS);
  cfg.dynamicSmemBytes =
      sizeof(float) * (size_t)SsdLayout(hd, N, Lc, cx * cy).floats;
  cudaFuncSetAttribute(ssd_kernel<float>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)cfg.dynamicSmemBytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = cy;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, ssd_kernel<float>, &cfg);
  return e ? -(int)e : n * 1000 + cx * cy;
}
