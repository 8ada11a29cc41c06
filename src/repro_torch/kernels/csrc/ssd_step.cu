// The Mamba2 SSD recurrence, one timestep after another, in one launch:
// for each (row b, head h), with the (hd x N) state h and t = 0 .. S-1,
//
//   h_dn <- exp(la_t) h_dn + dtx_{t,d} B_{t,n}
//   y_{t,d} = sum_n h_dn C_{t,n}
//
// la (B, S, H) float32; dtx (B, S, H, hd), B and C (B, S, N) in float32
// or bfloat16 (upcast on use); the state float32, read from h0 and the
// final one written to a new buffer h1; y (B, S, H, hd) float32.  S = 1
// is the decode step (ops.ssd_step, la (B, H) ...: the same memory); S >=
// 1 the per-timestep sequence path (ops.ssd_scan).
//
// Replaces: src/repro/kernels/ssd.py::ssd_step_kernel (every decode step
// of a Mamba2 or Zamba2 model, one launch per layer) and the reference's
// lax.scan of that step (models/ssm.py, the sequence path for S <= chunk
// or chunk == 0), which the card ran as one launch per timestep before.
//
// Bound: bytes.  The state is read once and written once, 2 * 4 * hd * N
// bytes per (b, h): at zamba2-1.2b's decode step (B=4, H=64, hd=N=64)
// 8.4 MB, 2.5 us at 3.35 TB/s, against 5 * hd * N float operations per
// (b, h) and step.  A step of the scan adds only its inputs (la, a dtx
// row, B and C: under 1 KB per (b, h)) and its y.
//
// Design: a row's N columns are split over TPR lanes (a power of two up
// to 32, a function of N alone), lane j holding the 4-column groups j,
// j + TPR, ...; a thread holds SSD_RPT rows, so a block of SSD_THREADS
// threads owns SSD_RPT · SSD_THREADS / TPR of the H·hd (head, row) pairs
// of one b (16 at N=64), on a grid (ceil(H·hd / rows), B): a B=1 prompt
// still fills the card (256 blocks at H=64, hd=64).  The block loads its
// state tile once, every 16-byte load issued before the first use, keeps
// it in registers across the S steps and writes it once.  Each step's
// inputs (la of the block's heads, its dtx rows, B, C) come through a
// ring of SSD_STAGES shared-memory slots filled by cp.async, SSD_STAGES -
// 1 steps ahead of the step being computed, each thread copying the same
// piece every step (its address set up once); one block barrier a step.
// A step is a short chain per warp (the loads of B and C, the update of
// both rows, a butterfly whose levels serve both rows), and that chain,
// not the copies, sets its time.
// The update is the plain version's, rounded one operation at a time
// (__fmul_rn / __fadd_rn, expf as torch.exp), so the state equals
// ref.ssd_step_ref step for step; y_d is multiply then sum over n: each
// lane sums its columns in column order, then a butterfly over the TPR
// lanes of the row.  That order depends on N alone (not on S, B, the grid
// or the loads' width), so one launch over S steps gives, bit for bit,
// what S launches of the S = 1 entry give.
#include <cstdint>

#include "recurrent.cuh"

#define SSD_THREADS 128
#define SSD_RPT 2              // state rows a thread holds
#define SSD_STAGES 8           // ring slots (a power of two): steps in flight
#define SSD_MAX_NK 8           // 4-column groups a lane holds: N <= 1024

__host__ __device__ inline int ssd_tpr(int N) {
  const int groups = (N + 3) / 4;
  int t = 1;
  while (t < groups && t < 32) t *= 2;
  return t;
}

__host__ __device__ inline int ssd_round16(int bytes) {
  return (bytes + 15) & ~15;
}

// the byte offsets of one ring slot: the la of the block's heads, its dtx
// rows, B, C (each 16-aligned)
struct SsdSlot {
  int off[4], bytes;
  __host__ __device__ SsdSlot(int heads, int rows, int N, int el) {
    off[0] = 0;
    off[1] = ssd_round16(4 * heads);
    off[2] = off[1] + ssd_round16(rows * el);
    off[3] = off[2] + ssd_round16(N * el);
    bytes = off[3] + ssd_round16(N * el);
  }
};

// One piece of a step's inputs that a thread copies into the ring: from
// src + t·stride (bytes) to the slot's offset dst, g bytes (16 or 4 by
// cp.async, 2 by a plain copy: a bfloat16 off the 4-byte grid).
struct SsdCopy {
  const char *src;
  long long stride;
  int dst, g;
};

// the log2 of the widest of 16, 4, 2 bytes that divides a region's base,
// stride and bytes, so that every step's pieces of it are aligned alike
__device__ __forceinline__ int ssd_shift(const char *base, long long stride,
                                         int bytes) {
  const unsigned al = (unsigned)(uintptr_t)base | (unsigned)stride |
                      (unsigned)bytes;
  return (al & 15) == 0 ? 4 : (al & 3) == 0 ? 2 : 1;
}

// piece c of the step's four regions (la, dtx rows, B, C: bases at t = 0,
// strides, bytes, log2 of their piece sizes)
__device__ __forceinline__ void ssd_piece(int c, const char *const base[4],
                                          const long long stride[4],
                                          const int bytes[4],
                                          const int shift[4],
                                          const SsdSlot &lay, SsdCopy &cp) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = bytes[i] >> shift[i];
    if (c < n) {
      cp.src = base[i] + ((size_t)c << shift[i]);
      cp.stride = stride[i];
      cp.dst = lay.off[i] + (c << shift[i]);
      cp.g = 1 << shift[i];
      return;
    }
    c -= n;
  }
}

__device__ __forceinline__ void ssd_copy(char *slot, const SsdCopy &cp,
                                         int t) {
  const char *src = cp.src + (long long)t * cp.stride;
  const unsigned dst = (unsigned)__cvta_generic_to_shared(slot + cp.dst);
  if (cp.g == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else if (cp.g == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    *(unsigned short *)(slot + cp.dst) = *(const unsigned short *)src;
}

// four consecutive values from shared memory (16 bytes of float, 8 of
// bfloat16, aligned), as float
__device__ __forceinline__ void ssd_ld4(const float *p, float v[4]) {
  const float4 f = *(const float4 *)p;
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void ssd_ld4(const __nv_bfloat16 *p,
                                        float v[4]) {
  const uint2 u = *(const uint2 *)p;
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// Rows are the H·hd (head, row) pairs of a batch row b, flattened (the
// memory order of dtx, y and the state); a block owns rows [R0, R0 + DG)
// of one b, which may span heads.  At most 64 registers a thread up to
// N = 256, so eight blocks fit an SM.
template <typename T, int NK>
__global__ void __launch_bounds__(SSD_THREADS, NK <= 2 ? 8 : 2)
ssd_step_kernel(const float *__restrict__ la, const T *__restrict__ dtx,
                const T *__restrict__ Bf, const T *__restrict__ Cf,
                const float *__restrict__ h0, float *__restrict__ y,
                float *__restrict__ h1, int S, int H, int hd, int N,
                int vec) {
  extern __shared__ __align__(16) char ring[];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int TPR = ssd_tpr(N), RP = SSD_THREADS / TPR, DG = SSD_RPT * RP;
  const int j = tid % TPR, rs = tid / TPR;
  const int HD = H * hd, R0 = blockIdx.x * DG, nrows = min(DG, HD - R0);
  const size_t bR = (size_t)b * HD;

  // this thread's rows and columns
  int rl[SSD_RPT];
  bool live[SSD_RPT];
#pragma unroll
  for (int r = 0; r < SSD_RPT; ++r) {
    rl[r] = rs + r * RP;
    live[r] = rl[r] < nrows;
  }
  bool col[NK][4], grp[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    grp[k] = 4 * (j + k * TPR) < N;
#pragma unroll
    for (int v = 0; v < 4; ++v) col[k][v] = 4 * (j + k * TPR) + v < N;
  }

  // the state tile: rows R0 + rl, columns 4·(j + k·TPR) + v, every load
  // issued before anything else
  float st[SSD_RPT][NK][4];
#pragma unroll
  for (int r = 0; r < SSD_RPT; ++r) {
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float *src = h0 + ((bR + R0 + rl[r]) * N + 4 * (j + k * TPR));
      if (vec) {
        const float4 v4 = live[r] && grp[k]
                              ? __ldg((const float4 *)src)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        st[r][k][0] = v4.x;
        st[r][k][1] = v4.y;
        st[r][k][2] = v4.z;
        st[r][k][3] = v4.w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          st[r][k][v] = live[r] && col[k][v] ? __ldg(src + v) : 0.f;
      }
    }
  }

  // the rows' heads, as indices into a slot's la
  const int h_first = R0 / hd, nheads = (R0 + nrows - 1) / hd - h_first + 1;
  const SsdSlot lay(nheads, DG, N, (int)sizeof(T));
  int hx[SSD_RPT];
#pragma unroll
  for (int r = 0; r < SSD_RPT; ++r)
    hx[r] = live[r] ? (R0 + rl[r]) / hd - h_first : 0;

  // the pieces of a step's inputs this thread copies (its first one set
  // up here; more only when a step has more pieces than the block threads)
  const size_t b0 = (size_t)b * S;
  const char *base[4] = {(const char *)(la + b0 * H + h_first),
                         (const char *)(dtx + b0 * HD + R0),
                         (const char *)(Bf + b0 * N),
                         (const char *)(Cf + b0 * N)};
  const long long stride[4] = {4LL * H, (long long)sizeof(T) * HD,
                               (long long)sizeof(T) * N,
                               (long long)sizeof(T) * N};
  const int bytes[4] = {4 * nheads, nrows * (int)sizeof(T),
                        N * (int)sizeof(T), N * (int)sizeof(T)};
  int shift[4], pieces = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    shift[i] = ssd_shift(base[i], stride[i], bytes[i]);
    pieces += bytes[i] >> shift[i];
  }
  SsdCopy mine;
  if (tid < pieces) ssd_piece(tid, base, stride, bytes, shift, lay, mine);
  auto issue = [&](int t) {
    if (t < S) {
      char *slot = ring + (t & (SSD_STAGES - 1)) * lay.bytes;
      if (tid < pieces) ssd_copy(slot, mine, t);
      for (int c = tid + SSD_THREADS; c < pieces; c += SSD_THREADS) {
        SsdCopy more;
        ssd_piece(c, base, stride, bytes, shift, lay, more);
        ssd_copy(slot, more, t);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int t = 0; t < SSD_STAGES - 1; ++t) issue(t);

  float *yt = y + b0 * HD + R0;
  for (int t = 0; t < S; ++t, yt += HD) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SSD_STAGES - 2)
                 : "memory");
    __syncthreads();             // step t landed; step t - 1 read by all
    issue(t + SSD_STAGES - 1);   // into step t - 1's slot
    const char *slot = ring + (t & (SSD_STAGES - 1)) * lay.bytes;
    const float *sla = (const float *)slot;
    const T *sx = (const T *)(slot + lay.off[1]);
    const T *sb = (const T *)(slot + lay.off[2]);
    const T *sc = (const T *)(slot + lay.off[3]);
    float a[SSD_RPT], x[SSD_RPT], acc[SSD_RPT];
#pragma unroll
    for (int r = 0; r < SSD_RPT; ++r) {
      a[r] = expf(sla[hx[r]]);
      x[r] = live[r] ? rec_ld(sx + rl[r]) : 0.f;
      acc[r] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      if (!grp[k]) continue;
      float bv[4], cv[4];
      ssd_ld4(sb + 4 * (j + k * TPR), bv);
      ssd_ld4(sc + 4 * (j + k * TPR), cv);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (!col[k][v]) continue;
#pragma unroll
        for (int r = 0; r < SSD_RPT; ++r) {
          const float hn = __fadd_rn(__fmul_rn(a[r], st[r][k][v]),
                                     __fmul_rn(x[r], bv[v]));
          st[r][k][v] = hn;
          acc[r] = __fadd_rn(acc[r], __fmul_rn(hn, cv[v]));
        }
      }
    }
    // a butterfly over the row's TPR lanes, widest stride first
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < TPR) {
#pragma unroll
        for (int r = 0; r < SSD_RPT; ++r)
          acc[r] = __fadd_rn(acc[r],
                             __shfl_xor_sync(0xffffffffu, acc[r], off));
      }
    }
#pragma unroll
    for (int r = 0; r < SSD_RPT; ++r)
      if (j == 0 && live[r]) yt[rl[r]] = acc[r];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < SSD_RPT; ++r) {
    if (!live[r]) continue;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      float *dst = h1 + ((bR + R0 + rl[r]) * N + 4 * (j + k * TPR));
      if (vec) {
        if (grp[k])
          *(float4 *)dst = make_float4(st[r][k][0], st[r][k][1],
                                       st[r][k][2], st[r][k][3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (col[k][v]) dst[v] = st[r][k][v];
      }
    }
  }
}

template <typename T, int NK>
static cudaError_t ssd_step_run(dim3 grid, size_t smem, cudaStream_t st,
                                const void *la, const void *dtx,
                                const void *Bf, const void *Cf,
                                const void *h0, void *y, void *h1, int S,
                                int H, int hd, int N, int vec) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_step_kernel<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ssd_step_kernel<T, NK><<<grid, SSD_THREADS, smem, st>>>(
      (const float *)la, (const T *)dtx, (const T *)Bf, (const T *)Cf,
      (const float *)h0, (float *)y, (float *)h1, S, H, hd, N, vec);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t ssd_step_nk(int nk, dim3 grid, size_t smem,
                               cudaStream_t st, const void *la,
                               const void *dtx, const void *Bf,
                               const void *Cf, const void *h0, void *y,
                               void *h1, int S, int H, int hd, int N,
                               int vec) {
  switch (nk) {
    case 1:
      return ssd_step_run<T, 1>(grid, smem, st, la, dtx, Bf, Cf, h0, y, h1,
                                S, H, hd, N, vec);
    case 2:
      return ssd_step_run<T, 2>(grid, smem, st, la, dtx, Bf, Cf, h0, y, h1,
                                S, H, hd, N, vec);
    case 4:
      return ssd_step_run<T, 4>(grid, smem, st, la, dtx, Bf, Cf, h0, y, h1,
                                S, H, hd, N, vec);
    default:
      return ssd_step_run<T, SSD_MAX_NK>(grid, smem, st, la, dtx, Bf, Cf,
                                         h0, y, h1, S, H, hd, N, vec);
  }
}

// S steps in one launch (S = 1: the decode step).  N up to
// 4 · 32 · SSD_MAX_NK = 1024 (ops.SSD_MAX_N); any hd, any S >= 0.
extern "C" int ssd_step_launch(const void *la, const void *dtx,
                               const void *Bf, const void *Cf,
                               const void *h0, void *y, void *h1, int B,
                               int S, int H, int hd, int N, int bf16,
                               void *stream) {
  if (N < 1 || N > 4 * 32 * SSD_MAX_NK || hd < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const int tpr = ssd_tpr(N);
  const int need = (N + 4 * tpr - 1) / (4 * tpr);
  const int nk = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const int rows = SSD_RPT * (SSD_THREADS / tpr);
  const dim3 grid((H * hd + rows - 1) / rows, B);
  // a block's rows span at most rows / hd + 2 heads
  const SsdSlot lay(rows / hd + 2, rows, N, bf16 ? 2 : 4);
  const size_t smem = (size_t)SSD_STAGES * lay.bytes;
  const int vec = N % 4 == 0 &&
                  (((uintptr_t)h0 | (uintptr_t)h1) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      bf16 ? ssd_step_nk<__nv_bfloat16>(nk, grid, smem, st, la, dtx, Bf, Cf,
                                        h0, y, h1, S, H, hd, N, vec)
           : ssd_step_nk<float>(nk, grid, smem, st, la, dtx, Bf, Cf, h0, y,
                                h1, S, H, hd, N, vec);
  return (int)e;
}
