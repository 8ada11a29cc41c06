// One Mamba2 SSD decode step, state in / state out: for each (row b, head
// h), with the (hd x N) state h,
//
//   h'_dn = exp(la) h_dn + dtx_d B_n        (written to a new state buffer)
//   y_d   = sum_n h'_dn C_n
//
// la (B, H) float32; dtx (B, H, hd), B and C (B, N) in float32 or
// bfloat16 (upcast on load); the state float32; y (B, H, hd) float32.
//
// Replaces: src/repro/kernels/ssd.py::ssd_step_kernel (every decode step
// of a Mamba2 or Zamba2 model, one launch per layer; on the card also the
// per-timestep sequence path, one launch per timestep).
//
// Design: grid (H, B), 8 warps per block; warp w takes state rows d = w,
// w + 8, ...; lane l takes columns n = l, l + 32, ... of a row, so a row is
// read and written in coalesced 128-byte lines.  B and C sit in shared
// memory.  The update is the plain version's, rounded one operation at a
// time (__fmul_rn / __fadd_rn, expf as torch.exp), so the new state
// equals ref.ssd_step_ref; y is multiply then sum over n, reduced by a
// shuffle tree (another order than the plain version's sum).
//
// Bound: bytes.  It must read the state and write the new one, 2 * 4 * hd
// * N bytes per (b, h): at zamba2-1.2b's B=4, H=64, hd=N=64 that is 8.4 MB,
// 2.5 us at 3.35 TB/s, against 5 * hd * N float operations per (b, h).
#include "recurrent.cuh"

#define SSD_STEP_WARPS 8

template <typename T>
__global__ void __launch_bounds__(SSD_STEP_WARPS * 32)
ssd_step_kernel(const float *__restrict__ la, const T *__restrict__ dtx,
                const T *__restrict__ Bf, const T *__restrict__ Cf,
                const float *__restrict__ h0, float *__restrict__ y,
                float *__restrict__ h1, int H, int hd, int N) {
  extern __shared__ float bc[];  // B (N), then C (N)
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bc[n] = rec_ld(Bf + (size_t)b * N + n);
    bc[N + n] = rec_ld(Cf + (size_t)b * N + n);
  }
  __syncthreads();
  const size_t bh = (size_t)b * H + h;
  const float a = expf(la[bh]);
  for (int d = warp; d < hd; d += SSD_STEP_WARPS) {
    const float x = rec_ld(dtx + bh * hd + d);
    const size_t rowo = (bh * hd + d) * N;
    float acc = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float hn =
          __fadd_rn(__fmul_rn(a, h0[rowo + n]), __fmul_rn(x, bc[n]));
      h1[rowo + n] = hn;
      acc = __fadd_rn(acc, __fmul_rn(hn, bc[N + n]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0)
      y[bh * hd + d] = acc;
  }
}

extern "C" int ssd_step_launch(const void *la, const void *dtx,
                               const void *Bf, const void *Cf,
                               const void *h0, void *y, void *h1, int B,
                               int H, int hd, int N, int bf16,
                               void *stream) {
  const dim3 grid(H, B);
  const size_t smem = 2 * (size_t)N * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    ssd_step_kernel<__nv_bfloat16><<<grid, SSD_STEP_WARPS * 32, smem, st>>>(
        (const float *)la, (const __nv_bfloat16 *)dtx,
        (const __nv_bfloat16 *)Bf, (const __nv_bfloat16 *)Cf,
        (const float *)h0, (float *)y, (float *)h1, H, hd, N);
  else
    ssd_step_kernel<float><<<grid, SSD_STEP_WARPS * 32, smem, st>>>(
        (const float *)la, (const float *)dtx, (const float *)Bf,
        (const float *)Cf, (const float *)h0, (float *)y, (float *)h1, H,
        hd, N);
  return (int)cudaGetLastError();
}
