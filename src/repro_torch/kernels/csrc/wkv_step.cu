// One RWKV6 WKV decode step, state in / state out: for each (row b, head
// h), with the (hd x hd) state S (key i, value j),
//
//   y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//   S'_ij = w_i S_ij + k_i v_j          (written to a new state buffer)
//
// r, k, v (B, H, hd) and u (H, hd) in float32 or bfloat16 (upcast on
// load), w (B, H, hd) float32, the state float32.  y is float32.
//
// Replaces: src/repro/kernels/wkv.py::wkv_step_kernel (every decode step
// of an RWKV6 draft or target, one launch per layer).
//
// Design (head sizes 16, 32, 64, 128, one instantiation each; no spills
// at any): grid (H, B), one block of hd threads per (b, h); thread j owns
// value column j of the state and walks the key axis i = 0..hd-1 in order,
// reading row i of the state (hd consecutive floats across the block: one
// coalesced load per i) and writing row i of the new state.  r, k, u and w
// sit in shared memory (every thread reads element i of each); v_j in a
// register.  The products and sums are the plain version's, rounded one
// operation at a time (__fmul_rn / __fadd_rn, no contraction into FMAs),
// so the new state equals ref.wkv_step_ref bit for bit and y differs only
// in the order of its sum over i.
//
// Bound: bytes.  It must read the state and write the new one, 2 * 4 *
// hd^2 bytes per (b, h): at rwkv6-3b's B=8, H=40, hd=64 that is 10.5 MB,
// 3.1 us at 3.35 TB/s, against 5 * hd^2 float operations per (b, h)
// (0.16 us at 67 TFLOP/s).  B * H blocks of 64 threads (320 at B=8) keep
// few loads in flight per SM: unrolled loads and wider blocks are the
// first speed work.
#include "recurrent.cuh"

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv_step_kernel(const T *__restrict__ r, const T *__restrict__ k,
                const T *__restrict__ v, const float *__restrict__ w,
                const T *__restrict__ u, const float *__restrict__ s0,
                float *__restrict__ y, float *__restrict__ s1, int H) {
  __shared__ float rs[HD], ks[HD], ws[HD], us[HD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t vec = ((size_t)b * H + h) * HD;
  rs[j] = rec_ld(r + vec + j);
  ks[j] = rec_ld(k + vec + j);
  ws[j] = w[vec + j];
  us[j] = rec_ld(u + (size_t)h * HD + j);
  const float vj = rec_ld(v + vec + j);
  __syncthreads();
  const float *sin = s0 + vec * HD;
  float *sout = s1 + vec * HD;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < HD; ++i) {
    const float s = sin[i * HD + j];
    const float kv = __fmul_rn(ks[i], vj);
    const float x = __fadd_rn(s, __fmul_rn(us[i], kv));
    acc = __fadd_rn(acc, __fmul_rn(x, rs[i]));
    sout[i * HD + j] = __fadd_rn(__fmul_rn(ws[i], s), kv);
  }
  y[vec + j] = acc;
}

template <typename T>
static int launch(const void *r, const void *k, const void *v,
                  const void *w, const void *u, const void *s0, void *y,
                  void *s1, int B, int H, int hd, cudaStream_t st) {
  const dim3 grid(H, B);
#define WKV_STEP_CASE(HDV)                                                   \
  case HDV:                                                                  \
    wkv_step_kernel<T, HDV><<<grid, HDV, 0, st>>>(                           \
        (const T *)r, (const T *)k, (const T *)v, (const float *)w,          \
        (const T *)u, (const float *)s0, (float *)y, (float *)s1, H);        \
    break;
  switch (hd) {
    WKV_STEP_CASE(16)
    WKV_STEP_CASE(32)
    WKV_STEP_CASE(64)
    WKV_STEP_CASE(128)
  default:
    return (int)cudaErrorInvalidValue;
  }
#undef WKV_STEP_CASE
  return (int)cudaGetLastError();
}

extern "C" int wkv_step_launch(const void *r, const void *k, const void *v,
                               const void *w, const void *u, const void *s0,
                               void *y, void *s1, int B, int H, int hd,
                               int bf16, void *stream) {
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s1, B, H, hd,
                                 (cudaStream_t)stream);
  return launch<float>(r, k, v, w, u, s0, y, s1, B, H, hd,
                       (cudaStream_t)stream);
}
