// Shared helpers of the recurrent kernels (wkv, wkv_step, ssd, ssd_step):
// loads that upcast float32 or bfloat16 inputs to float32, as the TPU
// kernels' `.astype(jnp.float32)` does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float rec_ld(const float *p) { return *p; }
__device__ __forceinline__ float rec_ld(const __nv_bfloat16 *p) {
  return __bfloat162float(*p);
}
