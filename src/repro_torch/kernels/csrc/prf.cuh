// Counter PRF and block reductions shared by the port's Hopper kernels.
//
// The integer program is the one of repro_torch/core/prf.py (and of the
// reference's Pallas kernels): words are uint32_t, so every product wraps
// mod 2^32 natively.  Built without --use_fast_math: logf, the division
// of the race score and the float sums then follow IEEE rules, and a
// kernel agrees with its plain PyTorch version up to the last bit of logf.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#define REPRO_THREADS 1024
#define REPRO_EPS 1e-30f

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// one link of the key -> stream -> context seed chain (prf._chain)
__device__ __forceinline__ uint32_t seed_chain(uint32_t seed, uint32_t ctr) {
  return hash_u32((seed * 0x9E3779B9u) ^ hash_u32(ctr));
}

// U(0,1): 24 hash bits times 2^-24 plus 2^-25 (the product is exact, so a
// contracted FMA rounds the same way as the two-step form)
__device__ __forceinline__ float prf_uniform(uint32_t seed, uint32_t ctr) {
  return (float)(seed_chain(seed, ctr) >> 8) * (1.0f / 16777216.0f) +
         (1.0f / 33554432.0f);
}

__device__ __forceinline__ float prf_gbit(uint32_t seed, uint32_t ctr) {
  return (float)(seed_chain(seed, ctr) >> 31);
}

// Gumbel-race score log(U_w)/P_w; zero-mass tokens never win
__device__ __forceinline__ float race_score(float p, uint32_t seed,
                                            uint32_t w) {
  return p > 0.f ? logf(prf_uniform(seed, w)) / fmaxf(p, REPRO_EPS)
                 : -INFINITY;
}

// (score, index) order of jnp.argmax: larger score wins, ties go to the
// smaller index, so an all -inf row yields index 0
__device__ __forceinline__ void arg_better(float s2, int i2, float &s,
                                           int &i) {
  if (s2 > s || (s2 == s && i2 < i)) {
    s = s2;
    i = i2;
  }
}

// Block-wide argmax; every thread returns with the block's winner.
// Must be reached by all threads of the block.
__device__ __forceinline__ void block_argmax(float &s, int &i) {
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  for (int o = 16; o > 0; o >>= 1)
    arg_better(__shfl_xor_sync(0xffffffffu, s, o),
               __shfl_xor_sync(0xffffffffu, i, o), s, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_s[warp] = s;
    red_i[warp] = i;
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  s = lane < nw ? red_s[lane] : -INFINITY;
  i = lane < nw ? red_i[lane] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1)
    arg_better(__shfl_xor_sync(0xffffffffu, s, o),
               __shfl_xor_sync(0xffffffffu, i, o), s, i);
  __syncthreads();  // red_* may be reused by the next call
}

// Block-wide float sum; every thread returns with the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel k, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}
