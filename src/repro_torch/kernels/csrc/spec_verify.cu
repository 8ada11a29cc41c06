// Unkeyed verification of Alg. 1:
//   a_s = min(1, p_s(d_s) / q_s(d_s)), prefix = cumprod(u < a), n_acc,
//   then the residual token argmax_w log(U_w)/(p_w − q_w)_+ at slot
//   min(n_acc, K − 1) with that slot's host seed, and its U.  As in the
//   reference kernel, a row that accepts all K drafts still races slot
//   K − 1 (there is no bonus row here).
//
// Replaces: src/repro/kernels/spec_verify.py::spec_verify_kernel.
//
// Bound: bytes.  The accept test reads 2·K floats; the race reads one
// slot's p and q rows, 8·V bytes per row (the wrapper's inputs are the
// whole (B, K, V) p and q, 8·B·K·V bytes, 4 MB at B=4, K=4, V=32000:
// 1.2 us at 3.35 TB/s, but only one slot of each row is needed).  The
// first port ran one block per row: thread 0 walked the K accept tests as
// a chain of dependent loads, and only B of the 132 SMs raced.
//
// Design: spec_verify_wm.cu's race skeleton without the bonus row, the
// key chain, `seen` or `live`.  The launch shape comes from (B, V) alone
// (ops.spec_verify_split, the Gumbel race's ops.race_split with one block
// a row where that races in warp segments): `split` blocks race one row,
// a cluster when above 1.  Every member runs the accept test itself (warp
// 0 gathers the 2·K probabilities, 32 slots at a time, and a ballot finds
// the first rejected slot; member 0 writes n_acc and the prefix), races
// its race_bounds slice of the unnormalised (p − q)_+ straight from
// global memory (race_slice), and the members' winners go to member 0
// (cluster_merge), which writes the token and U.  The (score, index)
// merge is exact, so every split gives the same token and U bit for bit.
#include <cuda_runtime.h>

#include "cluster_tournament.cuh"

#define SV_MAX_CLUSTER 16   // the largest (non-portable) cluster

// The accept test of row b (warp 0; returned at every thread): the first
// rejected slot, K when every draft is accepted.  Writes n_acc and the
// prefix when `write`.
__device__ __forceinline__ int sv_accept(
    const float *__restrict__ p, const float *__restrict__ q,
    const long long *__restrict__ tokens, const float *__restrict__ u,
    long long b, int K, int V, bool write, long long *__restrict__ n_acc,
    long long *__restrict__ prefix) {
  __shared__ int s_nacc;
  if (threadIdx.x < 32) {
    int n = K;
    for (int base = 0; base < K; base += 32) {
      const int s = base + (int)threadIdx.x;
      bool ok = true;
      if (s < K) {
        const size_t row = (size_t)b * K + s;
        const long long d = tokens[row];
        const float pt = p[row * V + d];
        const float qt = q[row * V + d];
        ok = u[row] < fminf(1.0f, pt / fmaxf(qt, REPRO_EPS));
      }
      const unsigned rej = __ballot_sync(0xffffffffu, !ok);
      if (rej != 0u) {
        n = base + __ffs(rej) - 1;
        break;
      }
    }
    if (write) {
      for (int s = threadIdx.x; s < K; s += 32)
        prefix[(size_t)b * K + s] = s < n;
      if (threadIdx.x == 0) n_acc[b] = n;
    }
    if (threadIdx.x == 0) s_nacc = n;
  }
  __syncthreads();
  return s_nacc;
}

__global__ void __launch_bounds__(REPRO_THREADS)
spec_verify_kernel(const float *__restrict__ p, const float *__restrict__ q,
                   const long long *__restrict__ tokens,
                   const float *__restrict__ u,
                   const long long *__restrict__ seeds, int K, int V, int C,
                   long long *__restrict__ n_acc,
                   long long *__restrict__ prefix,
                   long long *__restrict__ rtok, float *__restrict__ ru) {
  __shared__ float s_best[SV_MAX_CLUSTER];
  __shared__ int s_idx[SV_MAX_CLUSTER];
  if (C > 1) ct_arrive();  // this member has started
  const long long b = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int n = sv_accept(p, q, tokens, u, b, K, V, rank == 0, n_acc, prefix);
  const size_t row = (size_t)b * K + (n < K - 1 ? n : K - 1);
  const uint32_t seed = (uint32_t)seeds[row];
  int lo, hi;
  race_bounds(V, C, rank, lo, hi);
  float best;
  int bi;
  race_slice(p + row * V, q + row * V, lo, hi, seed, best, bi);
  block_argmax(best, bi);
  if (C > 1) {
    ct_wait();  // every member has started: member 0 may be written
    bi = cluster_merge(best, bi, s_best, s_idx);
  }
  if (rank == 0 && threadIdx.x == 0) {
    rtok[b] = bi;
    ru[b] = prf_uniform(seed, (uint32_t)bi);
  }
}

// split: the blocks that race one row (a cluster when above 1, at most
// SV_MAX_CLUSTER).
extern "C" int spec_verify_launch(const void *p, const void *q,
                                  const void *tokens, const void *u,
                                  const void *seeds, int B, int K, int V,
                                  int split, void *n_acc, void *prefix,
                                  void *rtok, void *ru, void *stream) {
  if (split < 1 || split > SV_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  return ct_launch(spec_verify_kernel, B, split,
                   race_threads(V, split, REPRO_THREADS), 0,
                   (cudaStream_t)stream, (const float *)p, (const float *)q,
                   (const long long *)tokens, (const float *)u,
                   (const long long *)seeds, K, V, split,
                   (long long *)n_acc, (long long *)prefix,
                   (long long *)rtok, (float *)ru);
}
