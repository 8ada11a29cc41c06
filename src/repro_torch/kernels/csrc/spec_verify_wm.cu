// Fused watermarked verification tail of Alg. 1, one block per row:
//   a_s = min(1, p_s(d_s) / q_s(d_s)), prefix = cumprod(u < a), n_acc,
//   then one token from slot n_acc's row r = (p − q)_+ (r = p_K at the
//   bonus slot K, where q is taken as 0):
//   race       — Gumbel race over r with chain(chain(key, wm), ctx_slot),
//                or the plain stream's seed on a `seen` slot;
//   tournament — r normalised, m SynthID rounds, then a race with the draw
//                seed (argmax when degenerate); a `seen` slot races the
//                normalised row with the plain seed.  Emits the token's m
//                g-bits under the wm seed.
// Rows with live == 0 write zeros.
//
// Replaces: src/repro/kernels/spec_verify.py::spec_verify_wm_kernel
// (body _wm_kernel), both FusedTail kinds.
//
// Bound: the accept test reads 2·K floats; the tail reads the slot's p and
// q rows, 8·V bytes per row (1 MB at B=4, V=32000: 0.3 us at 3.35 TB/s).
// At serving shapes it is bound by launch latency.  Design: thread 0
// gathers the 2·K probabilities directly (no one-hot pass over K·V); the
// block then streams one row.  The tournament keeps the normalised row in
// dynamic shared memory when 4·V bytes fit (V=32000: 128 KB), else in a
// global scratch row the wrapper allocates (V=256128).  Only B of the 132
// SMs are busy; that is the first thing a later change should fix.
#include <cuda_runtime.h>

#include "prf.cuh"

struct VerifyArgs {
  const float *p;          // (B, K+1, V)
  const float *q;          // (B, K, V)
  const long long *tokens; // (B, K)
  const float *u;          // (B, K)
  const long long *keys;   // (B,)
  const long long *ctx;    // (B, K+1)
  const unsigned char *seen;  // (B, K+1)
  const unsigned char *live;  // (B,)
  float *scratch;          // (B, V) or null when the row fits shared memory
  long long *n_acc;        // (B,)
  long long *prefix;       // (B, K)
  long long *etok;         // (B,)
  float *estat;            // (B, stat_dim)
  int K, V, m, tournament, degenerate, stat_dim;
  uint32_t wm_stream, plain_resid, plain_bonus, draw_stream;
};

__global__ void __launch_bounds__(REPRO_THREADS)
spec_verify_wm_kernel(VerifyArgs a) {
  extern __shared__ float smem_row[];
  __shared__ int s_nacc;
  const int b = blockIdx.x, K = a.K, V = a.V, tid = threadIdx.x;
  const size_t K1 = (size_t)K + 1;

  if (!a.live[b]) {
    if (tid == 0) {
      a.n_acc[b] = 0;
      a.etok[b] = 0;
    }
    for (int s = tid; s < K; s += blockDim.x) a.prefix[(size_t)b * K + s] = 0;
    for (int s = tid; s < a.stat_dim; s += blockDim.x)
      a.estat[(size_t)b * a.stat_dim + s] = 0.f;
    return;
  }

  if (tid == 0) {
    int ok = 1, n = 0;
    for (int s = 0; s < K; ++s) {
      const long long d = a.tokens[(size_t)b * K + s];
      const float pt = a.p[((size_t)b * K1 + s) * V + d];
      const float qt = a.q[((size_t)b * K + s) * V + d];
      const float acc = fminf(1.0f, pt / fmaxf(qt, REPRO_EPS));
      ok = ok && (a.u[(size_t)b * K + s] < acc);
      a.prefix[(size_t)b * K + s] = ok;
      n += ok;
    }
    a.n_acc[b] = n;
    s_nacc = n;
  }
  __syncthreads();
  const int slot = s_nacc;

  const uint32_t key = (uint32_t)a.keys[b];
  const uint32_t ctx_s = (uint32_t)a.ctx[(size_t)b * K1 + slot];
  const bool seen_s = a.seen[(size_t)b * K1 + slot] != 0;
  const uint32_t pl_stream = slot == K ? a.plain_bonus : a.plain_resid;
  const uint32_t wm_s = seed_chain(seed_chain(key, a.wm_stream), ctx_s);
  const uint32_t pl_s = seed_chain(seed_chain(key, pl_stream), ctx_s);
  const float *ps = a.p + ((size_t)b * K1 + slot) * V;
  const float *qs = slot < K ? a.q + ((size_t)b * K + slot) * V : nullptr;

  if (!a.tournament) {
    const uint32_t seed = seen_s ? pl_s : wm_s;
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int w = tid; w < V; w += blockDim.x) {
      const float r = fmaxf(ps[w] - (qs ? qs[w] : 0.f), 0.f);
      arg_better(race_score(r, seed, (uint32_t)w), w, best, bi);
    }
    block_argmax(best, bi);
    if (tid == 0) {
      a.etok[b] = bi;
      a.estat[b] = prf_uniform(seed, (uint32_t)bi);
    }
    return;
  }

  // tournament: normalise r into the working row
  float *row = a.scratch ? a.scratch + (size_t)b * V : smem_row;
  float part = 0.f;
  for (int w = tid; w < V; w += blockDim.x) {
    const float r = fmaxf(ps[w] - (qs ? qs[w] : 0.f), 0.f);
    row[w] = r;
    part += r;
  }
  const float z = fmaxf(block_sum(part), REPRO_EPS);
  for (int w = tid; w < V; w += blockDim.x) row[w] = row[w] / z;

  int tok;
  if (seen_s) {
    tok = block_race(row, V, pl_s);       // raw normalised row, plain seed
  } else {
    block_tournament(row, V, a.m, wm_s);
    if (a.degenerate) {
      float best = -INFINITY;
      int bi = INT_MAX;
      for (int w = tid; w < V; w += blockDim.x) arg_better(row[w], w, best, bi);
      block_argmax(best, bi);
      tok = bi;
    } else {
      const uint32_t dw_s = seed_chain(seed_chain(key, a.draw_stream), ctx_s);
      tok = block_race(row, V, dw_s);
    }
  }
  if (tid == 0) a.etok[b] = tok;
  for (int l = tid; l < a.stat_dim; l += blockDim.x)
    a.estat[(size_t)b * a.stat_dim + l] =
        prf_gbit(wm_s, (uint32_t)tok + (uint32_t)V * (uint32_t)l);
}

// scratch == null selects the shared-memory row (smem_bytes = 4·V).
extern "C" int spec_verify_wm_launch(
    const void *p, const void *q, const void *tokens, const void *u,
    const void *keys, const void *ctx, const void *seen, const void *live,
    void *scratch, void *n_acc, void *prefix, void *etok, void *estat, int B,
    int K, int V, int m, int tournament, int degenerate, int stat_dim,
    unsigned int wm_stream, unsigned int plain_resid,
    unsigned int plain_bonus, unsigned int draw_stream, void *stream) {
  VerifyArgs a;
  a.p = (const float *)p;
  a.q = (const float *)q;
  a.tokens = (const long long *)tokens;
  a.u = (const float *)u;
  a.keys = (const long long *)keys;
  a.ctx = (const long long *)ctx;
  a.seen = (const unsigned char *)seen;
  a.live = (const unsigned char *)live;
  a.scratch = (float *)scratch;
  a.n_acc = (long long *)n_acc;
  a.prefix = (long long *)prefix;
  a.etok = (long long *)etok;
  a.estat = (float *)estat;
  a.K = K;
  a.V = V;
  a.m = m;
  a.tournament = tournament;
  a.degenerate = degenerate;
  a.stat_dim = stat_dim;
  a.wm_stream = wm_stream;
  a.plain_resid = plain_resid;
  a.plain_bonus = plain_bonus;
  a.draw_stream = draw_stream;
  const int smem = (tournament && scratch == nullptr) ? 4 * V : 0;
  cudaError_t e = allow_smem(spec_verify_wm_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  spec_verify_wm_kernel<<<B, REPRO_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
