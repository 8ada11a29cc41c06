// Fused watermarked verification tail of Alg. 1:
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
// (body _wm_kernel), both FusedTail kinds: the race as
// spec_verify_wm_kernel, the tournament as
// spec_verify_wm_tournament_kernel (two kernels, so their launches and
// device times are told apart).
//
// Race: bound by its bytes (the slot's p and q rows, 8·V bytes a row: 1 MB
// at B=4, V=32000, 0.3 us at 3.35 TB/s).  The first port ran one
// 1024-thread block per row, 4 of 132 SMs busy at B=4, each hashing,
// taking the logf and dividing for 32000 entries alone (17.6 us).  Now
// one row is split over a cluster of TAIL_CLUSTER blocks, on the
// tournament's skeleton: each member runs the accept test itself (warp 0
// gathers the 2·K probabilities directly, no one-hot pass over K·V;
// member 0 writes n_acc and the prefix), races its race_bounds slice of
// the unnormalised (p − q)_+ straight from global memory (race_slice,
// 16-byte loads) with the seen-or-wm seed, and the members' winners go to
// member 0 (cluster_merge), which writes the token and U.  The merge is
// exact, so the row's token equals a single block's bit for bit.  What
// bounds it (scripts/kernel_trace.py): the accept test's dependent loads
// (live flag, drafts, the gathered probabilities, the slot's words), the
// slice, and the merge's exchange between SMs, each 1.7-2.5 us at V=32000.
//
// Tournament: bound by operations (m·V g-bit hashes a row, and the m
// rounds of a row are serial: each needs the whole row's mass).  The
// first port ran it in one 1024-thread block per row, 4 of 132 SMs busy
// at B=4.  Now one row is split over a cluster of TAIL_CLUSTER = 8
// blocks, as tournament_keyed.cu does: each member runs the accept test
// itself (2·K gathered floats) and forms r over its slice of
// ct_slice in dynamic shared memory (128 KB at V=256128; past
// TAIL_SMEM_MAX in a global scratch row the wrapper allocates); the
// members' partial sums of r go to every member (cluster_sum) and are
// added in member order, so z is the same in every member bit for bit;
// cluster_tournament runs the rounds (st.async onto mbarriers, no
// cluster-wide barrier a round), then cluster_argmax or cluster_race
// draws the token at member 0, which writes the outputs.  A row's sums
// depend on V, the cluster size and the block size only, never on B or
// the SM count.  What bounds it: the 30 serial rounds of a block
// reduction and an exchange between SMs, plus two exchanges (z, the
// draw).
#include <cuda_runtime.h>

#include "cluster_tournament.cuh"

#define TAIL_CLUSTER 8               // blocks a row (race and tournament)
#define TAIL_SMEM_MAX (200 * 1024)   // a slice in shared memory up to this

struct VerifyArgs {
  const float *p;          // (B, K+1, V)
  const float *q;          // (B, K, V)
  const long long *tokens; // (B, K)
  const float *u;          // (B, K)
  const long long *keys;   // (B,)
  const long long *ctx;    // (B, K+1)
  const unsigned char *seen;  // (B, K+1)
  const unsigned char *live;  // (B,)
  float *scratch;          // (B, V), or null when a slice fits shared memory
  long long *n_acc;        // (B,)
  long long *prefix;       // (B, K)
  long long *etok;         // (B,)
  float *estat;            // (B, stat_dim)
  int K, V, m, tournament, degenerate, stat_dim;
  uint32_t wm_stream, plain_resid, plain_bonus, draw_stream;
};

// A dead row: zeros in every output (the block's threads).
__device__ __forceinline__ void dead_row(const VerifyArgs &a, int b) {
  if (threadIdx.x == 0) {
    a.n_acc[b] = 0;
    a.etok[b] = 0;
  }
  for (int s = threadIdx.x; s < a.K; s += blockDim.x)
    a.prefix[(size_t)b * a.K + s] = 0;
  for (int s = threadIdx.x; s < a.stat_dim; s += blockDim.x)
    a.estat[(size_t)b * a.stat_dim + s] = 0.f;
}

// The accept test of row b: warp 0 gathers the 2·K probabilities, 32
// slots at a time, and the first rejected slot is n_acc, the emitted
// slot; returned at every thread.  Writes n_acc and the prefix when
// `write`.
__device__ __forceinline__ int accept_test(const VerifyArgs &a, int b,
                                           bool write) {
  __shared__ int s_nacc;
  const int K = a.K, V = a.V;
  const size_t K1 = (size_t)K + 1;
  if (threadIdx.x < 32) {
    int n = K;
    for (int base = 0; base < K; base += 32) {
      const int s = base + (int)threadIdx.x;
      bool ok = true;
      if (s < K) {
        const long long d = a.tokens[(size_t)b * K + s];
        const float pt = a.p[((size_t)b * K1 + s) * V + d];
        const float qt = a.q[((size_t)b * K + s) * V + d];
        const float acc = fminf(1.0f, pt / fmaxf(qt, REPRO_EPS));
        ok = a.u[(size_t)b * K + s] < acc;
      }
      const unsigned rej = __ballot_sync(0xffffffffu, !ok);
      if (rej != 0u) {
        n = base + __ffs(rej) - 1;
        break;
      }
    }
    if (write) {
      for (int s = threadIdx.x; s < K; s += 32)
        a.prefix[(size_t)b * K + s] = s < n;
      if (threadIdx.x == 0) a.n_acc[b] = n;
    }
    if (threadIdx.x == 0) s_nacc = n;
  }
  __syncthreads();
  return s_nacc;
}

// The emitted slot's row and seeds.
struct TailRow {
  const float *ps, *qs;    // slot rows of p and q (qs null at the bonus)
  bool seen;
  uint32_t key, ctx, wm_s, pl_s;
};

__device__ __forceinline__ TailRow tail_row(const VerifyArgs &a, int b,
                                            int slot) {
  const int K = a.K, V = a.V;
  const size_t K1 = (size_t)K + 1;
  TailRow t;
  t.key = (uint32_t)a.keys[b];
  t.ctx = (uint32_t)a.ctx[(size_t)b * K1 + slot];
  t.seen = a.seen[(size_t)b * K1 + slot] != 0;
  const uint32_t pl_stream = slot == K ? a.plain_bonus : a.plain_resid;
  t.wm_s = seed_chain(seed_chain(t.key, a.wm_stream), t.ctx);
  t.pl_s = seed_chain(seed_chain(t.key, pl_stream), t.ctx);
  t.ps = a.p + ((size_t)b * K1 + slot) * V;
  t.qs = slot < K ? a.q + ((size_t)b * K + slot) * V : nullptr;
  return t;
}

// The race: one row over a cluster; member `rank` races the race_bounds
// slice [lo, hi) of the row.
__global__ void __launch_bounds__(REPRO_THREADS)
spec_verify_wm_kernel(VerifyArgs a) {
  __shared__ float s_best[TAIL_CLUSTER];
  __shared__ int s_idx[TAIL_CLUSTER];
  const int C = TAIL_CLUSTER, rank = blockIdx.x % C, b = blockIdx.x / C;
  if (!a.live[b]) {  // the whole cluster leaves together
    if (rank == 0) dead_row(a, b);
    return;
  }
  ct_arrive();  // this member has started
  const TailRow t = tail_row(a, b, accept_test(a, b, rank == 0));
  const uint32_t seed = t.seen ? t.pl_s : t.wm_s;
  int lo, hi;
  race_bounds(a.V, C, rank, lo, hi);
  float best;
  int bi;
  race_slice(t.ps, t.qs, lo, hi, seed, best, bi);
  block_argmax(best, bi);
  ct_wait();  // every member has started: member 0 may be written
  bi = cluster_merge(best, bi, s_best, s_idx);
  if (rank == 0 && threadIdx.x == 0) {
    a.etok[b] = bi;
    a.estat[b] = prf_uniform(seed, (uint32_t)bi);
  }
}

// The tournament: one row over a cluster; block `rank` holds the slice
// [lo, hi) of the row.
__global__ void __launch_bounds__(REPRO_THREADS)
spec_verify_wm_tournament_kernel(VerifyArgs a) {
  extern __shared__ float smem_row[];
  __shared__ ClusterTournamentShared sh;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C, V = a.V, tid = threadIdx.x;
  if (!a.live[b]) {            // the whole cluster leaves together
    if (rank == 0) dead_row(a, b);
    return;
  }
  const TailRow t = tail_row(a, b, accept_test(a, b, rank == 0));
  int lo, hi;
  ct_slice(V, C, rank, lo, hi);
  float *row = a.scratch ? a.scratch + (size_t)b * V + lo : smem_row;

  // r = (p − q)_+ over the slice, normalised by the row's sum
  float part = 0.f;
  for (int w = lo + tid; w < hi; w += blockDim.x) {
    const float r = fmaxf(t.ps[w] - (t.qs ? t.qs[w] : 0.f), 0.f);
    row[w - lo] = r;
    part += r;
  }
  const float z = fmaxf(cluster_sum(block_sum(part), sh), REPRO_EPS);
  for (int w = lo + tid; w < hi; w += blockDim.x)
    row[w - lo] = row[w - lo] / z;

  int tok;
  if (t.seen) {
    tok = cluster_race(row, lo, hi, t.pl_s, sh);  // normalised row, plain seed
  } else {
    cluster_tournament(row, lo, hi, V, a.m, t.wm_s, sh);
    if (a.degenerate) {
      tok = cluster_argmax(row, lo, hi, sh);
    } else {
      const uint32_t dw_s = seed_chain(seed_chain(t.key, a.draw_stream), t.ctx);
      tok = cluster_race(row, lo, hi, dw_s, sh);
    }
  }
  if (rank != 0) return;
  if (tid == 0) a.etok[b] = tok;
  for (int l = tid; l < a.stat_dim; l += blockDim.x)
    a.estat[(size_t)b * a.stat_dim + l] =
        prf_gbit(t.wm_s, (uint32_t)tok + (uint32_t)V * (uint32_t)l);
}

// The race: one cluster of TAIL_CLUSTER blocks per row, its slices read
// from p and q.  The tournament: one cluster of TAIL_CLUSTER blocks per
// row, each slice in shared memory (scratch == null) when
// 4 · ceil(V / TAIL_CLUSTER) <= TAIL_SMEM_MAX, else in scratch.
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
  cudaStream_t st = (cudaStream_t)stream;
  if (!tournament) {
    return ct_launch(spec_verify_wm_kernel, B, TAIL_CLUSTER,
                     race_threads(V, TAIL_CLUSTER, REPRO_THREADS), 0, st, a);
  }
  const int slice = (V + TAIL_CLUSTER - 1) / TAIL_CLUSTER;
  if (scratch == nullptr && 4 * slice > TAIL_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int smem = scratch == nullptr ? 4 * slice : 0;
  const int threads =
      slice >= REPRO_THREADS ? REPRO_THREADS : ((slice + 31) / 32) * 32;
  return ct_launch(spec_verify_wm_tournament_kernel, B, TAIL_CLUSTER,
                   threads > 0 ? threads : 32, smem, st, a);
}
