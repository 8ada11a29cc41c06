#!/usr/bin/env python3
"""Where a block's time goes in the paged-attention, keyed-tournament,
fused-tail (tournament and race), Gumbel race, unkeyed tournament,
unkeyed verify, SSD step, chunked SSD and WKV kernels, on one CUDA card.

    python3 scripts/kernel_trace.py

Builds a traced copy of ``csrc/paged_attention.cu``, of
``csrc/tournament_keyed.cu`` (with ``cluster_tournament.cuh``), of
``csrc/spec_verify_wm.cu`` (both kernels), of ``csrc/gumbel_argmax.cu``
(both kernels), of ``csrc/tournament.cu`` (its two register kernels), of
``csrc/spec_verify.cu``, of ``csrc/ssd_step.cu``, of ``csrc/ssd.cu`` and of
``csrc/wkv.cu`` into ``build/kernel_trace/``: thread 0 of every block
reads ``%globaltimer`` at the marks below.  Runs them at
``chip_smoke.PAGED_CASES`` (bf16), ``chip_smoke.TOURNAMENT_KEYED_SHAPES``,
the tail's tournament and race at the serving step's inputs (every row
live, no slot seen) at those shapes, the Gumbel race at
``chip_smoke.GUMBEL_ARGMAX_SHAPES`` in the launch shape the wrapper picks
(``ops.race_split``), the unkeyed tournament at
``chip_smoke.TOURNAMENT_SHAPES`` and the unkeyed verify at
``chip_smoke.SPEC_VERIFY_SHAPES`` in the wrappers' launch shapes
(``ops.tournament_shape``, ``ops.spec_verify_split``),
``chip_smoke.REC_CASES``' SSD step and scan
cases (float32) and its ``ssd`` and ``wkv`` cases that the tiled kernel
takes (float32 and bfloat16),
and prints one JSON line per case: the span of the launch, the median
life of a block, the quartiles of the blocks' start times (how many
waves), and the median time between consecutive marks; for ``ssd`` and
``wkv``, which loop over chunks or tiles, the median time of each phase
summed over the loop (kept in thread 0's registers, written once at the
end), and so for the unkeyed tournament's phases over its rounds.  The
traced copies only add the marks: their outputs must equal the product
kernels' bit for bit, and the script fails otherwise, or if a mark's
anchor is no longer in the source.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/kernel_trace"
MAX_BLOCKS = 8192

TRACE_DECL = r"""
__device__ unsigned long long trace_buf[8192 * 16];
extern "C" int trace_get(void *dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, trace_buf, (size_t)n * 8);
}
#define MARK(n)                                                              \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      const unsigned b_ =                                                    \
          blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);    \
      if (b_ < 8192) trace_buf[b_ * 16 + (n)] = t_;                          \
    }                                                                        \
  } while (0)
// phases inside a loop: ACC(n) adds the time since the last ACC (or
// TRACE_START) to thread 0's register sum n; TRACE_END() writes the sums
// to slots 1 .. 14 and the end time to slot 15
#define TRACE_START()                                                        \
  unsigned long long tl_ = 0, tacc_[15] = {};                                \
  if (threadIdx.x == 0) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tl_)); \
  MARK(0)
#define ACC(n)                                                               \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      unsigned long long t_;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                 \
      tacc_[n] += t_ - tl_;                                                  \
      tl_ = t_;                                                              \
    }                                                                        \
  } while (0)
#define TRACE_END()                                                          \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      const unsigned b_ =                                                    \
          blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);    \
      _Pragma("unroll") for (int n_ = 1; n_ < 15; ++n_)                     \
        if (b_ < 8192) trace_buf[b_ * 16 + n_] = tacc_[n_];                  \
    }                                                                        \
    MARK(15);                                                                \
  } while (0)
"""

# (mark, anchor): MARK(n) goes right after the anchor's text
PAGED_MARKS = [
    (0, "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"),
    (1, "issue_with(i, [&](int u, int, int, int) { return pre[i][u]; });\n"
        "  }\n"),
    (2, "    s_q[e] = x;\n  }\n"),
    (3, "        mo = nm;\n      }\n    }\n  }\n"),
    (4, "    l += s_xsum[c][warp] * expf(s_xmax[c][warp] - M);\n"),
    (5, "      *sp = round_to<T>(expf(*sp - M) / l);\n    }\n"),
    (6, "        for (int e = 0; e < PER; ++e) acc[u][e] = fmaf(pj, f[e], "
        "acc[u][e]);\n      }\n    }\n  }\n"),
    (7, "    *cluster.map_shared_rank(s_recv + rank * hd + o % hd, o / hd) = "
        "s;\n  }\n"),
    (8, "  cluster.sync();\n  // my row: the members' partials in member "
        "order\n"),
    (9, "      out[(((size_t)b * a.Sq + i) * a.H + h) * hd + d] = "
        "from_f<T>(s);\n    }\n  }\n"),
]
PAGED_PHASES = ["start, pages of the first tiles, copies issued",
                "q and the later pages staged", "pass one",
                "exchange of (m_c, l_c), cluster barrier",
                "probabilities of kept scores", "pass two",
                "partial outputs pushed", "cluster barrier", "output"]
TOURNAMENT_MARKS = [
    (0, "  const int lane = tid & 31, warp = tid >> 5, nw = NT >> 5;\n"),
    (1, "  cluster.sync();\n  uint64_t bits"),
    (2, "    bits = next;\n  }\n"),
]
TOURNAMENT_PHASES = ["mbarrier set-up, cluster barrier",
                     "round 0's bits, then the m rounds"]
TAIL_MARKS = [
    (0, "  const int b = blockIdx.x / C, V = a.V, tid = threadIdx.x;\n"),
    (1, "  ct_slice(V, C, rank, lo, hi);\n"),
    (2, "    row[w - lo] = row[w - lo] / z;\n"),
    (3, "    cluster_tournament(row, lo, hi, V, a.m, t.wm_s, sh);\n"),
    (4, "      tok = cluster_race(row, lo, hi, dw_s, sh);\n    }\n  }\n"),
]
TAIL_PHASES = ["accept test, seeds",
               "r over the slice, its sum over the cluster, normalise",
               "the m rounds", "the draw (race at member 0)"]
RACE_TAIL_MARKS = [
    (0, "  const int C = TAIL_CLUSTER, rank = blockIdx.x % C, b = blockIdx.x "
        "/ C;\n"),
    (1, "  const uint32_t seed = t.seen ? t.pl_s : t.wm_s;\n"),
    (2, "  race_slice(t.ps, t.qs, lo, hi, seed, best, bi);\n"),
    (3, "  bi = cluster_merge(best, bi, s_best, s_idx);\n"),
]
RACE_TAIL_PHASES = ["accept test, seeds",
                    "the slice: loads, hashes, logs, divisions",
                    "block argmax, cluster barrier's wait, merge at member 0"]
# the Gumbel race's two kernels (marks 0-2 in each; one runs a launch)
GUMBEL_MARKS = [
    (0, "  const int lane = (int)(g & (width - 1));\n"),
    (1, "      arg_better(race_score(row[w], seed, (uint32_t)w), w, best, "
        "bi);\n  }\n"),
    (2, "               __shfl_xor_sync(0xffffffffu, bi, o), best, bi);\n"),
    (0, "  const int b = blockIdx.x / C, rank = blockIdx.x % C;\n"),
    (1, "  race_slice(probs + (size_t)b * V, nullptr, lo, hi, seed, best, "
        "bi);\n"),
    (2, "    bi = cluster_merge(best, bi, s_best, s_idx);\n  }\n"),
]
GUMBEL_PHASES = {0: ["the segment's entries", "the shuffle argmax"],
                 1: ["the slice: loads, hashes, logs, divisions",
                     "block argmax (the row is the block's)"]}
GUMBEL_CLUSTER_PHASES = ["the slice: loads, hashes, logs, divisions",
                         "block argmax, cluster barrier's wait, merge at "
                         "member 0"]
# the unkeyed tournament's register kernels (csrc/tournament.cu): rows in
# warp segments and rows over a cluster, each a loop over the m rounds
# (ACC slots sum each phase over the rounds)
TOURNAMENT_U_MARKS = [
    ("TRACE_START();\n", "  const int lane = (int)(gt & (width - 1));\n"),
    ("ACC(1);\n", "    p[k] = b < B && w < V ? src[w] : 0.f;\n  }\n"),
    ("ACC(2);\n", "      if (word >> 31) mass += p[k];\n    }\n"),
    ("ACC(3);\n", "      if (o < width) mass += __shfl_xor_sync(0xffffffffu, "
     "mass, o);\n"),
    ("ACC(4);\n", "    for (int k = 0; k < PER; ++k) p[k] = p[k] * "
     "(tu_bit<PER>(g, k) ? f1 : f0);\n"),
    ("TRACE_END();\n", "    if (w < V) dst[w] = p[k];\n  }\n"),
    ("TRACE_START();\n",
     "  const long long b0 = (long long)(blockIdx.x / C) * R;\n"),
    ("ACC(1);\n", "      if (word >> 31) part[r] += p[r][k];\n    }\n"
     "  }\n"),
    ("ACC(2);\n", "    if (tid == 0) ct_mbar_expect(ct_smem(&sh.mbar[l & 1]), "
     "4 * C * R);\n"),
    ("ACC(3);\n", "          gn[r] = __funnelshift_l(tu_word(sx[r], y), gn[r], "
     "1);\n      }\n    }\n"),
    ("ACC(4);\n", "    while (!ct_mbar_try(ct_smem(&sh.mbar[l & 1]), "
     "(l >> 1) & 1)) {\n    }\n"),
    ("ACC(5);\n", "      g[r] = gn[r];\n    }\n"),
    ("TRACE_END();\n", "      if (w < hi) dst[w] = p[r][k];\n    }\n  }\n"),
]
TOURNAMENT_U_PHASES = {
    "cluster": ["loads, mbarrier set-up, cluster barrier, round 0's bits",
                "the block reduction and the send (st.async)",
                "hashing the next round's bits",
                "the exchange: waiting for the members' partials",
                "the mass (C partials) and the update"],
    "segments": ["loads", "hashing and the lane's mass",
                 "the segment's butterfly", "the update"]}
# the unkeyed verify (csrc/spec_verify.cu)
SPEC_VERIFY_MARKS = [
    (0, "  const int rank = blockIdx.x % C;\n"),
    (1, "  const int n = sv_accept(p, q, tokens, u, b, K, V, rank == 0, "
        "n_acc, prefix);\n"),
    (2, "  race_slice(p + row * V, q + row * V, lo, hi, seed, best, bi);\n"),
    (3, "  block_argmax(best, bi);\n"),
    (4, "    bi = cluster_merge(best, bi, s_best, s_idx);\n  }\n"),
]
SPEC_VERIFY_PHASES = ["accept test (warp 0's gathers and ballot), the "
                      "slot's seed",
                      "the slice: loads, hashes, logs, divisions",
                      "block argmax",
                      "cluster barrier's wait, merge at member 0"]
SSD_MARKS = [
    (0, "  const size_t bR = (size_t)b * HD;\n"),
    (1, "  for (int t = 0; t < SSD_STAGES - 1; ++t) issue(t);\n"),
    (2, '  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'),
    (3, "          if (col[k][v]) dst[v] = st[r][k][v];\n      }\n    }\n"
        "  }\n"),
]
SSD_PHASES = ["state loads and the ring's first steps issued",
              "the S steps (the first waits for the loads)",
              "the state written"]
# the chunked scan and the WKV sequence kernel loop over chunks / tiles:
# slot 0 is the start, ACC slots sum each phase over the loop (in thread
# 0's registers), slot 15 the end (a string is inserted as it is; an int n
# as MARK(n))
END = 15
SSD_CHUNK_MARKS = [
    ("TRACE_START();\n", "  const int g = lane >> 2, t4 = lane & 3;\n"),
    ("ACC(1);\n", "  load_bc(cs, Cf, 0, min(Lc, S));\n  ssd_commit();\n"),
    ("ACC(2);\n", "    __syncthreads();  // the chunk's inputs have landed\n"),
    ("ACC(3);\n", "      wj[i] = expf(tot - cum[i]);\n    }\n"),
    ("ACC(4);\n",
     "    ssd_cluster_wait();  // every W tile of the chunk is published\n"),
    ("ACC(5);\n", "    __syncthreads();       // every warp has read C and "
     "the state\n"),
    ("ACC(6);\n", "    __syncthreads();  // the state is updated; la, dtx and "
     "B are free\n"),
    ("TRACE_END();\n",
     "      hout[(bh * hd + d0 + r) * N + q] = hs[r * ld + q];\n"),
]
SSD_CHUNK_PHASES = ["zeros, h0, the first chunk's copies issued",
                    "the next copies issued and waited for",
                    "cumulative sum (warp scan), exp(cum), exp(tot - cum)",
                    "C.B^T tiles, decay, mask; cluster barrier (publish)",
                    "y: intra-chunk and carried products",
                    "the state pass"]
WKV_MARKS = [
    ("TRACE_START();\n", "  const int i0 = g * KPT;\n"),
    ("ACC(1);\n", "      if (cn < n_tiles) stage(cn);        // the barrier "
     "of tile c - 1\n"),
    ("ACC(2);\n", '"n"(WKV_STAGES - 1)\n                   : "memory");\n'),
    ("ACC(3);\n", "    __syncthreads();  // tile c has landed; the last "
     "reduction is done\n"),
    ("ACC(4);\n", "    __syncthreads();  // every partial of the tile is "
     "written\n"),
    ("ACC(5);\n", "      y[base + (size_t)(t0 + tt) * row + j0 + jj] = acc;"
     "\n    }\n"),
    ("TRACE_END();\n", "  for (int q = 0; q < KPT; ++q) sout[sbase + "
     "(size_t)(i0 + q) * HD] = s[q];\n"),
]
WKV_PHASES = ["the next tile's copies issued (before tile 0: the first "
              "tiles' copies and the state's loads)",
              "waiting for this tile's copies",
              "block barrier (the slowest thread's reduction)",
              "the walk (state update, partials of y) and its barrier",
              "the y reduction over key groups"]


def instrument(text: str, marks) -> str:
    for n, anchor in marks:
        if text.count(anchor) != 1:
            raise SystemExit(f"kernel_trace: anchor of mark {n} not found "
                             f"once: {anchor!r}")
        if isinstance(n, str):
            text = text.replace(anchor, f"{anchor}  {n}")
        elif anchor.endswith("uint64_t bits"):  # mark before the anchor's tail
            head = anchor[:-len("uint64_t bits")]
            text = text.replace(anchor, f"{head}MARK({n});\n  uint64_t bits")
        else:
            text = text.replace(anchor, f"{anchor}  MARK({n});\n")
    return text


def build_traced(name: str, source: Path, marks, header=None,
                 decl_after="namespace cg = cooperative_groups;\n"
                 ) -> ctypes.CDLL:
    """Compile a copy of ``source`` (or of its ``header``) with the marks
    into its own directory, the trace buffer declared after ``decl_after``
    (or after the header's prf.cuh include)."""
    from repro_torch.kernels import build
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    if header is None:
        if decl_after not in text:
            raise SystemExit(f"kernel_trace: {decl_after!r} not in {source}")
        text = text.replace(decl_after, decl_after + TRACE_DECL, 1)
        text = instrument(text, marks)
    else:
        hdr = (CSRC / header).read_text()
        hdr = hdr.replace("#include \"prf.cuh\"\n",
                          "#include \"prf.cuh\"\n" + TRACE_DECL, 1)
        (out / header).write_text(instrument(hdr, marks))
    cu = out / f"{name}.cu"
    cu.write_text(text)
    so = out / f"lib{name}.so"
    res = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-I", str(CSRC),
         "-shared", "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"kernel_trace: nvcc failed on {name}:\n"
                         f"{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("paged_attention_launch", "tournament_keyed_launch",
               "spec_verify_wm_launch", "gumbel_argmax_launch",
               "tournament_launch", "spec_verify_launch",
               "ssd_step_launch", "ssd_launch", "wkv_launch"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
    return lib


def report(lib, n_blocks: int, phases) -> dict:
    n = min(n_blocks, MAX_BLOCKS)
    buf = np.zeros(n * 16, dtype=np.uint64)
    if lib.trace_get(ctypes.c_void_p(buf.ctypes.data), n * 16):
        raise SystemExit("kernel_trace: reading the marks failed")
    t = buf.reshape(n, 16)[:, :len(phases) + 1].astype(np.int64)
    start = t[:, 0] - t[:, 0].min()
    return dict(
        span_us=float(t[:, -1].max() - t[:, 0].min()) / 1e3,
        block_life_us=float(np.median(t[:, -1] - t[:, 0])) / 1e3,
        start_quartiles_us=[float(np.quantile(start, x)) / 1e3
                            for x in (0.25, 0.5, 0.75, 1.0)],
        phases_us={p: float(np.median(t[:, i + 1] - t[:, i])) / 1e3
                   for i, p in enumerate(phases)})


def report_loop(lib, n_blocks: int, phases) -> dict:
    """As ``report`` for a kernel traced with ACC: slot 0 the start, slots
    1 .. len(phases) each phase summed over the loop, slot END the end."""
    n = min(n_blocks, MAX_BLOCKS)
    buf = np.zeros(n * 16, dtype=np.uint64)
    if lib.trace_get(ctypes.c_void_p(buf.ctypes.data), n * 16):
        raise SystemExit("kernel_trace: reading the marks failed")
    t = buf.reshape(n, 16).astype(np.int64)
    start = t[:, 0] - t[:, 0].min()
    return dict(
        span_us=float(t[:, END].max() - t[:, 0].min()) / 1e3,
        block_life_us=float(np.median(t[:, END] - t[:, 0])) / 1e3,
        start_quartiles_us=[float(np.quantile(start, x)) / 1e3
                            for x in (0.25, 0.5, 0.75, 1.0)],
        phases_us={p: float(np.median(t[:, i + 1])) / 1e3
                   for i, p in enumerate(phases)})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    build.load()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device: {smi}")
    pa = build_traced("paged_attention_traced", CSRC / "paged_attention.cu",
                      PAGED_MARKS)
    for name, B, Sq, H, Hkv, hd, ps, pos_range in cs.PAGED_CASES:
        args = cs.paged_inputs(B, Sq, H, Hkv, hd, ps, pos_range,
                               torch.bfloat16, seed=B * Sq * H)
        q, k, v, table, pos = args
        want = ops.paged_attention(*args)
        got = torch.empty_like(want)
        rc = pa.paged_attention_launch(
            ops._ptr(q), ops._ptr(k), ops._ptr(v), ops._ptr(table),
            ops._ptr(pos), ops._ptr(got), B, Sq, H, Hkv, hd, ps,
            table.shape[1], 0, 1, 1.0 / hd ** 0.5, ops._stream(q))
        torch.cuda.synchronize()
        if rc or not torch.equal(got, want):
            raise SystemExit(f"kernel_trace: traced paged {name} differs")
        n_blocks = -(-Sq * (H // Hkv) // 8) * 8 * Hkv * B
        print(json.dumps(dict(kernel="paged_attention", case=name,
                              **report(pa, n_blocks, PAGED_PHASES))))
    tk = build_traced("tournament_keyed_traced", CSRC / "tournament_keyed.cu",
                      TOURNAMENT_MARKS, header="cluster_tournament.cuh")
    for B, V in cs.TOURNAMENT_KEYED_SHAPES:
        probs, keys, ctx = cs.tournament_inputs(B, V)
        want, want_arg = ops.tournament_keyed(probs, keys, ctx, stream=0xD0,
                                              m=30)
        got, arg = torch.empty_like(want), torch.empty_like(want_arg)
        rc = tk.tournament_keyed_launch(
            ops._ptr(probs), ops._ptr(keys), ops._ptr(ctx), B, V, 30, 0xD0,
            ops._ptr(got), ops._ptr(arg), ops._stream(probs))
        torch.cuda.synchronize()
        if rc or not (torch.equal(got, want) and torch.equal(arg, want_arg)):
            raise SystemExit(f"kernel_trace: traced tournament B={B} V={V} "
                             "differs")
        print(json.dumps(dict(kernel="tournament_keyed", case=f"B={B} V={V}",
                              **report(tk, 8 * B, TOURNAMENT_PHASES))))
    trace_tail(cs, ops)
    trace_gumbel(cs, ops)
    trace_unkeyed(cs, ops)
    trace_ssd(cs, ops)
    trace_sequence(cs, ops)
    return 0


def trace_tail(cs, ops):
    """The fused tail's tournament and race at the serving step's inputs
    (every row live, no slot seen)."""
    import torch
    from repro_torch.core.watermark.base import FusedTail
    sv = build_traced("spec_verify_wm_traced", CSRC / "spec_verify_wm.cu",
                      TAIL_MARKS + RACE_TAIL_MARKS,
                      decl_after='#include "cluster_tournament.cuh"\n')
    tour = FusedTail(kind="tournament", m=30, stat_dim=30)
    for tail, kernel, phases in (
            (tour, "spec_verify_wm_tournament", TAIL_PHASES),
            (None, "spec_verify_wm", RACE_TAIL_PHASES)):
        m = tail.m if tail else 0
        for B, V in cs.TOURNAMENT_KEYED_SHAPES:
            args = cs.tail_inputs(B, V, tail, serving=True)
            want = ops.spec_verify_wm(*args, tail=tail)
            got = [torch.empty_like(w) for w in want]
            p, q, toks, u, keys, ctx, seen, live = args
            rc = sv.spec_verify_wm_launch(
                *(ops._ptr(x) for x in (p, q, toks, u, keys, ctx, seen,
                                        live)),
                ops._ptr(None), *(ops._ptr(x) for x in got), B, 4, V, m,
                int(tail is not None), 0, m or 1, *ops.DEFAULT_STREAMS,
                ops._stream(p))
            torch.cuda.synchronize()
            if rc or not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"kernel_trace: traced {kernel} B={B} "
                                 f"V={V} differs")
            print(json.dumps(dict(kernel=kernel, case=f"B={B} V={V}",
                                  **report(sv, 8 * B, phases))))


def trace_gumbel(cs, ops):
    """The Gumbel race at every phase 2 shape, in the wrapper's launch
    shape."""
    import torch
    ga = build_traced("gumbel_argmax_traced", CSRC / "gumbel_argmax.cu",
                      GUMBEL_MARKS,
                      decl_after='#include "cluster_tournament.cuh"\n')
    for B, V in cs.GUMBEL_ARGMAX_SHAPES:
        probs, seeds = cs.gumbel_inputs(B, V)
        want = ops.gumbel_argmax(probs, seeds)
        got = [torch.empty_like(w) for w in want]
        split = ops.race_split(B, V)
        rc = ga.gumbel_argmax_launch(
            ops._ptr(probs), ops._ptr(seeds), B, V, split,
            *(ops._ptr(x) for x in got), ops._stream(probs))
        torch.cuda.synchronize()
        if rc or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"kernel_trace: traced gumbel_argmax B={B} "
                             f"V={V} differs")
        if split == 0:
            width = min(32, 1 << (V - 1).bit_length())
            n_blocks = -(-B * width // 256)    # GA_SEG_THREADS
        else:
            n_blocks = B * split
        phases = (GUMBEL_CLUSTER_PHASES if split > 1 else
                  GUMBEL_PHASES[split])
        print(json.dumps(dict(kernel="gumbel_argmax", case=f"B={B} V={V}",
                              split=split,
                              **report(ga, n_blocks, phases))))


def trace_unkeyed(cs, ops):
    """The unkeyed tournament at every phase 2 shape and the unkeyed
    verify at every phase 2 shape, in the wrappers' launch shapes."""
    import torch
    tu = build_traced("tournament_traced", CSRC / "tournament.cu",
                      TOURNAMENT_U_MARKS,
                      decl_after='#include "cluster_tournament.cuh"\n')
    for B, V in cs.TOURNAMENT_SHAPES:
        probs, seeds = cs.tournament_unkeyed_inputs(B, V)
        want = ops.tournament(probs, seeds, m=30)
        got = torch.empty_like(want)
        C, NT = ops.tournament_shape(V)
        R = ops.tournament_rows(B, V)
        rc = tu.tournament_launch(ops._ptr(probs), ops._ptr(seeds), B, V, V,
                                  30, NT, R, ops._ptr(got),
                                  ops._stream(probs))
        torch.cuda.synchronize()
        if rc or not torch.equal(got, want):
            raise SystemExit(f"kernel_trace: traced tournament B={B} V={V} "
                             "differs")
        if C == 0:                              # NT: lanes a segment
            n_blocks, kind = -(-(-(-B // R)) * NT // 256), "segments"
        else:
            n_blocks, kind = -(-B // R) * C, "cluster"
        print(json.dumps(dict(
            kernel="tournament", case=f"B={B} V={V}", shape=[C, NT, R],
            **report_loop(tu, n_blocks, TOURNAMENT_U_PHASES[kind]))))
        del want, got
    sv = build_traced("spec_verify_traced", CSRC / "spec_verify.cu",
                      SPEC_VERIFY_MARKS,
                      decl_after='#include "cluster_tournament.cuh"\n')
    for B, K, V in cs.SPEC_VERIFY_SHAPES:
        args = cs.spec_verify_unkeyed_inputs(B, K, V)
        want = ops.spec_verify(*args)
        got = [torch.empty_like(w) for w in want]
        split = ops.spec_verify_split(B, V)
        rc = sv.spec_verify_launch(*(ops._ptr(x) for x in args), B, K, V,
                                   split, *(ops._ptr(x) for x in got),
                                   ops._stream(args[0]))
        torch.cuda.synchronize()
        if rc or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"kernel_trace: traced spec_verify B={B} K={K} "
                             f"V={V} differs")
        print(json.dumps(dict(kernel="spec_verify", case=f"B={B} K={K} V={V}",
                              split=split,
                              **report(sv, B * split, SPEC_VERIFY_PHASES))))


def trace_ssd(cs, ops):
    """The SSD step kernel at phase 2c's decode step and scans (float32)."""
    import torch
    sk = build_traced("ssd_step_traced", CSRC / "ssd_step.cu", SSD_MARKS,
                      decl_after='#include "recurrent.cuh"\n')
    for i, (name, kernel, shape) in enumerate(cs.REC_CASES):
        if kernel not in ("ssd_step", "ssd_scan"):
            continue
        args = cs.rec_inputs(kernel, shape, torch.float32, seed=i + 1)
        want = getattr(ops, kernel)(*args)
        got = [torch.empty_like(w) for w in want]
        la, dtx, Bf, Cf, h0 = args
        B, H, hd, N = h0.shape
        S = shape.get("S", 1)
        rc = sk.ssd_step_launch(
            *(ops._ptr(x) for x in (la, dtx, Bf, Cf, h0, *got)), B, S, H,
            hd, N, 0, ops._stream(la))
        torch.cuda.synchronize()
        if rc or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"kernel_trace: traced {name} differs")
        tpr = min(32, 1 << max(0, (-(-N // 4) - 1).bit_length()))
        rows = 2 * 128 // tpr
        rep = report(sk, -(-H * hd // rows) * B, SSD_PHASES)
        rep["us_per_step"] = rep["phases_us"][SSD_PHASES[1]] / S
        print(json.dumps(dict(kernel="ssd_step", case=name, S=S, **rep)))



def trace_sequence(cs, ops):
    """The chunked SSD scan and the WKV sequence kernel at phase 2c's ssd
    and wkv cases, float32 and bfloat16."""
    import torch
    libs = {"ssd": build_traced("ssd_traced", CSRC / "ssd.cu",
                                SSD_CHUNK_MARKS,
                                decl_after='#include "recurrent.cuh"\n'),
            "wkv": build_traced("wkv_traced", CSRC / "wkv.cu", WKV_MARKS,
                                decl_after='#include "recurrent.cuh"\n')}
    for i, (name, kernel, shape) in enumerate(cs.REC_CASES):
        if kernel not in libs or "chunk" in shape:   # the tiled ssd only
            continue
        lib = libs[kernel]
        for dtype in (torch.float32, torch.bfloat16):
            args = cs.rec_inputs(kernel, shape, dtype, seed=i + 1)
            bf16 = int(dtype == torch.bfloat16)
            if kernel == "ssd":
                want = ops.ssd(*args, chunk=cs.REC_CHUNK)
                B, S, H, hd = args[1].shape
                N = args[2].shape[-1]
                extra = (B, S, H, hd, N, min(cs.REC_CHUNK, S), bf16)
                n_blocks = -(-hd // 32) * H * B   # ssd.cu's SSD_DT rows
                phases = SSD_CHUNK_PHASES
            else:
                want = ops.wkv(*args)
                B, S, H, hd = args[0].shape
                extra = (B, S, H, hd, bf16)
                n_blocks = hd // 16 * H * B       # wkv.cu's WKV_JT
                phases = WKV_PHASES
            got = [torch.empty_like(w) for w in want]
            launch = getattr(lib, kernel + "_launch")
            rc = launch(*(ops._ptr(x) for x in (*args, *got)), *extra,
                        ops._stream(args[0]))
            torch.cuda.synchronize()
            if rc or not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"kernel_trace: traced {name} differs")
            print(json.dumps(dict(kernel=kernel, case=name,
                                  dtype=str(dtype)[6:], S=S,
                                  **report_loop(lib, n_blocks, phases))))


if __name__ == "__main__":
    sys.exit(main())
