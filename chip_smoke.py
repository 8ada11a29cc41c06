#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure, in this order:
  1. device: the card's name and power limit; build the kernels with nvcc;
  2. every kernel against its plain PyTorch version on the card, at the
     serving shapes (B=4, K=4, m=30, V=32000 and V=256128), with the
     race, the tournament and the degenerate tail, mixed seen / live rows
     and mixed keys (the race also at B=8), each row alone equal to the
     same row in the batch; the Gumbel race also at B=1 and 8 (every
     launch shape, each row alone equal to its batch's); the keyed
     tournament also at B=8 (two emulated
     faults at B=4, V=32000: m − 1 rounds, another context); the unkeyed
     tournament at B=4 and V=32000, (8, 4096),
     the Monte-Carlo shape (16384, 32000) and a Fig. 1 chunk (20000, 10),
     whose tolerance must also see two emulated faults (m − 1 rounds, a
     wrong seed row), rows alone and the first 4 rows as a batch equal to
     the batch's, and at both Monte-Carlo shapes one row expanded to
     the batch (row stride 0) equal to its contiguous copy; the unkeyed
     verify at (4, 4, 32000), (8, 4, 4096) and (4, 1, 32000), a p = q
     row giving token 0, rows alone equal to the batch's; the tournament
     tail at the serving step's shape (B=8, every row live, no slot
     seen), each row alone equal to it in the batch;
     times of kernel, plain version and bound;
  2b. the paged-attention kernel against its plain version at the
     target-verify, prefill-chunk, draft and TINY GQA shapes, a kimi-like
     GQA verify (hd 112, page size 12), a gemma-like one (hd 256) and a
     4096-position row, in bf16 and
     fp32, with shuffled pages, null tails and a FREE row, each bf16
     element within its rounding bound (which must also catch an
     off-by-one mask and a wrong page); times of kernel, plain version,
     bound and an SDPA yardstick;
  2c. the four recurrent kernels (wkv, wkv_step, ssd, ssd_step) against
     their plain versions at the rwkv6-3b and zamba2-1.2b serving shapes
     and the WKV kernels at head size 128, and the ssd_step kernel's
     per-timestep scan (one launch a call) over zamba2-1.2b prompts of
     16, 64 and 128 tokens,
     bf16 and fp32 inputs, every output (y and the state) within its
     rounding bound, which must also see three emulated faults, the WKV
     state bit for bit, and each row of the wkv and ssd batches alone
     equal to the batch's; times of kernel, plain version and bound (the
     chunked scan's at the TF32 tensor-core rate its tiled kernel runs
     at); the chunked scan also at two (hd, N, chunk) whose chunk only
     its scalar kernel holds (ops.ssd_kernel_for), its launches counted
     apart;
  3. the dense Algorithm 1 slice at full width: LLAMA_7B target and
     LLAMA_68M draft in bf16 (random weights from a seed), B=4, prompt 16,
     32 tokens, K=4, temperature 0.7, for gumbel, synthid and synthid-inf;
     the launch counts of that run show it went through the kernels (the
     repeat and fused="off" checks of synthid-inf run INF_CHECK_TOKENS);
  3b. continuous batching at full width: the same pair through
     serve_requests over the paged pool (8 slots, page 16, chunk 32,
     prefix cache), 16 requests submitted at once, gumbel and synthid;
     requests/s, tokens/s, TTFT, gaps, pages, launch counts, a trace;
     then the same requests through a Scheduler that times its parts (a
     separate run: its synchronizes stay out of the timed one);
  3c. recurrent drafting at full width: LLAMA_7B with rwkv6-3b (vocab
     32000) and zamba2-1.2b drafts, bf16, ssm.chunk 128: generate (B=4,
     prompt 200, 24 tokens; gumbel and synthid for RWKV6, gumbel for
     Zamba2), paged serve_requests with RWKV6 (12 requests, 8 slots, no
     prefix cache) and dense serve_requests with Zamba2 (6 requests, 4
     slots); ms per step, kernels per step, idle share, draft state bytes,
     launch counts per path;
  (the traces of phases 3, 3b and 3c are windows of each cell's own load:
     PROFILE_TOKENS more tokens continuing a finished generate, or
     TRACE_ROUNDS sync rounds of serving (3c: REC_PROFILE_TOKENS and
     REC_TRACE_ROUNDS) once every slot holds a request
     and a first request has finished);
  4. the TINY pair in fp32, generate on the CPU (plain versions) against
     generate on the card (kernels);
  4b. the TINY pair in fp32, serve_requests (dense and paged) on the CPU
     against the card, and served against solo generate on the card;
  4c. TINY_TARGET with the smoke-size RWKV6 and Zamba2 drafts in fp32:
     generate and serve_requests (paged RWKV6, dense Zamba2) on the CPU
     against the card, and served against solo on the card;
  5. the paper's measures (run in main() before the target is freed):
     Def. 3.1 strength of the LLAMA_7B target's next-token distribution
     (V=32000) for gumbel, synthid and synthid-inf at 16384 contexts, and
     the card against the CPU at 2048 / 256 / 256; Fig. 1's linear, Hu
     and Google curves of gumbel and synthid at the reference's defaults
     (200,000 contexts, 33 γ, 33 θ), and the card against the CPU at 4000
     contexts and 9 γ; tiered serve_requests of the TINY pair through a
     synthid StrengthController with its curve computed on the card,
     against the CPU; detection records and scores of a TINY generate
     against the CPU's (AUCs printed, not gated); the micro-benchmark's
     calls of the race, the unkeyed tournament and the unkeyed verify;
     launch counts of each path;
  6. training (after the 7B target is freed): the differentiable
     recurrences' gradients (the kernel forward, the plain version
     replayed backward) against autograd through the plain versions at
     rwkv6-3b's and zamba2-1.2b's layer shapes (B=2, S=256; the scan at
     S=64), within ref.replay_grad_tol; zamba2-1.2b at full width in fp32,
     3 train steps at B=2, S=256 (losses and gradient norms finite, every
     parameter moved, 38 ssd launches a step; ms per step, tokens/s, peak
     memory); 5 fit steps of the yi-6b, rwkv6-3b and zamba2-1.2b smoke
     configs on the card against the CPU, each loss within
     TRAIN_LOSS_RTOL; benchmarks/common.py's pair trained 300 steps
     through repro_torch.train.pair into artifacts/ (the loss must fall)
     and its Gumbel K=4 AATPS beside the untrained pair's;
  7. streaming (run right after 3b, on its models): phase 3b's 16
     requests through engine.serve_stream with overlap on, gumbel and
     synthid, the pool sized for the doubled page-growth horizon:
     streamed tokens equal the drained results, which equal phase 3b's
     (overlap off) bit for bit (tokens, src, u, context hashes);
     device_get runs once a sync round; the pool drains; requests/s,
     tokens/s, TTFT and p95 gap printed beside phase 3b's, and for gumbel
     host syncs a round and the idle share in a traced window beside
     phase 3b's window;
  7b. (after 6) python -m repro_torch.launch.serve on a JSONL replay
     (stream, overlap, paged, prefix cache, key pool, a tier line) and
     without --requests, and python -m repro_torch.examples.tradeoff_curves
     and .quickstart (phase 6's pair from its cache), four processes at
     once: each exits 0 and prints its report lines;
  9. multi-device serving (after 8, once its models are freed): (a) one
     NCCL rank in this process, LLAMA_7B + LLAMA_68M in bf16 through
     generate(mesh=1x1, shard_params=True), bit for bit equal to the same
     run without a mesh; (b) two spawned ranks sharing the card over gloo,
     the TINY pair in fp32 on meshes 2x1 and 1x2 (generate gumbel and
     synthid, serve_requests dense and paged) against the unsharded runs
     on the card, outside counted margin rows, every kernel of each path
     launched on each rank; (c) the same ranks, LLAMA_7B + LLAMA_68M in
     bf16 tensor-parallel over 1x2 (generate, B=4, prompt 16, 16 tokens,
     gumbel and synthid): every row reaches its length, the first
     verify's logits within MESH_LOGIT_RTOL of the unsharded run's; rows
     equal to the end, ms per step, collectives and MB per step and peak
     memory per rank printed.
It prints a `kernels` JSON line, the card's line, and last a JSON line
{"ok": true, "device": {...}}.  It imports neither JAX nor the JAX
package, and exits non-zero without a result where there is no CUDA card
or no repro_torch package beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
DEV = "cuda"                 # rehearsals on the CPU set "cpu"
SMI = ""                     # the card's name and power limit (main sets it)
MARGIN_TOL = 1e-5            # race margin under which a token may flip
DIST_RTOL, DIST_ATOL = 1e-4, 1e-7   # tournament distributions (sum order)
# scalar operations per element, counted for the bound (int and float
# alike, against the float32 rate): a hash is 8, a seed-chain link 18
OPS_UNIFORM = 21             # chain + shift, convert, fma
OPS_RACE = OPS_UNIFORM + 3   # + log, divide, compare
OPS_ROUND = 18 + 1 + 2 + 3   # g-bit + mass multiply-add + update


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def call_ms(fn, reps: int = 30) -> float:
    """Median wall time of one call, host work included (CUDA events
    around each call, after a warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, kernel: str = "") -> float:
    """Device time of one call.  With ``kernel``: the median duration of
    that kernel's launches over ``reps`` calls.  Without: the summed self
    time of every kernel the profiler saw on the card, per call.  Falls
    back to CUDA events around back-to-back calls where the profiler
    reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    if kernel:
        own = [e.self_device_time_total for e in prof.events()
               if kernel in e.name and e.self_device_time_total > 0]
        if own:
            return statistics.median(own) / 1e3
    us = sum(e.self_device_time_total for e in prof.key_averages())
    if us > 0:
        return us / reps / 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def timings(kernel, kernel_fn, plain_fn):
    """ms: the kernel's median device time; plain_ms: the plain version's
    device time per call; and the median wall time of one call each."""
    return dict(ms=device_ms(kernel_fn, kernel=kernel),
                plain_ms=device_ms(plain_fn, 5),
                call_ms=call_ms(kernel_fn), plain_call_ms=call_ms(plain_fn, 5))


def bound_ms(nbytes: float, nops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def verify_inputs(B, K, V, seed, serving=False):
    """p, q with some agreement (so acceptance varies), drafts from q,
    mixed keys, seen and live rows; with ``serving`` every row live and no
    slot seen (the serving step's slots, each drawing a fresh token)."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV
    lp = torch.randn((B, K + 1, V), generator=g, device=dev) * 3
    lq = lp[:, :K] + torch.randn((B, K, V), generator=g, device=dev)
    p = torch.softmax(lp, -1)
    q = torch.softmax(lq, -1)
    toks = torch.multinomial(q.reshape(B * K, V), 1, generator=g).reshape(B, K)
    u = torch.rand((B, K), generator=g, device=dev)
    u[0] = 0.0                      # row 0 accepts all: the bonus slot
    keys = torch.randint(0, 2**32, (B,), generator=g, device=dev)
    ctx = torch.randint(0, 2**32, (B, K + 1), generator=g, device=dev)
    seen = torch.rand((B, K + 1), generator=g, device=dev) < 0.3
    seen[1] = True                  # row 1: the plain stream everywhere
    live = torch.ones(B, dtype=torch.bool, device=dev)
    live[2] = False
    if serving:
        seen[:] = False
        live[:] = True
    return p, q, toks, u, keys, ctx, seen, live


def tail_cases():
    """(name, B, V, tail, serving) of phase 2's fused-tail checks: the race,
    the tournament and the degenerate tail at B=4 and both vocabularies
    (mixed seen / live rows), and at the serving shape the race (mixed
    seen / live rows) and the tournament (every row live, none seen)."""
    from repro_torch.core.watermark.base import FusedTail
    cases = []
    for V in (32000, 256128):
        cases.append((f"spec_verify_wm race V={V}", 4, V, None, False))
        for degen in (False, True):
            cases.append((
                f"spec_verify_wm_tournament{' degen' if degen else ''} V={V}",
                4, V, FusedTail(kind="tournament", m=30, stat_dim=30,
                                degenerate=degen), False))
    B, V = TAIL_SERVING_SHAPE
    cases.append((f"spec_verify_wm race B={B} V={V}", B, V, None, False))
    cases.append((f"spec_verify_wm_tournament serving B={B} V={V}", B, V,
                  FusedTail(kind="tournament", m=30, stat_dim=30), True))
    return cases


def tail_inputs(B, V, tail, serving):
    """A fused-tail case's inputs (K=4), the same in every checkout."""
    return verify_inputs(B, 4, V, seed=V + (tail.m if tail else 0) + B - 4,
                         serving=serving)


def check_spec_verify(name, B, V, tail, serving, streams, record):
    """ops.spec_verify_wm against its plain version: n_acc and the prefix
    bitwise, the token outside margin rows (counted), its U or g-bits
    bitwise, and every row alone equal to the same row in the batch, bit
    for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    K = 4
    args = tail_inputs(B, V, tail, serving)
    p, q, toks, u, keys, ctx, seen, live = args
    kn = ops.spec_verify_wm(*args, streams=streams, tail=tail)
    torch.cuda.synchronize()
    kind = tail.kind if tail else "race"
    m = tail.m if tail else 0
    degen = bool(tail and tail.degenerate)
    pl = ref.spec_verify_wm_ref(*args, streams=streams, kind=kind, m=m,
                                degenerate=degen)
    n_acc_k, pre_k, tok_k, st_k = kn
    n_acc_r, pre_r, tok_r, st_r = pl
    check(torch.equal(n_acc_k, n_acc_r), f"{name}: n_acc {n_acc_k} {n_acc_r}")
    check(torch.equal(pre_k, pre_r), f"{name}: prefix")
    # the emitted token: equal outside the race margin
    r, seen_s, wm_s, pl_s, dw_s = ref.tail_rows(
        p, q, n_acc_r, keys, ctx, seen, streams=streams)
    if kind == "race":
        scores, _ = ref.race_scores(r, torch.where(seen_s, pl_s, wm_s))
    else:
        rn = r / torch.clamp_min(r.sum(-1, keepdim=True), ref.EPS)
        pz = ref.tournament_rounds(rn, wm_s, m)
        scores, _ = ref.race_scores(torch.where(seen_s[:, None], rn, pz),
                                    torch.where(seen_s, pl_s, dw_s))
        if degen:
            scores = torch.where(seen_s[:, None], scores, pz)
    marg = ref.margin(scores)
    in_margin = live & (marg < MARGIN_TOL)
    same = tok_k == tok_r
    check(bool((same | in_margin).all()),
          f"{name}: tokens {tok_k.tolist()} vs {tok_r.tolist()}, "
          f"margins {marg.tolist()}")
    rows = same & live
    if kind == "race":
        err = float((st_k - st_r)[rows].abs().max()) if rows.any() else 0.0
        check(err == 0.0, f"{name}: U[token] differs by {err}")
    else:
        check(torch.equal(st_k[rows], st_r[rows]), f"{name}: g-bits differ")
        err = 0.0
    check(bool((tok_k[~live] == 0).all() and (n_acc_k[~live] == 0).all()),
          f"{name}: dead rows not zero")
    for b in range(B):
        alone = ops.spec_verify_wm(*(x[b:b + 1] for x in args),
                                   streams=streams, tail=tail)
        check(all(torch.equal(x[0], y[b]) for x, y in zip(alone, kn)),
              f"{name}: row {b} alone differs from the batch")
    times = timings(
        "spec_verify_wm_tournament_kernel" if kind == "tournament" else
        "spec_verify_wm_kernel",
        lambda: ops.spec_verify_wm(*args, streams=streams, tail=tail),
        lambda: ref.spec_verify_wm_ref(*args, streams=streams, kind=kind,
                                       m=m, degenerate=degen))
    # the work this data needs: every row reads its live flag and writes
    # its outputs; a live row also reads its drafts, coins, the 2K gathered
    # probabilities, key, contexts, seen flags and the emitted slot's rows
    # of p and q (no q row at the bonus slot); the tournament's m rounds
    # run only on unseen rows
    stat_dim = m or 1
    nbytes = B * (1 + 8 + 8 * K + 8 + 4 * stat_dim)
    nops = 0.0
    for b in range(B):
        if not bool(live[b]):
            continue
        slot = int(n_acc_r[b])
        nbytes += (8 * K + 4 * K + 8 * K + 8 + 9 * (K + 1)
                   + 4 * V * (1 if slot == K else 2))
        if kind == "race":
            nops += V * (OPS_RACE + 2)
        else:
            nops += V * 4 + V * OPS_RACE
            if not bool(seen_s[b]):
                nops += m * V * OPS_ROUND
    bnd, by = bound_ms(nbytes, nops)
    record.append(dict(case=name, margin_rows=int(in_margin.sum()),
                       max_abs_err=err, **times,
                       bound_ms=bnd, bound_by=by))


def gumbel_inputs(B, V):
    """Rows (B, V) with a spread of peaks, row 3 all zero where B > 3
    (token 0, U[0]), and seed words, the same in every checkout."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(V if B == 4 else B + V)
    probs = torch.softmax(torch.randn((B, V), generator=g,
                                      device=DEV) * 3, -1)
    if B > 3:
        probs[3] = 0.0
    seeds = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    return probs, seeds


# rows of a Monte-Carlo batch checked alone against the batch (all rows
# of a serving batch are)
ALONE_ROWS = 8


def alone_rows(B):
    """The rows of a batch of B that are run alone: every row up to
    ALONE_ROWS, else ALONE_ROWS spread over the batch, the last included."""
    if B <= ALONE_ROWS:
        return list(range(B))
    return [b * (B - 1) // (ALONE_ROWS - 1) for b in range(ALONE_ROWS)]


def check_gumbel_argmax(B, V, record):
    """ops.gumbel_argmax against its plain version: tokens equal outside
    margin rows (counted), U[token] bitwise, an all-zero row gives 0, and
    rows alone (``alone_rows``; a row alone takes another launch shape
    than a large batch) equal to the batch's, token and U bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    probs, seeds = gumbel_inputs(B, V)
    tk, uk = ops.gumbel_argmax(probs, seeds)
    tr, ur = ref.gumbel_argmax_ref(probs, seeds)
    scores, _ = ref.race_scores(probs, seeds)
    marg = ref.margin(scores)
    in_margin = marg < MARGIN_TOL
    same = tk == tr
    name = f"gumbel_argmax B={B} V={V}"
    check(bool((same | in_margin).all()),
          f"{name}: {int((~same & ~in_margin).sum())} tokens differ "
          f"outside margin rows")
    check(B <= 3 or int(tk[3]) == 0,
          "gumbel_argmax: all-zero row must give token 0")
    err = float((uk - ur)[same].abs().max())
    check(err == 0.0, f"{name}: U differs by {err}")
    for b in alone_rows(B):
        ta, ua = ops.gumbel_argmax(probs[b:b + 1], seeds[b:b + 1])
        check(torch.equal(ta[0], tk[b]) and torch.equal(ua[0], uk[b]),
              f"{name}: row {b} alone differs from the batch")
    times = timings("gumbel_argmax",
                    lambda: ops.gumbel_argmax(probs, seeds),
                    lambda: ref.gumbel_argmax_ref(probs, seeds))
    bnd, by = bound_ms(4 * B * V + 8 * B + 12 * B, B * V * OPS_RACE)
    record.append(dict(case=name, margin_rows=int(in_margin.sum()),
                       max_abs_err=err, split=ops.race_split(B, V),
                       **times, bound_ms=bnd, bound_by=by))


# the keyed tournament's shapes: the draft's rows at the micro-benchmark's
# B=4 and at the serving batch of 8, at both vocabularies
TOURNAMENT_KEYED_SHAPES = ((4, 32000), (8, 32000), (4, 256128),
                           (8, 256128))


def tournament_inputs(B, V):
    """Normalised rows (B, V) with a spread of peaks, key words and
    context hashes for the keyed tournament."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(V + 1 if B == 4 else B + V)
    probs = torch.softmax(torch.randn((B, V), generator=g,
                                      device=DEV) * 3, -1)
    keys = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    ctx = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    return probs, keys, ctx


def check_tournament(B, V, record):
    """ops.tournament_keyed against its plain version: the distribution
    within DIST_RTOL / DIST_ATOL, the argmax equal outside margin rows
    (counted); at B=4, V=32000 also two emulated faults (m − 1 rounds,
    another context hash), each of which the tolerance must see."""
    import torch
    from repro_torch.core import prf
    from repro_torch.kernels import ops, ref
    m = 30
    probs, keys, ctx = tournament_inputs(B, V)
    stream = prf.STREAM_DRAFT
    name = f"tournament_keyed B={B} V={V}"
    dk, ak = ops.tournament_keyed(probs, keys, ctx, stream=stream, m=m)
    torch.cuda.synchronize()
    dr, ar = ref.tournament_keyed_ref(probs, keys, ctx, stream=stream, m=m)
    err = float((dk - dr).abs().max())
    ratio = tol_ratio(dk, dr)
    check(ratio <= 1.0, f"{name}: max abs err {err}, {ratio} tolerances")
    marg = ref.margin(dr)
    in_margin = marg < MARGIN_TOL
    check(bool(((ak == ar) | in_margin).all()),
          f"{name}: argmax {ak.tolist()} vs {ar.tolist()}")
    faults = {}
    if (B, V) == TOURNAMENT_KEYED_SHAPES[0]:
        for fault, kw in (("m-1 rounds", dict(ctx_hashes=ctx, m=m - 1)),
                          ("wrong context", dict(ctx_hashes=ctx ^ 1, m=m))):
            bad = ref.tournament_keyed_ref(probs, keys, stream=stream,
                                           **kw)[0]
            faults[fault] = tol_ratio(dk, bad)
            check(faults[fault] > 1.0,
                  f"{name}: the tolerance does not see the fault {fault}")
        del bad
    del dr
    times = timings(
        "tournament_keyed_kernel",
        lambda: ops.tournament_keyed(probs, keys, ctx, stream=stream, m=m),
        lambda: ref.tournament_keyed_ref(probs, keys, ctx, stream=stream,
                                         m=m))
    bnd, by = bound_ms(8 * B * V + 24 * B, B * V * m * OPS_ROUND)
    record.append(dict(case=name, margin_rows=int(in_margin.sum()),
                       max_abs_err=err, err_over_tol=ratio,
                       fault_over_tol=faults, **times, bound_ms=bnd,
                       bound_by=by))


# the unkeyed tournament's shapes: the table's and the micro-benchmark's
# (B=4, V=32000), the micro-benchmark's (8, 4096), the Monte-Carlo engine
# of Def. 3.1 strength (16384 contexts at V=32000) and one chunk of the
# Fig. 1 curves (20000 contexts at V=10)
TOURNAMENT_SHAPES = ((4, 32000), (8, 4096), (16384, 32000), (20000, 10))
# the Gumbel race's: the served rows (B=1, 4 and 8 at V=32000, B=4 at
# V=256128) and the same two Monte-Carlo shapes (gumbel's modified_dist)
GUMBEL_ARGMAX_SHAPES = ((4, 32000), (1, 32000), (8, 32000), (4, 256128),
                        (16384, 32000), (20000, 10))
SPEC_VERIFY_SHAPES = ((4, 4, 32000), (8, 4, 4096), (4, 1, 32000))
# the fused tail at the dense-draft serving step's 8 slots (K=4, m=30):
# the tournament with every slot live and drawing a fresh token, the race
# with mixed seen and live rows
TAIL_SERVING_SHAPE = (8, 32000)


def tol_ratio(got, want, rtol=DIST_RTOL, atol=DIST_ATOL) -> float:
    """max |got − want| / (atol + rtol·|want|): allclose holds iff <= 1."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def tournament_unkeyed_inputs(B, V):
    """Normalised rows (B, V) with a spread of peaks and seed words for the
    unkeyed tournament, the same in every checkout."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(B + V + 2)
    probs = torch.softmax(torch.randn((B, V), generator=g,
                                      device=DEV) * 3, -1)
    seeds = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    return probs, seeds


def check_tournament_unkeyed(B, V, record):
    """ops.tournament against its plain version; at the table's shape also
    two emulated faults (m − 1 rounds, the seed row shifted by one), each
    of which the tolerance must see.  Rows alone (``alone_rows``) and, in a
    larger batch, its first 4 rows as a batch of 4 equal the batch's bit
    for bit (the launch shape comes from V alone); at the Monte-Carlo
    shapes (B >= 16384) also one row expanded to (B, V), as
    ``modified_dist`` hands it over (read at row stride 0), equal to its
    contiguous copy."""
    import torch
    from repro_torch.kernels import ops, ref
    m = 30
    probs, seeds = tournament_unkeyed_inputs(B, V)
    got = ops.tournament(probs, seeds, m=m)
    torch.cuda.synchronize()
    want = ref.tournament_ref(probs, seeds, m=m)
    err = float((got - want).abs().max())
    ratio = tol_ratio(got, want)
    name = f"tournament B={B} V={V}"
    check(ratio <= 1.0, f"{name}: max abs err {err}, {ratio} tolerances")
    faults = {}
    if (B, V) == TOURNAMENT_SHAPES[0]:
        for fault, bad in (
                ("m-1 rounds", ref.tournament_ref(probs, seeds, m=m - 1)),
                ("wrong seed row", ref.tournament_ref(probs, seeds.roll(1),
                                                      m=m))):
            faults[fault] = tol_ratio(got, bad)
            check(faults[fault] > 1.0,
                  f"{name}: the tolerance does not see the fault {fault}")
        del bad
    del want
    for b in alone_rows(B):
        check(torch.equal(ops.tournament(probs[b:b + 1], seeds[b:b + 1],
                                         m=m)[0], got[b]),
              f"{name}: row {b} alone differs from the batch")
    if B > 4:
        check(torch.equal(ops.tournament(probs[:4], seeds[:4], m=m),
                          got[:4]),
              f"{name}: its first 4 rows as a batch differ from the batch")
    extra = {}
    if B >= 16384:
        one = probs[B // 2].expand(B, V)
        check(torch.equal(ops.tournament(one, seeds, m=m),
                          ops.tournament(one.contiguous(), seeds, m=m)),
              f"{name}: one row at row stride 0 differs from its copy")
        extra = dict(
            one_row_ms=device_ms(lambda: ops.tournament(one, seeds, m=m),
                                 kernel="tournament"),
            one_row_bound_ms=bound_ms(4 * V + 4 * B * V + 8 * B,
                                      B * V * m * OPS_ROUND)[0])
        del one
    times = timings("tournament",
                    lambda: ops.tournament(probs, seeds, m=m),
                    lambda: ref.tournament_ref(probs, seeds, m=m))
    bnd, by = bound_ms(8 * B * V + 8 * B, B * V * m * OPS_ROUND)
    record.append(dict(case=name, max_abs_err=err, err_over_tol=ratio,
                       fault_over_tol=faults,
                       shape=list(ops.tournament_shape(V)), **extra,
                       **times, bound_ms=bnd, bound_by=by))


def spec_verify_unkeyed_inputs(B, K, V):
    """p, q (B, K, V), drafts, coins and seed words of the unkeyed verify,
    the same in every checkout: row 0 accepts every draft (slot K − 1
    still races); the last row (B >= 2) has p = q, so it accepts every
    draft and races an all-zero residual (token 0)."""
    p, q, toks, u, _, ctx, _, _ = verify_inputs(B, K, V, seed=B * K + V)
    p, seeds = p[:, :K].contiguous(), ctx[:, :K].contiguous()
    if B >= 2:
        p[-1] = q[-1]
    return p, q, toks, u, seeds


def check_spec_verify_unkeyed(B, K, V, record):
    """ops.spec_verify against its plain version: n_acc and the prefix
    bitwise, the residual token outside margin rows, its U bitwise, the
    p = q row's token 0, and rows alone (``alone_rows``) equal to the
    batch's, every output bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    p, q, toks, u, seeds = spec_verify_unkeyed_inputs(B, K, V)
    nk, pk, tk, uk = ops.spec_verify(p, q, toks, u, seeds)
    torch.cuda.synchronize()
    nr, pr, tr, ur = ref.spec_verify_ref(p, q, toks, u, seeds)
    name = f"spec_verify B={B} K={K} V={V}"
    check(torch.equal(nk, nr) and torch.equal(pk, pr),
          f"{name}: n_acc {nk.tolist()} vs {nr.tolist()} or prefix")
    check(int(nk[0]) == K, f"{name}: row 0 must accept all K drafts")
    check(B < 2 or (int(nk[-1]) == K and int(tk[-1]) == 0),
          f"{name}: the p = q row must accept all and give token 0")
    rows = torch.arange(B, device=DEV)
    slot = nr.clamp_max(K - 1)
    r = (p[rows, slot] - q[rows, slot]).clamp_min(0.0)
    marg = ref.margin(ref.race_scores(r, seeds[rows, slot])[0])
    in_margin = marg < MARGIN_TOL
    same = tk == tr
    check(bool((same | in_margin).all()),
          f"{name}: tokens {tk.tolist()} vs {tr.tolist()}")
    err = float((uk - ur)[same].abs().max())
    check(err == 0.0, f"{name}: U differs by {err}")
    for b in alone_rows(B):
        alone = ops.spec_verify(p[b:b + 1], q[b:b + 1], toks[b:b + 1],
                                u[b:b + 1], seeds[b:b + 1])
        check(all(torch.equal(x[0], y[b])
                  for x, y in zip(alone, (nk, pk, tk, uk))),
              f"{name}: row {b} alone differs from the batch")
    times = timings("spec_verify_kernel",
                    lambda: ops.spec_verify(p, q, toks, u, seeds),
                    lambda: ref.spec_verify_ref(p, q, toks, u, seeds))
    # the work this data needs: every row reads its drafts, coins, seeds
    # and the 2K gathered probabilities, then one slot's rows of p and q,
    # and writes n_acc, the prefix, the token and its U
    nbytes = B * (8 * K + 4 * K + 8 * K + 8 * K + 8 * V + 8 + 8 * K + 12)
    bnd, by = bound_ms(nbytes, B * V * (OPS_RACE + 2))
    record.append(dict(case=name, margin_rows=int(in_margin.sum()),
                       max_abs_err=err, split=ops.spec_verify_split(B, V),
                       **times, bound_ms=bnd, bound_by=by,
                       all_inputs_bound_ms=8 * B * K * V / HBM_BYTES_PER_S
                       * 1e3))


def phase_kernels():
    from repro_torch.kernels import ops
    record = []
    for B, V in TOURNAMENT_SHAPES:
        check_tournament_unkeyed(B, V, record)
    for B, K, V in SPEC_VERIFY_SHAPES:
        check_spec_verify_unkeyed(B, K, V, record)
    for B, V in GUMBEL_ARGMAX_SHAPES:
        check_gumbel_argmax(B, V, record)
    for B, V in TOURNAMENT_KEYED_SHAPES:
        check_tournament(B, V, record)
    for case in tail_cases():
        check_spec_verify(*case, ops.DEFAULT_STREAMS, record)
    for r in record:
        print("kernel-check " + json.dumps(r))
    return record


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

# 32 tokens, 16 requests in 3b: the script's time limit holds phase 9 too
SLICE = dict(B=4, prompt=16, n_tokens=32, K=4, temperature=0.7)
# synthid-inf's repeat and fused="off" runs are cut to this many tokens
# (held against the first run's prefix: slots are isolated, so a shorter
# run's tokens are the longer run's first ones) to keep the script inside
# its time limit; gumbel and synthid check all n_tokens
INF_CHECK_TOKENS = 16
# spec_verify_wm_tournament: the fused tail's tournament branch, counted
# apart from its race branch (one CUDA kernel, spec_verify_wm_kernel)
DENSE_KERNELS = ("spec_verify_wm", "spec_verify_wm_tournament",
                 "gumbel_argmax", "tournament_keyed")
KERNEL_NAMES = DENSE_KERNELS + ("paged_attention",)
RECURRENT_KERNELS = ("wkv", "wkv_step", "ssd", "ssd_step")
SCHEMES = ("gumbel", "synthid", "synthid-inf")
# a traced generate window: this many tokens continuing the timed run's
# final state (decode steps at the cell's batch, no prefill inside)
PROFILE_TOKENS = 12
# a traced serving window: this many sync rounds at the cell's load
TRACE_ROUNDS = 3


def make_pair():
    """LLAMA_7B target and LLAMA_68M draft in bf16, random weights from
    seeds 0 and 1, on the card (shared by phases 3 and 3b)."""
    import torch
    from repro_torch.configs import LLAMA_7B, LLAMA_68M
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    target = init_params(LLAMA_7B, seed=0, dtype=torch.bfloat16, device=DEV)
    draft = init_params(LLAMA_68M, seed=1, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    print(f"slice: weights made in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return target, draft


def phase_slice(target, draft):
    """LLAMA_7B / LLAMA_68M in bf16 on the card; returns the launch counts
    of the fused runs and the per-scheme timings."""
    import dataclasses
    import torch
    from repro_torch.configs import LLAMA_7B
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E
    g = torch.Generator(device="cpu").manual_seed(7)
    prompts = torch.randint(1, LLAMA_7B.vocab, (SLICE["B"], SLICE["prompt"]),
                            generator=g).numpy()
    keys = [0x1234, 0xDEADBEEF, 7, 2**31 + 5]      # a mixed-key batch
    n = SLICE["n_tokens"]
    results, counts = {}, {k: 0 for k in ops.LAUNCHES}
    for wm in SCHEMES:
        scfg = E.SpecConfig(K=SLICE["K"], watermark=wm,
                            temperature=SLICE["temperature"])
        E.generate(target, draft, scfg, prompts[:, :4], n_tokens=6,
                   key=keys)                             # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        r1 = E.generate(target, draft, scfg, prompts, n_tokens=n, key=keys)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            counts[k] += v
        m = INF_CHECK_TOKENS if wm == "synthid-inf" else n
        r2 = E.generate(target, draft, scfg, prompts, n_tokens=m, key=keys)
        r_off = E.generate(target, draft,
                           dataclasses.replace(scfg, fused="off"),
                           prompts, n_tokens=m, key=keys)
        # the last step may commit up to K tokens past the target, as in
        # the reference
        check(bool(((r1.lengths >= n) & (r1.lengths <= n + SLICE["K"])).all()),
              f"{wm}: lengths {r1.lengths}")
        toks = r1.tokens[:, :n]
        check(bool(((toks >= 0) & (toks < LLAMA_7B.vocab)).all()),
              f"{wm}: token out of range")
        check(0.0 <= r1.aatps <= SLICE["K"], f"{wm}: aatps {r1.aatps}")
        check(bool(((r1.y_target >= 0) & (r1.y_target <= 1)).all()),
              f"{wm}: statistics outside [0, 1]")
        check(bool((r1.tokens[:, :m] == r2.tokens[:, :m]).all()),
              f"{wm}: two runs with one key differ")
        check(bool((r1.tokens[:, :m] == r_off.tokens[:, :m]).all()),
              f"{wm}: fused tail and fused='off' tail differ")
        results[wm] = dict(
            seconds=secs, n_steps=r1.n_steps, n_syncs=r1.n_syncs,
            ms_per_step=secs / r1.n_steps * 1e3,
            tokens_per_s=float(r1.lengths.sum()) / secs,
            aatps=r1.aatps, launches=launches,
            profile=profile_generate(lambda: E.generate(
                target, draft, scfg, prompts, n_tokens=PROFILE_TOKENS,
                key=keys, state=r1.state)))
        print(f"slice {wm}: " + json.dumps(results[wm]))
    check(all(counts[k] > 0 for k in DENSE_KERNELS),
          f"a kernel of the path was never launched: {counts}")
    return counts, results


class TraceWindow:
    """A trace of the card from start() to stop(): wall time, device busy
    time (the union of the intervals of every kernel, copy and fill on the
    card), the device's idle share, device operations per spec step, host
    syncs (every operation that waits for the card warns once while the
    window is open) and the kernels that take the most device time.  The
    trace is read back from the profiler's raw events: grouping thousands
    of kernels per step through ``key_averages`` takes far longer than the
    traced run."""

    def __init__(self):
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._warn = warnings.catch_warnings(record=True)
        self._caught = self._warn.__enter__()
        warnings.simplefilter("always")
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.set_sync_debug_mode("warn")
        self._t = time.perf_counter()

    def stop(self, n_steps: int, **extra):
        import torch
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t
        t_read = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self._warn.__exit__(None, None, None)
        syncs = sum("synchroniz" in str(w.message) for w in self._caught)
        evs = sorted((e.start_ns(), e.end_ns(), e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA")
                     and e.duration_ns() > 0)
        self.prof = None
        busy_ns, edge = 0, None
        by_name = {}
        for a, b, name in evs:
            if edge is None or a >= edge:
                busy_ns += b - a
                edge = b
            elif b > edge:
                busy_ns += b - edge
                edge = b
            tot, cnt = by_name.get(name, (0, 0))
            by_name[name] = (tot + b - a, cnt + 1)

        def share(kernels):
            return sum(t for k, (t, _) in by_name.items()
                       if any(f"{n}_kernel" in k for n in kernels))
        busy_ms = busy_ns / 1e6
        top = sorted(((t, c, k) for k, (t, c) in by_name.items()),
                     reverse=True)[:8]
        return dict(
            wall_ms=wall * 1e3, device_busy_ms=busy_ms,
            device_idle_share=1.0 - busy_ms / (wall * 1e3),
            n_steps=n_steps, ms_per_step=wall * 1e3 / max(n_steps, 1),
            device_ms_per_step=busy_ms / max(n_steps, 1),
            kernels_per_step=len(evs) / max(n_steps, 1),
            ported_kernel_share=(share(KERNEL_NAMES + RECURRENT_KERNELS)
                                 / busy_ns if busy_ns else 0.0),
            recurrent_kernel_ms=share(RECURRENT_KERNELS) / 1e6,
            ported_ms={n: share((n,)) / 1e6
                        for n in KERNEL_NAMES + RECURRENT_KERNELS
                        if share((n,))},
            host_syncs=syncs, readback_s=time.perf_counter() - t_read,
            top=[dict(name=k[:60], ms=t / 1e6, count=c) for t, c, k in top],
            **extra)


def profile_generate(run):
    """One traced call of ``run`` (a generate, whose result has n_steps)
    through a TraceWindow."""
    win = TraceWindow()
    win.start()
    try:
        res = run()
    except BaseException:
        win.stop(0)
        raise
    return win.stop(res.n_steps)


class _WindowClosed(Exception):
    pass


def traced_serve(target, draft, scfg, reqs, cfg, rounds=TRACE_ROUNDS):
    """A window of serving at the cell's own load: the requests go through
    a Scheduler whose trace opens at the first sync round in which every
    slot holds a request and a first request has finished (the steady
    state: finished slots refilled from the queue), and closes ``rounds``
    rounds later (or when the queue drains), which cuts the run.  Adds the
    rounds traced and the mean number of decoding slots per round."""
    from repro_torch.serve import scheduler as S
    win = TraceWindow()
    st = dict(out=None, steps0=0, rounds=0, decoding=0)

    class WindowScheduler(S.Scheduler):
        def _run_chunk(self):
            if win.prof is not None and st["rounds"] == rounds:
                close(self)
                raise _WindowClosed
            if (win.prof is None and st["out"] is None and self.results
                    and all(sl.phase != S.FREE for sl in self.slots)):
                st["steps0"] = self.carry["n_steps"]
                win.start()
            if win.prof is not None:
                st["rounds"] += 1
                st["decoding"] += sum(sl.phase == S.DECODING
                                      for sl in self.slots)
            return super()._run_chunk()

    def close(sched):
        st["out"] = win.stop(
            sched.carry["n_steps"] - st["steps0"], rounds=st["rounds"],
            decoding_slots_mean=st["decoding"] / max(st["rounds"], 1),
            slots=len(sched.slots))

    sched = WindowScheduler(target, draft, scfg, **cfg.resolved(
        [S.as_request(r) for r in reqs]).scheduler_kwargs())
    sched.submit_many(reqs)
    try:
        sched.run()
    except _WindowClosed:
        pass
    finally:
        if win.prof is not None:
            close(sched)
    check(st["out"] is not None and st["rounds"] > 0,
          "serving trace: no round with every slot holding a request after "
          "a first request finished")
    return st["out"]


# ---------------------------------------------------------------------------
# Phase 2b: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------

PAGE_SIZE = 16
# (case, B, Sq, H, Hkv, hd, page size, pos range): the target's verify
# step, a target prefill chunk (one live row and a FREE row), the draft's
# decode step and the TINY pair's GQA at the serving page size; a
# kimi-like GQA verify (kimi_k2_1t_a32b: H=64, Hkv=8, hd 112) at page size
# 12, a gemma-like verify (gemma-7b: H=Hkv=16, hd 256) and a target verify
# at 4096 positions (past the kernel's 1024 kept scores, so its pass two
# recomputes scores); a nemotron-like verify (nemotron-4-340b: H=96,
# Hkv=8, hd 192, phase 8's paged serving)
PAGED_CASES = [
    ("target verify", 8, 5, 32, 32, 128, PAGE_SIZE, (17, 1000)),
    ("prefill chunk", 2, 32, 32, 32, 128, PAGE_SIZE, (97, 97)),
    ("draft decode", 8, 1, 12, 12, 64, PAGE_SIZE, (17, 1000)),
    ("tiny gqa", 8, 5, 4, 2, 64, PAGE_SIZE, (17, 1000)),
    ("kimi gqa", 8, 5, 64, 8, 112, 12, (17, 1000)),
    ("gemma verify", 8, 5, 16, 16, 256, PAGE_SIZE, (17, 1000)),
    ("long row", 2, 5, 32, 32, 128, PAGE_SIZE, (4096, 4096)),
    ("nemotron verify", 4, 5, 96, 8, 192, PAGE_SIZE, (17, 1000)),
]
# the sliding window (yi-6b-swa4k: H=32, Hkv=4, hd 128, window 4096) at a
# 4,600-position row, at the verify and the prefill-chunk (256) shapes,
# and window 8 at Sq=32, where queries 0-23 have no key and average v
# over the slice: (case, B, Sq, H, Hkv, hd, page size, pos range, window)
PAGED_WINDOW_CASES = [
    ("swa verify w4096", 4, 5, 32, 4, 128, PAGE_SIZE, (4600, 4600), 4096),
    ("swa chunk w4096", 2, 256, 32, 4, 128, PAGE_SIZE, (4600, 4600), 4096),
    ("swa chunk w8", 2, 32, 32, 4, 128, PAGE_SIZE, (97, 97), 8),
]
# the windowed cases' bf16 bound allows this many flips a row, not the
# fixed cases' 2: over 8 seeds of each paged case (scripts/paged_flips.py)
# the most a row needed was 2.195 flips, one row of the 256-query chunk
# at window 4096 on this script's seed (131,072 rows); every other case
# and seed stayed within 0.69
PAGED_WINDOW_FLIPS = 3


def paged_inputs(B, Sq, H, Hkv, hd, ps, pos_range, dtype, seed):
    """q, k/v pools with shuffled physical pages, tables whose live pages
    cover pos[b] + Sq - 1 positions with null-page tails, and a FREE last
    row (all-null table, pos 1: it attends kv 0 only)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    max_pages = -(-(pos_range[1] + Sq) // ps) + 1
    P = B * max_pages + 1
    q = torch.randn((B, Sq, H, hd), generator=g).to(DEV, dtype)
    k = torch.randn((P, ps, Hkv, hd), generator=g).to(DEV, dtype)
    v = torch.randn((P, ps, Hkv, hd), generator=g).to(DEV, dtype)
    pos = torch.randint(pos_range[0], pos_range[1] + 1, (B,), generator=g)
    pos[-1] = 1
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros((B, max_pages), dtype=torch.int64)
    for b in range(B - 1):
        n = -(-(int(pos[b]) + Sq - 1) // ps)
        table[b, :n] = perm[b * max_pages:b * max_pages + n]
    return q, k, v, table.to(DEV), pos.to(DEV)


def paged_bound(q, k, table, pos, window=0):
    """Bytes: the k/v positions some row of a slot attends, once per
    (slot, kv head), their table entries, pos, q and out; operations: q·k
    and p·v of each row over the positions it attends (its keys, or the
    positions its softmax averages, for a row with none valid:
    ``layers.window_mask``), at the rate of the inputs' type."""
    import torch
    from repro_torch.models import layers as L
    B, Sq, H, hd = q.shape
    ps, Hkv = k.shape[1], k.shape[2]
    el = q.element_size()
    valid, present = L.window_mask(pos, Sq, table.shape[1] * ps, window)
    att = valid | (present & ~valid.any(-1, keepdim=True))
    n_pos = att.any(1).sum(-1).tolist()
    nbytes = (sum(n * 2 * Hkv * hd * el + 8 * -(-n // ps) for n in n_pos)
              + 8 * B + 2 * q.numel() * el)
    nops = 4 * H * hd * int(att.sum())
    rate = FP32_OPS_PER_S if q.dtype == torch.float32 else BF16_OPS_PER_S
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / rate * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def sdpa_yardstick(q, k, v, table, pos, window=0):
    """One scaled_dot_product_attention call over the pre-gathered dense
    k/v (GQA heads expanded) with the same boolean mask (the keys of each
    query, ``layers.window_mask``): a yardstick only — the gather is not
    timed and the port never calls SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    n_rep = q.shape[2] // k.shape[2]
    kd = ref.paged_gather(k, table).repeat_interleave(n_rep, 2)
    vd = ref.paged_gather(v, table).repeat_interleave(n_rep, 2)
    mask = L.window_mask(pos, q.shape[1], kd.shape[1], window)[0][:, None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)


def paged_faults(args, want, tol):
    """How far the tolerance sees two faults on the longest live row: the
    kernel attending one position too many (an off-by-one mask) and
    reading a wrong page in the middle of the row.  Returns the largest
    |out - want| / tol over that row for each; both must exceed 1."""
    from repro_torch.kernels import ops
    q, k, v, table, pos = args
    Sq, ps = q.shape[1], k.shape[1]
    b = int(pos[:-1].argmax())
    n = -(-(int(pos[b]) + Sq - 1) // ps)
    shifted = pos.clone()
    shifted[b] += 1
    swapped = table.clone()
    swapped[b, n // 2] = table[b, n // 2 - 1]

    def ratio(out):
        return float(((out.float() - want.float()).abs() / tol)[b].max())
    return (ratio(ops.paged_attention(q, k, v, table, shifted)),
            ratio(ops.paged_attention(q, k, v, swapped, pos)))


def phase_paged_kernel():
    """Every paged case in bf16 and fp32 against the plain version, the
    windowed cases with their window.  fp32: max abs error within 1e-5
    (another order of float sums).  bf16: each element within
    ref.paged_attention_tol — two bf16 ulps of the element plus two flips
    (windowed: PAGED_WINDOW_FLIPS) of the row's worst score or probability
    rounding, the most another sum order can move it; the flips each case
    needed are recorded — and the same tolerance must see an off-by-one mask
    and a wrong page on the longest row (windowed: an off-by-one on the
    slice's first position, the kernel run at window + 1).  The kernel's,
    the plain version's and SDPA's times beside the bound (windowed: and
    the unwindowed kernel's time on the same inputs).  Each windowed
    row alone equals its batch bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    record = []
    cases = ([c + (0,) for c in PAGED_CASES] + PAGED_WINDOW_CASES)
    for name, B, Sq, H, Hkv, hd, ps, pos_range, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(B, Sq, H, Hkv, hd, ps, pos_range, dtype,
                                seed=B * Sq * H)
            w = dict(window=window) if window else {}
            out = ops.paged_attention(*args, **w)
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(*args, **w)
            diff = (out.float() - want.float()).abs()
            err = float(diff.max())
            tag = f"paged_attention {name} {str(dtype)[6:]}"
            check(bool(torch.isfinite(out.float()).all()),
                  f"{tag}: non-finite output")
            if dtype == torch.float32:
                tol = torch.full_like(diff, 1e-5)
                faults = {}
            elif window:
                tol = ref.paged_attention_tol(*args, want, window=window,
                                              flips=PAGED_WINDOW_FLIPS)
                off = float((((ops.paged_attention(*args, window=window + 1)
                               .float() - want.float()).abs() / tol)
                             [:-1]).max())
                check(off > 1, f"{tag}: the tolerance misses an off-by-one "
                      f"on the window's first position ({off})")
                faults = dict(window_off_by_one_over_tol=off)
            else:
                tol = ref.paged_attention_tol(*args, want)
                off, page = paged_faults(args, want, tol)
                check(off > 1 and page > 1, f"{tag}: the tolerance misses "
                      f"an off-by-one mask ({off}) or a wrong page ({page})")
                faults = dict(off_by_one_over_tol=off,
                              wrong_page_over_tol=page)
            ratio = float((diff / tol).max())
            check(ratio <= 1, f"{tag}: max abs err {err}, {ratio} times "
                  f"its tolerance")
            if dtype == torch.bfloat16:
                faults["flips_needed"] = float(ref.paged_attention_flips(
                    *args, out, want, window=window).max())
            if window:
                q, k, v, table, pos = args
                for b in range(B):
                    alone = ops.paged_attention(q[b:b + 1], k, v,
                                                table[b:b + 1], pos[b:b + 1],
                                                window=window)
                    check(torch.equal(alone[0], out[b]),
                          f"{tag}: row {b} alone differs from its batch")
                faults["unwindowed_ms"] = device_ms(
                    lambda: ops.paged_attention(*args),
                    kernel="paged_attention_kernel")
            times = timings("paged_attention_kernel",
                            lambda: ops.paged_attention(*args, **w),
                            lambda: ref.paged_attention_ref(*args, **w))
            bnd, by = paged_bound(args[0], args[1], args[3], args[4], window)
            record.append(dict(case=tag, max_abs_err=err, err_over_tol=ratio,
                               tol_median=float(tol.median()), **faults,
                               **times,
                               library_ms=device_ms(
                                   sdpa_yardstick(*args, window), 10),
                               bound_ms=bnd, bound_by=by))
    for r in record:
        print("kernel-check " + json.dumps(r))
    return record


# ---------------------------------------------------------------------------
# Phase 2c: the recurrent kernels against their plain versions
# ---------------------------------------------------------------------------

# (case, kernel, shape): rwkv6-3b's decode step at 8 slots, an admission
# chunk, a prompt with a ragged tail and a batch; zamba2-1.2b's decode
# step at 4 slots and prompts longer than the chunk (one exact multiple,
# one ragged) and a batch, at ssm.chunk 128; the WKV kernels' widest
# instantiation (head size 128, the same width of heads); and the chunked
# scan at two (hd, N, chunk) whose chunk the tiled kernel's layout cannot
# hold and its scalar kernel's can (a key "chunk" overrides REC_CHUNK):
# one chunk, and three with a ragged tail
REC_CASES = [
    ("wkv_step rwkv6-3b", "wkv_step", dict(B=8, H=40, hd=64)),
    ("wkv admission chunk", "wkv", dict(B=1, S=32, H=40, hd=64)),
    ("wkv prompt", "wkv", dict(B=1, S=300, H=40, hd=64)),
    ("wkv batch", "wkv", dict(B=4, S=200, H=40, hd=64)),
    ("ssd_step zamba2-1.2b", "ssd_step", dict(B=4, H=64, hd=64, N=64)),
    ("ssd prompt 256", "ssd", dict(B=1, S=256, H=64, hd=64, N=64)),
    ("ssd prompt 300", "ssd", dict(B=1, S=300, H=64, hd=64, N=64)),
    ("ssd batch", "ssd", dict(B=4, S=200, H=64, hd=64, N=64)),
    ("wkv_step hd128", "wkv_step", dict(B=8, H=20, hd=128)),
    ("wkv hd128", "wkv", dict(B=1, S=64, H=20, hd=128)),
    ("ssd_scan prompt 16", "ssd_scan", dict(B=1, S=16, H=64, hd=64, N=64)),
    ("ssd_scan prompt 64", "ssd_scan", dict(B=1, S=64, H=64, hd=64, N=64)),
    ("ssd_scan prompt 128", "ssd_scan",
     dict(B=1, S=128, H=64, hd=64, N=64)),
    ("ssd_scalar hd16 N348", "ssd",
     dict(B=2, S=67, H=4, hd=16, N=348, chunk=67)),
    ("ssd_scalar hd32 N250", "ssd",
     dict(B=2, S=200, H=4, hd=32, N=250, chunk=81)),
]
REC_CHUNK = 128
# the launch count and the device kernel of each case's wrapper: the
# per-timestep scan runs the step kernel, once a call
REC_KERNEL = {"ssd_scan": "ssd_step"}
FAULT_FACTOR = 10     # a fault must move an output this many tolerances


def rec_inputs(kernel, shape, dtype, seed):
    """Inputs at a kernel's serving shape, drawn as the models make them:
    r, k, v ~ N(0, 1) (projections of normalised hiddens), decays w =
    exp(-exp(N(-2, 1))) in (0, 1), bonus u ~ N(0, 0.25), a prior state
    ~ N(0, 0.01); la = -softplus(N(0, 1)), dtx = softplus(N(0, 1))·N(0, 1),
    B, C ~ N(0, 1).  The model-type inputs (r, k, v, u; dtx, B, C) in
    ``dtype``, the rest float32."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(seed)

    def n(*sh, std=1.0, mean=0.0):
        return torch.randn(sh, generator=g) * std + mean

    B = shape["B"]
    if kernel.startswith("wkv"):
        H, hd = shape["H"], shape["hd"]
        lead = (B, shape["S"], H, hd) if kernel == "wkv" else (B, H, hd)
        r, k, v = n(*lead), n(*lead), n(*lead)
        w = torch.exp(-torch.exp(n(*lead, mean=-2.0)))
        u = n(H, hd, std=0.5)
        s0 = n(B, H, hd, hd, std=0.1)
        return tuple(x.to(DEV, dtype) for x in (r, k, v)) + (
            w.to(DEV), u.to(DEV, dtype), s0.to(DEV))
    H, hd, N = shape["H"], shape["hd"], shape["N"]
    lead = (B, shape["S"]) if "S" in shape else (B,)
    la = -F.softplus(n(*lead, H))
    dtx = F.softplus(n(*lead, H, 1)) * n(*lead, H, hd)
    Bf, Cf = n(*lead, N), n(*lead, N)
    h0 = n(B, H, hd, N, std=0.1)
    return (la.to(DEV),) + tuple(x.to(DEV, dtype) for x in (dtx, Bf, Cf)) \
        + (h0.to(DEV),)


def rec_functions(kernel, chunk=REC_CHUNK):
    """(the kernel's wrapper, its plain version, its tolerance) as
    functions of the inputs (``ssd`` in chunks of ``chunk`` tokens)."""
    import functools
    from repro_torch.kernels import ops, ref
    if kernel == "wkv_step":
        return ops.wkv_step, ref.wkv_step_ref, ref.wkv_tol
    if kernel == "wkv":
        return ops.wkv, ref.wkv_ref, ref.wkv_tol
    if kernel == "ssd_step":
        return ops.ssd_step, ref.ssd_step_ref, ref.ssd_tol
    if kernel == "ssd_scan":
        return (ops.ssd_scan, ref.ssd_ref,
                functools.partial(ref.ssd_tol, chunk=0))
    return (functools.partial(ops.ssd, chunk=chunk),
            functools.partial(ref.ssd_chunked_ref, chunk=chunk),
            functools.partial(ref.ssd_tol, chunk=chunk))


def rec_faults(kernel, args):
    """Inputs that emulate three faults of the kernel: for WKV a dropped
    bonus u, the decay applied one step late (w shifted by one timestep;
    for the step kernel w = 1) and a wrong head stride (k read from the
    neighbouring head); for SSD the decay one step late (la shifted; for
    the step kernel la = 0), a wrong head stride (dtx of the neighbouring
    head) and B and C swapped."""
    import torch
    if kernel.startswith("wkv"):
        r, k, v, w, u, s0 = args
        if kernel == "wkv":
            late = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], 1)
        else:
            late = torch.ones_like(w)
        return {"dropped_u": (r, k, v, w, torch.zeros_like(u), s0),
                "decay_late": (r, k, v, late, u, s0),
                "head_stride": (r, torch.roll(k, 1, dims=-2), v, w, u, s0)}
    la, dtx, Bf, Cf, h0 = args
    if la.dim() == 3:
        late = torch.cat([torch.zeros_like(la[:, :1]), la[:, :-1]], 1)
    else:
        late = torch.zeros_like(la)
    return {"decay_late": (late, dtx, Bf, Cf, h0),
            "head_stride": (la, torch.roll(dtx, 1, dims=-2), Bf, Cf, h0),
            "b_c_swapped": (la, dtx, Cf, Bf, h0)}


def ssd_tc_ops(shape, padded=False):
    """Float operations of the chunked scan's products on tensor cores,
    three TF32 products a float32 multiply-add.  By default what the
    chunked algorithm needs at the real token count: per (b, chunk) of n
    tokens, C.B^T over its n (n + 1) / 2 pairs on or below the diagonal
    (it depends on neither h nor d), and per head y's intra-chunk part over
    those pairs, its carried part and the state's (n hd N each).  With
    ``padded``, what csrc/ssd.cu runs: chunks of Lc = min(chunk, S) rounded
    up to 16 rows (the tail too), N up to 8, hd to 8 for y and to 16 for
    the state, and the R (R + 1) 16x8 tiles of C.B^T once per (b, h)."""
    B, S, H, hd, N = (shape[k] for k in ("B", "S", "H", "hd", "N"))
    Lc = min(shape.get("chunk", REC_CHUNK), S)
    if padded:
        Lp, Np = -(-Lc // 16) * 16, -(-N // 8) * 8
        hd8, hd16 = -(-hd // 8) * 8, -(-hd // 16) * 16
        tiles = (Lp // 16) * (Lp // 16 + 1)
        macs = H * (tiles * 128 * Np + tiles * 128 * hd8 + Lp * Np * hd8
                    + hd16 * Np * Lp) * -(-S // Lc)
    else:
        macs = 0
        for t0 in range(0, S, Lc):
            n = min(Lc, S - t0)
            pairs = n * (n + 1) // 2
            macs += pairs * N + H * (pairs * hd + 2 * n * hd * N)
    return 3 * 2 * macs * B


def rec_bound(kernel, shape, el):
    """Bytes: every input read once, y and the state written once.  Float
    operations: what the recurrence itself needs per real token and head,
    not what the kernel's algorithm does.  WKV: y_j = Σ_i r_i s_ij +
    v_j Σ_i r_i u_i k_i and s'_ij = w_i s_ij + k_i v_j, 5 per state element
    plus 5 per value column; SSD: h' = exp(la) h + dtx ⊗ B and y = h'·C,
    5 per state element plus the exp, at the float32 rate.  The chunked
    scan runs its products on tensor cores instead: its bound takes the
    operations the chunked algorithm needs at the real token count
    (``ssd_tc_ops``) at the TF32 rate, and the float32 figure stays beside
    it as ``bound_fp32_ms``; ``kernel_work_ms`` is the time of the products
    the tiled kernel runs, padded tiles and per-head C.B^T included, at
    that rate (not a bound).  The scalar kernel computes the same function
    on the same inputs, so its bound is the same.  Returns the record's
    bound keys."""
    B = shape["B"]
    S = shape.get("S", 1)
    if kernel.startswith("wkv"):
        H, hd = shape["H"], shape["hd"]
        tok = B * S * H * hd
        nbytes = tok * (3 * el + 4 + 4) + H * hd * el + 2 * 4 * B * H * hd ** 2
        bnd, by = bound_ms(nbytes, 5 * tok * (hd + 1))
        return dict(bound_ms=bnd, bound_by=by)
    H, hd, N = shape["H"], shape["hd"], shape["N"]
    nbytes = (B * S * H * (4 + hd * el + 4 * hd) + 2 * B * S * N * el
              + 2 * 4 * B * H * hd * N)
    bnd, by = bound_ms(nbytes, B * S * H * (5 * hd * N + 1))
    if kernel != "ssd":
        return dict(bound_ms=bnd, bound_by=by)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = ssd_tc_ops(shape) / TF32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_b, t_tc),
                bound_by="bytes" if t_b >= t_tc else "operations",
                bound_fp32_ms=bnd, bound_tc_ms=t_tc,
                kernel_work_ms=ssd_tc_ops(shape, padded=True)
                / TF32_OPS_PER_S * 1e3)


def rows_alone_equal(fn, args, kernel, got):
    """Each row of a batch run alone gives, bit for bit, what it gives in
    the batch (every output); u of the WKV kernels has no batch axis."""
    import torch
    for b in range(args[0].shape[0]):
        row = [a if kernel.startswith("wkv") and i == 4 else
               a[b:b + 1].clone() for i, a in enumerate(args)]
        if not all(torch.equal(alone, batched[b:b + 1])
                   for alone, batched in zip(fn(*row), got)):
            return False
    return True


def phase_recurrent_kernels():
    """wkv_step, wkv, ssd_step (the decode step and the per-timestep scan,
    one launch a call) and ssd against their plain versions at the serving
    shapes of rwkv6-3b and zamba2-1.2b, and ssd at two shapes only its
    scalar kernel holds, with float32 and bfloat16 inputs.  Every output
    (y and the state) must lie within its tolerance
    (ref.wkv_tol / ref.ssd_tol: twice γ_D times the output's envelope, the
    plain version run on absolute values), and each of three emulated
    faults must exceed it by FAULT_FACTOR.  The WKV kernels' state must
    equal the plain version's bit for bit, and in the batch cases of wkv
    and ssd each row alone must give what it gives in the batch.  The
    kernel's, the plain version's and the bound's times; no single
    PyTorch call computes these recurrences, so there is no library
    yardstick.  Each ssd launch must run the kernel ops.ssd_kernel_for
    names (the tiled one wherever its layout fits); the records of the
    scalar kernel's cases carry kernel "ssd_scalar".  Returns the records
    and the launch counts of the scalar kernel's cases' checked calls
    (each counted from 0 just before the call)."""
    import torch
    from repro_torch.kernels import ops
    record = []
    scalar_counts = {}
    for name, kernel, shape in REC_CASES:
        fn, plain, tolf = rec_functions(
            kernel, shape.get("chunk", REC_CHUNK))
        for dtype in (torch.bfloat16, torch.float32):
            tag = f"{name} {str(dtype)[6:]}"
            args = rec_inputs(kernel, shape, dtype, seed=len(record) + 1)
            launched = REC_KERNEL.get(kernel, kernel)
            which = None
            if kernel == "ssd":
                which = ops.ssd_kernel_for(
                    shape["hd"], shape["N"],
                    min(shape.get("chunk", REC_CHUNK), shape["S"]))
            # the scalar chunked kernel counts under ssd and ssd_scalar
            want_launches = {launched: 1, **({"ssd_scalar": 1}
                                             if which == "scalar" else {})}
            ops.reset_launches()
            got = fn(*args)
            torch.cuda.synchronize()
            ran = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(ran == want_launches, f"{tag}: launches {ran}, not "
                  f"{want_launches}")
            if which == "scalar":
                for k, v in ops.LAUNCHES.items():
                    scalar_counts[k] = scalar_counts.get(k, 0) + v
            want = plain(*args)
            tols = tolf(*args)
            ratio, errs = 0.0, []
            for out, w, tol in zip(got, want, tols):
                check(out.shape == w.shape and out.dtype == torch.float32,
                      f"{tag}: output {tuple(out.shape)} {out.dtype}")
                check(bool(torch.isfinite(out).all()), f"{tag}: non-finite")
                diff = (out - w).abs()
                errs.append(float(diff.max()))
                ratio = max(ratio, float((diff / tol).max()))
            err = max(errs)
            check(ratio <= 1, f"{tag}: max abs err {err}, {ratio} times its "
                  "tolerance")
            if kernel.startswith("wkv"):
                check(errs[1] == 0.0, f"{tag}: state off by {errs[1]}, not "
                      "bit for bit")
            alone = None
            if kernel in ("wkv", "ssd") and shape["B"] > 1:
                alone = rows_alone_equal(fn, args, kernel, got)
                check(alone, f"{tag}: a row alone differs from the batch")
            faults = {}
            for fault, fargs in rec_faults(kernel, args).items():
                bad = fn(*fargs)
                faults[fault + "_over_tol"] = max(
                    float(((o - w).abs() / tol).max())
                    for o, w, tol in zip(bad, want, tols))
            torch.cuda.synchronize()
            check(min(faults.values()) > FAULT_FACTOR,
                  f"{tag}: the tolerance misses a fault: {faults}")
            times = timings(f"{launched}_kernel", lambda: fn(*args),
                            lambda: plain(*args))
            bound = rec_bound(kernel, shape, torch.finfo(dtype).bits // 8)
            record.append(dict(case=tag, kernel="ssd_scalar"
                               if which == "scalar" else launched,
                               max_abs_err=err,
                               err_over_tol=ratio,
                               y_err=errs[0], state_err=errs[1],
                               rows_alone_equal=alone,
                               tol_median=float(tols[0].median()), **faults,
                               **times, library_ms=None, **bound))
    for r in record:
        print("kernel-check " + json.dumps(r))
    check(scalar_counts.get("ssd_scalar", 0) > 0,
          "phase 2c: the scalar ssd kernel never ran")
    return record, scalar_counts


# ---------------------------------------------------------------------------
# Phase 3b: continuous batching over the paged pool at full width
# ---------------------------------------------------------------------------

SERVE = dict(batch=8, page_size=PAGE_SIZE, prefill_chunk=32, sync_every=4,
             n_requests=16, prompt=(16, 256), system=64, n_tokens=(16, 64),
             K=4, temperature=0.7)
SERVE_SCHEMES = ("gumbel", "synthid")


def serve_workload(seed, n, prompt, n_tokens, vocab, system):
    """n requests submitted at once: prompt lengths in ``prompt``, every
    other one opening with one shared ``system``-token system prompt."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, vocab, system)
    reqs = []
    for i in range(n):
        S0 = int(rng.integers(prompt[0], prompt[1] + 1))
        if i % 2:
            S0 = max(S0, system + 1)
            p = np.concatenate([sys_prompt, rng.integers(1, vocab,
                                                         S0 - system)])
        else:
            p = rng.integers(1, vocab, S0)
        reqs.append((p.astype(np.int32),
                     int(rng.integers(n_tokens[0], n_tokens[1] + 1))))
    return reqs


# the scheduler's parts of a sync round, timed each with a synchronize at
# its end: prefill chunks and finalize, page growth, the decode chunk (the
# spec steps), the host snapshot, flush and admission
SCHED_PARTS = ("_prefill_step", "_ensure_pages", "_run_chunk",
               "_take_snapshot", "_flush", "_admit")


def parts_scheduler():
    """A Scheduler subclass that times each of SCHED_PARTS, synchronizing
    the card at its end.  Only the separate breakdown run builds it: the
    end-to-end numbers come from an unpatched serve_requests."""
    import torch
    from repro_torch.serve import scheduler as S

    class PartsScheduler(S.Scheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.host_s = dict.fromkeys(SCHED_PARTS, 0.0)

    def timed(name):
        part = getattr(S.Scheduler, name)

        def run(self, *a, **kw):
            t = time.perf_counter()
            out = part(self, *a, **kw)
            if DEV != "cpu":
                torch.cuda.synchronize()
            self.host_s[name] += time.perf_counter() - t
            return out
        return run

    for name in SCHED_PARTS:
        setattr(PartsScheduler, name, timed(name))
    return PartsScheduler


def serve_config(reqs, overlap=False, **over):
    """The paged serving config: num_pages covers the worst-case live
    footprint of ``batch`` slots (the scheduler raises on mid-request
    exhaustion; under ``overlap`` its page growth looks two chunks ahead)
    and stays below batch × max_pages, so the pool and not the rectangle
    bounds memory."""
    from repro_torch.serve.config import ServeConfig
    c = dict(SERVE, **over)
    K1, ps = c["K"] + 1, c["page_size"]
    max_S0 = max(len(p) for p, _ in reqs)
    max_n = max(n for _, n in reqs)
    max_seq = max_S0 + 1 + K1 * max_n + 2
    max_pages = -(-max_seq // ps)
    chunks_ahead = 2 if overlap else 1
    per_slot = min(max_pages, -(-(max_S0 + max_n - 2 + (
        chunks_ahead * c["sync_every"] + 1) * K1) // ps))
    num_pages = c["batch"] * per_slot + 1 + c["batch"]
    check(num_pages < c["batch"] * max_pages,
          f"pool of {num_pages} pages not below {c['batch']} x {max_pages}")
    return ServeConfig(batch=c["batch"], key=0xC0FFEE, page_size=ps,
                       num_pages=num_pages, prefill_chunk=c["prefill_chunk"],
                       sync_every=c["sync_every"], prefix_cache=True,
                       overlap=overlap)


def phase_serve(target, draft):
    """16 requests through serve_requests (paged, prefix cache) for gumbel
    and synthid at full width; returns the launch counts, the numbers and
    the RequestResults of each scheme's timed run (phase 7 holds its
    overlapped runs to them).
    The timed runs are serve_requests as users call it; for gumbel the
    same requests then go once more through a Scheduler that times its
    parts, for the breakdown and the FIFO and admit-order checks (the
    admission logic does not depend on the scheme)."""
    import numpy as np
    import torch
    from repro_torch.configs import LLAMA_7B
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E
    from repro_torch.serve.scheduler import as_request
    reqs = serve_workload(5, SERVE["n_requests"], SERVE["prompt"],
                          SERVE["n_tokens"], LLAMA_7B.vocab, SERVE["system"])
    cfg = serve_config(reqs)
    PartsScheduler = parts_scheduler()
    nt, nd = target.cfg.n_layers, draft.cfg.n_layers
    per_step, per_chunk = nt + nd * (SERVE["K"] + 1), nt + nd
    counts = {k: 0 for k in ops.LAUNCHES}
    results, served = {}, {}
    for wm in SERVE_SCHEMES:
        scfg = E.SpecConfig(K=SERVE["K"], watermark=wm,
                            temperature=SERVE["temperature"])
        E.serve_requests(target, draft, scfg, reqs[:2], config=cfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        ops.reset_launches()
        t = time.perf_counter()
        res = E.serve_requests(target, draft, scfg, reqs, config=cfg,
                               stats_out=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            counts[k] += v
        check(len(res) == len(reqs), f"serve {wm}: {len(res)} results")
        for r, (p, n) in zip(res, reqs):
            check(n <= r.length <= n + SERVE["K"],
                  f"serve {wm}: uid {r.uid} length {r.length}, target {n}")
            check(bool(((r.tokens >= 0) & (r.tokens < LLAMA_7B.vocab)).all()),
                  f"serve {wm}: token out of range")
        check(stats["pages_used"] == stats["prefix_pages"],
              f"serve {wm}: {stats['pages_used']} pages used at the end, "
              f"{stats['prefix_pages']} held by the prefix cache")
        check(launches["paged_attention"] > 0,
              f"serve {wm}: paged_attention never launched")
        max_alloc = torch.cuda.max_memory_allocated() / 2**30
        n_steps = int(stats["spec_steps"])
        n_chunks = int(stats["prefill_chunks"])
        n_tok = int(sum(r.length for r in res))
        results[wm] = dict(
            seconds=secs, requests_per_s=len(res) / secs,
            tokens_per_s=n_tok / secs, tokens=n_tok,
            ttft_mean_s=stats["ttft_mean_s"], gap_p95_s=stats["gap_p95_s"],
            sync_rounds=int(stats["sync_rounds"]), n_steps=n_steps,
            ms_per_step=secs / n_steps * 1e3, prefill_chunks=n_chunks,
            aatps=stats["aatps"], prefix_hits=stats["prefix_hits"],
            pages_saved=stats["prefix_pages_saved"],
            pages_peak=stats["pages_peak"], num_pages=cfg.num_pages,
            max_allocated_gib=max_alloc, launches=launches,
            # one paged launch per target layer and one per draft layer for
            # each of the K proposals and the commit re-feed, per spec step;
            # one per target and draft layer per prefill chunk
            paged_launches_per_step=per_step,
            paged_launches_expected=per_step * n_steps + per_chunk * n_chunks)

        if wm == SERVE_SCHEMES[0]:
            sched = PartsScheduler(target, draft, scfg, **cfg.resolved(
                [as_request(r) for r in reqs]).scheduler_kwargs())
            sched.submit_many(reqs)
            again = sched.run()
            first = [e[1] for e in sched.events
                     if e[0] == "admit_chunk" and e[2] == 0]
            check(first == list(range(len(reqs))),
                  f"serve {wm}: slots not taken FIFO: {first}")
            check(sorted(sched.admit_order) == list(range(len(reqs))),
                  f"serve {wm}: admit order {sched.admit_order}")
            pool = sum(c[k].numel() * c[k].element_size()
                       for c in (sched.carry["state"]["t_cache"],
                                 sched.carry["state"]["d_cache"])
                       for k in ("k", "v"))
            results[wm]["parts"] = dict(
                seconds=sum(sched.host_s.values()),
                n_steps=sched.carry["n_steps"],
                decode_ms_per_step=(sched.host_s["_run_chunk"]
                                    / sched.carry["n_steps"] * 1e3),
                part_s=sched.host_s,
                same_tokens=sum(np.array_equal(a.tokens, b.tokens)
                                for a, b in zip(res, again)))
            del again, sched
        results[wm]["pool_gib"] = pool / 2**30
        results[wm]["profile"] = traced_serve(target, draft, scfg, reqs, cfg)
        print(f"serve {wm}: " + json.dumps(results[wm]))
        served[wm] = res
    check(all(counts[k] > 0 for k in KERNEL_NAMES),
          f"a kernel of the paged path was never launched: {counts}")
    return counts, results, served


# ---------------------------------------------------------------------------
# Phase 7: streaming and the double-buffered loop at full width
# ---------------------------------------------------------------------------

# phase 3b's requests through engine.serve_stream with overlap on; phase
# 3b's unpatched serve_requests runs are the overlap-off side
STREAM_SCHEMES = SERVE_SCHEMES
SERVED_FIELDS = ("tokens", "src", "u", "ctx_hashes")


def stream_serve(target, draft, scfg, reqs, cfg):
    """One serve_stream call drained under asyncio.run, with
    ``scheduler.device_get`` counted.  -> (events, results in uid order,
    stats, seconds, device_get calls)."""
    import asyncio
    import dataclasses
    import torch
    from repro_torch.serve import engine as E
    from repro_torch.serve import scheduler as S
    got, stats, events = [], {}, []
    cfg = dataclasses.replace(cfg, on_result=got.append)
    real, gets = S.device_get, []

    def counted(handles):
        gets.append(1)
        return real(handles)

    async def consume():
        async for ev in E.serve_stream(target, draft, scfg, reqs,
                                       config=cfg, stats_out=stats):
            events.append(ev)

    torch.cuda.synchronize()
    S.device_get = counted
    try:
        t = time.perf_counter()
        asyncio.run(consume())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        S.device_get = real
    return events, sorted(got, key=lambda r: r.uid), stats, secs, len(gets)


def phase_stream(target, draft, serve_results, served):
    """Phase 3b's 16 requests through engine.serve_stream with overlap on
    (paged, prefix cache, the pool sized for the doubled horizon), gumbel
    and synthid.  Each run must stream exactly its drained results, equal
    phase 3b's overlap=False results bit for bit (tokens, src, u, context
    hashes), call device_get once a sync round and drain the pool.
    Prints requests/s, tokens/s, mean TTFT and p95 gap beside phase 3b's,
    and, for gumbel, host syncs a round and the idle share in a traced
    window beside phase 3b's window (TRACE_ROUNDS rounds of the same
    load).  -> (launch counts by path, results)."""
    import numpy as np
    from repro_torch.configs import LLAMA_7B
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E
    reqs = serve_workload(5, SERVE["n_requests"], SERVE["prompt"],
                          SERVE["n_tokens"], LLAMA_7B.vocab, SERVE["system"])
    cfg = serve_config(reqs, overlap=True)
    counts, results = {}, {}
    for wm in STREAM_SCHEMES:
        name = f"serve_stream {wm} overlap"
        scfg = E.SpecConfig(K=SERVE["K"], watermark=wm,
                            temperature=SERVE["temperature"])
        ops.reset_launches()
        events, res, stats, secs, gets = stream_serve(target, draft, scfg,
                                                      reqs, cfg)
        counts[name] = dict(ops.LAUNCHES)
        check(len(res) == len(reqs), f"{name}: {len(res)} results")
        streamed = {}
        for uid, tok, _ in events:
            streamed.setdefault(uid, []).append(tok)
        for r in res:
            check(np.array_equal(streamed.get(r.uid, []), r.tokens),
                  f"{name}: uid {r.uid} streamed != drained")
        differ = [(a.uid, f) for a, b in zip(served[wm], res)
                  for f in SERVED_FIELDS
                  if not np.array_equal(getattr(a, f), getattr(b, f))]
        check(not differ and [a.uid for a in served[wm]]
              == [b.uid for b in res],
              f"{name}: differs from phase 3b's overlap=False results "
              f"(uid, field): {differ[:8]}")
        rounds = int(stats["sync_rounds"])
        check(gets == rounds, f"{name}: device_get ran {gets} times over "
              f"{rounds} sync rounds")
        check(stats["pages_used"] == stats["prefix_pages"],
              f"{name}: {stats['pages_used']} pages used at the end, "
              f"{stats['prefix_pages']} held by the prefix cache")
        n_tok = int(sum(r.length for r in res))
        results[name] = dict(
            seconds=secs, requests_per_s=len(res) / secs,
            tokens_per_s=n_tok / secs, tokens=n_tok,
            ttft_mean_s=stats["ttft_mean_s"], gap_p95_s=stats["gap_p95_s"],
            sync_rounds=rounds, n_steps=int(stats["spec_steps"]),
            ms_per_step=secs / int(stats["spec_steps"]) * 1e3,
            device_get_per_round=gets / rounds, num_pages=cfg.num_pages,
            pages_peak=stats["pages_peak"], events=len(events),
            same_as_phase_3b=True)
        b = serve_results[wm]
        print(f"{name}: {len(res) / secs:.3f} requests/s "
              f"({b['requests_per_s']:.3f} with overlap off, phase 3b), "
              f"{n_tok / secs:.1f} tokens/s ({b['tokens_per_s']:.1f}), "
              f"TTFT {stats['ttft_mean_s']:.3f} s ({b['ttft_mean_s']:.3f}),"
              f" p95 gap {stats['gap_p95_s']:.4f} s ({b['gap_p95_s']:.4f}),"
              f" {rounds} rounds ({b['sync_rounds']}), "
              f"{gets / rounds:.0f} device_get a round, {cfg.num_pages} "
              f"pages ({b['num_pages']}) [{SMI}]")
        if wm == STREAM_SCHEMES[0]:
            win = traced_serve(target, draft, scfg, reqs, cfg)
            off = b["profile"]
            results[name]["profile"] = win
            print(f"{name} window: host syncs "
                  f"{win['host_syncs'] / win['rounds']:.2f} a round + 1 "
                  f"device_get ({off['host_syncs'] / off['rounds']:.2f} "
                  f"with overlap off), idle share "
                  f"{win['device_idle_share']:.3f} "
                  f"({off['device_idle_share']:.3f}), "
                  f"{win['ms_per_step']:.1f} ms a step "
                  f"({off['ms_per_step']:.1f}) [{SMI}]")
    check(all(sum(c[k] for c in counts.values()) > 0 for k in KERNEL_NAMES),
          f"a kernel of the streaming path was never launched: {counts}")
    print("stream: " + json.dumps(results))
    return counts, results


# ---------------------------------------------------------------------------
# Phase 3c: recurrent drafting at full width
# ---------------------------------------------------------------------------

# depth cut to make room for phase 8: 24 tokens a generate row (was 48),
# 12 paged requests of 16-32 tokens (was 16 of 16-64; more than the 8
# slots, so the traced window finds every slot busy after a first request
# finished), 6 dense ones over 4 slots (was 8), a one-request warm-up
# before each serving run (was 2) and the shorter traced windows below
REC_SLICE = dict(B=4, prompt=200, n_tokens=24, K=4, temperature=0.7,
                 chunk=128)
REC_SERVE = dict(batch=8, page_size=PAGE_SIZE, prefill_chunk=32,
                 sync_every=4, n_requests=12, prompt=(16, 256),
                 n_tokens=(16, 32))
REC_DENSE_SERVE = dict(batch=4, sync_every=4, n_requests=6)
# phase 3c's traced windows (each reads back ~240,000 events at the
# dense cells' length): 6 generate tokens and 2 serving rounds
REC_PROFILE_TOKENS = 6
REC_TRACE_ROUNDS = 2
REC_STATE_KEYS = ("wkv", "att_shift", "ffn_shift", "conv", "ssm")


def recurrent_drafts():
    """The slice's drafts, derived from the copied configs: rwkv6-3b with
    the target's vocab (32000; draft and target share a vocabulary, every
    other width kept) and zamba2-1.2b as it stands (vocab 32000), both with
    ssm.chunk = 128 (the reference's optimised variant, which puts the
    recurrent kernels on the path)."""
    import dataclasses
    from repro_torch.configs import LLAMA_7B, RWKV6_3B, ZAMBA2_1_2B
    out = {}
    for name, cfg in (("rwkv6", RWKV6_3B), ("zamba2", ZAMBA2_1_2B)):
        over = dict(ssm=dataclasses.replace(cfg.ssm,
                                            chunk=REC_SLICE["chunk"]))
        if cfg.vocab != LLAMA_7B.vocab:
            over["vocab"] = LLAMA_7B.vocab
        out[name] = dataclasses.replace(cfg, **over)
        print(f"draft {cfg.name}: ssm.chunk {cfg.ssm.chunk} -> "
              f"{REC_SLICE['chunk']}" + (f", vocab {cfg.vocab} -> "
                                         f"{LLAMA_7B.vocab}"
                                         if "vocab" in over else ""))
    return out


def state_bytes(cache, batch: int) -> int:
    """Bytes of one slot's recurrent draft state (the rows that
    checkpoints copy and the freeze restores)."""
    return sum(cache[k].numel() * cache[k].element_size()
               for k in REC_STATE_KEYS if k in cache) // batch


def draft_logits_check(draft, prompts):
    """Random bf16 weights at full depth: the logits after a prefill and
    after three decode steps must be finite; returns their largest |.|."""
    import torch
    logits, cache = draft.prefill(torch.as_tensor(prompts, device=DEV),
                                  prompts.shape[1] + 8)
    peaks = [float(logits.float().abs().max())]
    tok = logits[:, -1].argmax(-1)
    for _ in range(3):
        logits, cache = draft.decode_step(tok, cache)
        peaks.append(float(logits.float().abs().max()))
        tok = logits.argmax(-1)
    check(all(p == p and p != float("inf") for p in peaks),
          f"{draft.cfg.name}: non-finite logits {peaks}")
    print(f"{draft.cfg.name}: logits finite after prefill and 3 steps, "
          f"max |logit| {peaks}")
    return peaks


def run_counted(fn):
    """Run fn with every launch count at 0 before and read just after:
    -> (fn's result, seconds, the launch counts of that run)."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, dict(ops.LAUNCHES)


def print_ssd_launches(by_path):
    """One line per Zamba2 path: its ssd_step launches (decode steps and,
    one a call, per-timestep scans of prompts up to the chunk) and its
    chunked ssd launches."""
    for path, c in by_path.items():
        if "zamba2" in path:
            print(f"{path}: ssd_step launches {c['ssd_step']}, "
                  f"ssd launches {c['ssd']}")


def phase_recurrent(target):
    """LLAMA_7B with the rwkv6-3b and the zamba2-1.2b drafts in bf16 (random
    weights from seed 2): generate (B=4, prompt 200, 24 tokens; gumbel and
    synthid for RWKV6, gumbel for Zamba2), paged serve_requests with the
    RWKV6 draft (12 requests, 8 slots, no prefix cache: a recurrent draft's
    state must see the whole prompt) and dense serve_requests with the
    Zamba2 draft (6 requests, 4 slots: a hybrid draft has no chunked
    admission).  Returns the launch counts by path and the results; the
    recurrent kernels must have run on their paths."""
    import torch
    from repro_torch.configs import LLAMA_7B
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    drafts = recurrent_drafts()
    g = torch.Generator(device="cpu").manual_seed(13)
    prompts = torch.randint(1, LLAMA_7B.vocab, (REC_SLICE["B"],
                                                REC_SLICE["prompt"]),
                            generator=g).numpy()
    keys = [0x1234, 0xDEADBEEF, 7, 2**31 + 5]
    n, K = REC_SLICE["n_tokens"], REC_SLICE["K"]
    by_path, results = {}, {}
    for name, schemes in (("rwkv6", ("gumbel", "synthid")),
                          ("zamba2", ("gumbel",))):
        t0 = time.perf_counter()
        draft = init_params(drafts[name], seed=2, dtype=torch.bfloat16,
                            device=DEV)
        torch.cuda.synchronize()
        print(f"{name}: draft weights made in {time.perf_counter() - t0:.1f}"
              f" s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              "allocated")
        peaks = draft_logits_check(draft, prompts[:2])
        for wm in schemes:
            scfg = E.SpecConfig(K=K, watermark=wm,
                                temperature=REC_SLICE["temperature"])
            E.generate(target, draft, scfg, prompts[:, :8], n_tokens=6,
                       key=keys)                               # warm-up
            r, secs, launches = run_counted(lambda: E.generate(
                target, draft, scfg, prompts, n_tokens=n, key=keys))
            path = f"generate {name} {wm}"
            by_path[path] = launches
            check(bool(((r.lengths >= n) & (r.lengths <= n + K)).all()),
                  f"{path}: lengths {r.lengths}")
            check(bool(((r.tokens[:, :n] >= 0)
                        & (r.tokens[:, :n] < LLAMA_7B.vocab)).all()),
                  f"{path}: token out of range")
            check(0.0 <= r.aatps <= K, f"{path}: aatps {r.aatps}")
            d_cache = r.state["d_cache"]
            check(all(bool(torch.isfinite(d_cache[k].float()).all())
                      for k in REC_STATE_KEYS if k in d_cache),
                  f"{path}: non-finite draft state")
            results[path] = dict(
                seconds=secs, n_steps=r.n_steps,
                ms_per_step=secs / r.n_steps * 1e3,
                tokens_per_s=float(r.lengths.sum()) / secs, aatps=r.aatps,
                draft_state_bytes_per_slot=state_bytes(d_cache, len(keys)),
                draft_logit_peaks=peaks, launches=launches,
                profile=profile_generate(lambda: E.generate(
                    target, draft, scfg, prompts,
                    n_tokens=REC_PROFILE_TOKENS, key=keys, state=r.state)))
            print(f"{path}: " + json.dumps(results[path]))
        scfg = E.SpecConfig(K=K, watermark="gumbel",
                            temperature=REC_SLICE["temperature"])
        if name == "rwkv6":
            c = REC_SERVE
            reqs = serve_workload(21, c["n_requests"], c["prompt"],
                                  c["n_tokens"], LLAMA_7B.vocab, 64)
            base = serve_config(reqs, **{k: c[k] for k in (
                "batch", "page_size", "prefill_chunk", "sync_every")})
            cfg = ServeConfig(batch=base.batch, key=base.key,
                              page_size=base.page_size,
                              num_pages=base.num_pages,
                              prefill_chunk=base.prefill_chunk,
                              sync_every=base.sync_every, prefix_cache=False)
            path = "serve_requests rwkv6 paged"
        else:
            c = REC_DENSE_SERVE
            reqs = serve_workload(23, c["n_requests"], REC_SERVE["prompt"],
                                  REC_SERVE["n_tokens"], LLAMA_7B.vocab, 64)
            cfg = ServeConfig(batch=c["batch"], key=0xC0FFEE,
                              sync_every=c["sync_every"])
            path = "serve_requests zamba2 dense"
        t0 = time.perf_counter()
        E.serve_requests(target, draft, scfg,
                         [min(reqs, key=lambda r: len(r[0]))], config=cfg)
        warm_s = time.perf_counter() - t0
        stats = {}
        res, secs, launches = run_counted(lambda: E.serve_requests(
            target, draft, scfg, reqs, config=cfg, stats_out=stats))
        by_path[path] = launches
        check(len(res) == len(reqs), f"{path}: {len(res)} results")
        for r, (p, nt) in zip(res, reqs):
            check(nt <= r.length <= nt + K,
                  f"{path}: uid {r.uid} length {r.length}, target {nt}")
            check(bool(((r.tokens >= 0) & (r.tokens < LLAMA_7B.vocab)).all()),
                  f"{path}: token out of range")
        n_steps = int(stats["spec_steps"])
        n_tok = int(sum(r.length for r in res))
        results[path] = dict(
            seconds=secs, requests_per_s=len(res) / secs,
            tokens_per_s=n_tok / secs, tokens=n_tok,
            ttft_mean_s=stats["ttft_mean_s"], gap_p95_s=stats["gap_p95_s"],
            n_steps=n_steps, ms_per_step=secs / n_steps * 1e3,
            prefill_chunks=stats.get("prefill_chunks"),
            aatps=stats["aatps"], launches=launches,
            max_prompt=max(len(p) for p, _ in reqs), warmup_s=warm_s,
            profile=traced_serve(target, draft, scfg, reqs, cfg,
                                 rounds=REC_TRACE_ROUNDS))
        print(f"{path}: " + json.dumps(results[path]))
        del draft
        torch.cuda.empty_cache()
    print_ssd_launches(by_path)
    need = {"generate rwkv6 gumbel": ("wkv", "wkv_step"),
            "generate rwkv6 synthid": ("wkv", "wkv_step", "tournament_keyed",
                                       "spec_verify_wm_tournament"),
            "serve_requests rwkv6 paged": ("wkv", "wkv_step"),
            "generate zamba2 gumbel": ("ssd", "ssd_step"),
            "serve_requests zamba2 dense": ("ssd_step",)}
    for path, kernels in need.items():
        check(all(by_path[path][k] > 0 for k in kernels),
              f"{path}: a recurrent kernel never launched: {by_path[path]}")
        check(by_path[path]["ssd_scalar"] == 0,
              f"{path}: a model's chunks must run the tiled ssd kernel")
    return by_path, results


# ---------------------------------------------------------------------------
# Phase 4c: recurrent drafts, the CPU against the card, TINY target in fp32
# ---------------------------------------------------------------------------


def tiny_recurrent_drafts():
    """The reference's smoke sizes of the two drafts (configs.base.reduced:
    2 layers, d_model 256, ssm head_dim 32, d_state 16, a shared block every
    2 layers), with TINY_TARGET's vocab and ssm.chunk 8, so the prompts
    exceed the chunk (the ssd kernel and its per-timestep path both run)."""
    import dataclasses
    from repro_torch.configs import RWKV6_3B, TINY_TARGET, ZAMBA2_1_2B
    small = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                 d_ff=512, vocab=TINY_TARGET.vocab, head_dim=64)
    return {name: dataclasses.replace(
        cfg, name=cfg.name + "-smoke", **small,
        hybrid_attn_every=2 if cfg.arch_type == "hybrid" else
        cfg.hybrid_attn_every,
        ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=8))
        for name, cfg in (("rwkv6", RWKV6_3B), ("zamba2", ZAMBA2_1_2B))}


def phase_tiny_recurrent():
    """TINY_TARGET with each smoke draft in fp32: generate on the CPU
    (plain versions) against the card (kernels), serve_requests (paged
    for RWKV6, dense for Zamba2) on the CPU against the card, and on the
    card each served request against its solo generate; margin rows are
    counted.  Returns (margin rows, rows compared, launch counts)."""
    import torch
    from repro_torch.configs import TINY_TARGET
    from repro_torch.models.model import init_params
    from repro_torch.serve import divergence
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(17)
    prompts = torch.randint(1, TINY_TARGET.vocab, (4, 20), generator=g).numpy()
    # 24 tokens a generate row and 6 requests (were 40 and 8: cut to make
    # room for phase 8)
    reqs = serve_workload(19, 6, (4, 40), (8, 24), TINY_TARGET.vocab, 12)
    margin_rows = n_rows = 0
    counts = {}
    for name, dcfg in tiny_recurrent_drafts().items():
        cpu = [init_params(TINY_TARGET, seed=3, device="cpu"),
               init_params(dcfg, seed=5, device="cpu")]
        gpu = [init_params(TINY_TARGET, seed=3, device="cpu").to(DEV),
               init_params(dcfg, seed=5, device="cpu").to(DEV)]
        for wm in ("gumbel", "synthid"):
            scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
            rc = E.generate(*cpu, scfg, prompts, n_tokens=24, key=99)
            rg, _, launches = run_counted(lambda: E.generate(
                *gpu, scfg, prompts, n_tokens=24, key=99))
            counts[f"tiny generate {name} {wm}"] = launches
            for b in range(prompts.shape[0]):
                j = divergence.first_divergence(rc, rg, b)
                n_rows += 1
                if j is None:
                    continue
                marg = divergence.decision_margin(*cpu, scfg, prompts[b], rc,
                                                  b, j)
                check(marg < MARGIN_TOL, f"tiny {name} {wm}: row {b} parts "
                      f"at {j} with margin {marg}")
                margin_rows += 1
        scfg = E.SpecConfig(K=4, watermark="gumbel", temperature=0.7)
        mode = dict(page_size=4, num_pages=200, prefill_chunk=8) \
            if name == "rwkv6" else {}
        cfg = ServeConfig(batch=4, key=99, sync_every=3, **mode)
        sc = E.serve_requests(*cpu, scfg, reqs, config=cfg)
        sg, _, launches = run_counted(lambda: E.serve_requests(
            *gpu, scfg, reqs, config=cfg))
        counts[f"tiny serve_requests {name}"] = launches
        for a, b, (p, nt) in zip(sc, sg, reqs):
            tag = f"tiny serve {name} uid {a.uid}"
            margin_rows += compare_requests(a.as_generation_result(),
                                            b.as_generation_result(), cpu,
                                            scfg, p, tag)
            solo = E.generate(*gpu, scfg, p[None], n_tokens=nt, key=99)
            margin_rows += compare_requests(b.as_generation_result(), solo,
                                            gpu, scfg, p, tag + " vs solo")
            n_rows += 2
    print_ssd_launches(counts)
    for path, kernels in (("tiny generate rwkv6 gumbel", ("wkv", "wkv_step")),
                          ("tiny generate zamba2 gumbel", ("ssd", "ssd_step")),
                          ("tiny serve_requests rwkv6", ("wkv", "wkv_step")),
                          ("tiny serve_requests zamba2", ("ssd_step",))):
        check(all(counts[path][k] > 0 for k in kernels),
              f"{path}: a recurrent kernel never launched: {counts[path]}")
    print(f"tiny recurrent: margin rows {margin_rows} of {n_rows}")
    return margin_rows, n_rows, counts


# ---------------------------------------------------------------------------
# Phase 4b: serve_requests on the CPU against the card, TINY pair in fp32
# ---------------------------------------------------------------------------


def compare_requests(a, b, models, scfg, prompt, tag):
    """Two batch-1 GenerationResults of one request: 0 when equal
    (context hashes and coins included), 1 when they part at a decision
    whose margin is under MARGIN_TOL (a counted margin row); else fail."""
    from repro_torch.serve import divergence
    j = divergence.first_divergence(a, b, 0)
    if j is None:
        n = int(a.lengths[0])
        check(bool((a.ctx_hashes[:, :n] == b.ctx_hashes[:, :n]).all()
                   and (a.u[:, :n] == b.u[:, :n]).all()),
              f"{tag}: context hashes or coins differ")
        return 0
    marg = divergence.decision_margin(*models, scfg, prompt, a, 0, j)
    check(marg < MARGIN_TOL, f"{tag}: parts at {j} with margin {marg}")
    return 1


def phase_tiny_serve():
    """Paged and dense serving, gumbel and synthid: the card's requests
    equal the CPU's (tokens, provenance, context hashes, masks) outside
    counted margin rows, and on the card every served request equals its
    solo generate."""
    import torch
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = [init_params(c, seed=s, device="cpu")
           for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    gpu = [m.to(DEV) for m in (init_params(TINY_TARGET, seed=3, device="cpu"),
                               init_params(TINY_DRAFT, seed=4, device="cpu"))]
    # 7 requests (was 10: cut to make room for phase 8)
    reqs = serve_workload(9, 7, (4, 40), (8, 24), TINY_TARGET.vocab, 12)
    modes = {"dense": dict(),
             "paged": dict(page_size=4, num_pages=120, prefill_chunk=8,
                           prefix_cache=True)}
    margin_rows = n_rows = 0
    compare = compare_requests
    for wm in SERVE_SCHEMES:
        scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
        for mode, kw in modes.items():
            cfg = ServeConfig(batch=4, key=99, sync_every=3, **kw)
            rc = E.serve_requests(*cpu, scfg, reqs, config=cfg)
            rg = E.serve_requests(*gpu, scfg, reqs, config=cfg)
            for a, b, (p, n) in zip(rc, rg, reqs):
                tag = f"tiny serve {wm} {mode} uid {a.uid}"
                margin_rows += compare(a.as_generation_result(),
                                       b.as_generation_result(), cpu, scfg,
                                       p, tag)
                solo = E.generate(*gpu, scfg, p[None], n_tokens=n, key=99)
                margin_rows += compare(b.as_generation_result(), solo, gpu,
                                       scfg, p, tag + " vs solo")
                n_rows += 2
    print(f"tiny serve: margin rows {margin_rows} of {n_rows}")
    return margin_rows


# ---------------------------------------------------------------------------
# Phase 4: plain path (CPU) against kernel path (card), TINY pair in fp32
# ---------------------------------------------------------------------------


def phase_tiny():
    import torch
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.models.model import init_params
    from repro_torch.serve import divergence
    from repro_torch.serve import engine as E
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 products
    cpu = [init_params(c, seed=s, device="cpu")
           for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    gpu = [m.to(DEV) for m in (init_params(TINY_TARGET, seed=3, device="cpu"),
                               init_params(TINY_DRAFT, seed=4, device="cpu"))]
    g = torch.Generator(device="cpu").manual_seed(11)
    prompts = torch.randint(1, TINY_TARGET.vocab, (4, 12), generator=g).numpy()
    margin_rows = 0
    for wm in SCHEMES + ("none",):
        scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
        rc = E.generate(*cpu, scfg, prompts, n_tokens=48, key=99)
        rg = E.generate(*gpu, scfg, prompts, n_tokens=48, key=99)
        for b in range(prompts.shape[0]):
            j = divergence.first_divergence(rc, rg, b)
            if j is None:
                continue
            marg = divergence.decision_margin(*cpu, scfg, prompts[b], rc, b, j)
            check(marg < MARGIN_TOL, f"tiny {wm}: row {b} parts at {j} with "
                  f"margin {marg}")
            margin_rows += 1
        print(f"tiny {wm}: steps cpu {rc.n_steps} card {rg.n_steps}")
    print(f"tiny: margin rows {margin_rows} of {4 * (len(SCHEMES) + 1)}")
    return margin_rows


# ---------------------------------------------------------------------------
# Phase 5: the paper's measures on the card
# ---------------------------------------------------------------------------

MEASURE_KEY = 0xC0FFEE
MEASURE_SEEDS = 16384            # Def. 3.1 strength at V=32000
# the card-against-CPU runs: the plain tournament takes ~45 ns per entry
# and round on the CPU, so the synthid schemes compare at 256 contexts
CPU_STRENGTH_SEEDS = {"gumbel": 2048, "synthid": 256, "synthid-inf": 256}
STRENGTH_RTOL = 1e-4             # the CPU tests' tolerance (relative)
CURVE_ATOL = 1e-4                # ditto (absolute, curves)
CURVE_SCHEMES = ("gumbel", "synthid")
CURVE_KINDS = ("linear", "hu", "google")
FIG1_CPU = dict(n_seeds=4000, n_gamma=9, seed_chunk=2000)
TIERS = ("latency", "balanced", "assurance")
MEASURE_KERNELS = ("tournament", "gumbel_argmax", "spec_verify")


def next_token_probs(target):
    """The LLAMA_7B target's next-token distribution (V=32000, float32) on
    a fixed seeded prompt, at the slice's temperature."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(23)
    prompt = torch.randint(1, target.cfg.vocab, (1, 16), generator=g)
    logits, _ = target.prefill(prompt.to(DEV), 16)
    return torch.softmax(logits[0, -1].float() / SLICE["temperature"], -1)


def memo_dists(dist_fn):
    """dist_fn computing each (contexts, stream) batch once, so the
    estimators of one scheme read one set of P_ζ rows, which stay readable
    for the per-row comparison."""
    memo = {}

    def fn(probs, key, ctxs, stream):
        k = (len(ctxs), stream)
        if k not in memo:
            memo[k] = dist_fn(probs, key, ctxs, stream)
        return memo[k]

    fn.memo = memo
    return fn


def strengths(probs, seeds, memo=False):
    """Def. 3.1 strength of each scheme (watermark_strength and the
    entropy identity; check_unbiased for synthid) at ``seeds[name]``
    contexts on ``probs``'s device; with ``memo`` also each scheme's P_ζ
    rows (on the CPU)."""
    from repro_torch.core import strength as S
    from repro_torch.core.watermark import get_decoder
    out, rows = {}, {}
    for name in SCHEMES:
        dist = get_decoder(name).modified_dist
        if memo:
            dist = memo_dists(dist)
        n = seeds[name]
        r = dict(n_seeds=n,
                 ws=float(S.watermark_strength(dist, probs, MEASURE_KEY,
                                               n_seeds=n)),
                 ws_entropy=float(S.strength_via_entropy(
                     dist, probs, MEASURE_KEY, n_seeds=n)))
        if name == "synthid":
            r["unbiased_max_err"] = float(S.check_unbiased(
                dist, probs, MEASURE_KEY, n_seeds=n))
        out[name] = r
        if memo:
            rows[name] = next(iter(dist.memo.values())).cpu()
    return out, rows


def dist_margins(name, probs, ctxs):
    """The race (gumbel) or tournament-argmax (synthid-inf) margin of the
    P_ζ rows of contexts ``ctxs``, from the plain versions on the CPU."""
    from repro_torch.core import prf
    from repro_torch.kernels import ref
    n, V = len(ctxs), probs.shape[-1]
    seeds = prf.wm_seed(MEASURE_KEY, ctxs, prf.STREAM_DRAFT)
    if name == "gumbel":
        return ref.margin(ref.race_scores(probs.expand(n, V), seeds)[0])
    pn = probs / probs.sum()
    return ref.margin(ref.tournament_ref(pn.expand(n, V), seeds, m=30))


def compare_strengths(probs):
    """The estimators on the card against the CPU at CPU_STRENGTH_SEEDS:
    the P_ζ rows (synthid within the kernel tolerance; a degenerate
    scheme's tokens equal outside counted margin rows) and, for a scheme
    with no margin row, each estimate within STRENGTH_RTOL."""
    import torch
    gpu, rows_g = strengths(probs, CPU_STRENGTH_SEEDS, memo=True)
    cpu, rows_c = strengths(probs.cpu(), CPU_STRENGTH_SEEDS, memo=True)
    margin_rows = {}
    for name in SCHEMES:
        a, b = rows_g[name], rows_c[name]
        if name == "synthid":
            check(tol_ratio(a, b) <= 1.0,
                  f"strength {name}: card P_ζ rows differ from the CPU's")
            margin_rows[name] = 0
        else:
            differ = torch.nonzero(a.argmax(-1) != b.argmax(-1))[:, 0]
            marg = dist_margins(name, probs.cpu(), differ)
            check(bool((marg < MARGIN_TOL).all()),
                  f"strength {name}: card tokens part from the CPU's at "
                  f"contexts {differ.tolist()}, margins {marg.tolist()}")
            margin_rows[name] = len(differ)
        if margin_rows[name]:
            continue
        for k, v in cpu[name].items():
            check(abs(gpu[name][k] - v) <= STRENGTH_RTOL * abs(v) + 1e-7,
                  f"strength {name} {k}: card {gpu[name][k]} CPU {v}")
    return dict(card=gpu, cpu=cpu, margin_rows=margin_rows)


def fig1_curves(device, **kw):
    """Fig. 1's linear, Hu and Google curves of gumbel and synthid (the
    reference's defaults unless ``kw`` says otherwise; n_theta = n_gamma)
    and the reference points, on ``device``."""
    from repro_torch.core import tradeoff as T
    out = {}
    for name in CURVE_SCHEMES:
        for kind in CURVE_KINDS:
            if kind == "linear":
                c = T.linear_class_curve(name, device=device,
                                         n_theta=kw.get("n_gamma", 33), **kw)
            else:
                c = T.composed_class_curve(name, kind, device=device, **kw)
            out[f"{kind} {name}"] = c
    return out, T.reference_points(device=device)


def check_fig1(curves, refs):
    """Fig. 1's relations, by the reference tests' own means: finite
    curves; on the linear gumbel curve zero strength at γ=0 and Ent(P) at
    γ=1; Hu's efficiency at γ=0 the standard one; no curve above Alg. 1's
    point (1 − TV, Ent(P))."""
    import numpy as np
    for label, c in curves.items():
        check(bool(np.isfinite(c.efficiency).all()
                   and np.isfinite(c.strength).all()),
              f"fig1 {label}: non-finite curve")
    lin = curves["linear gumbel"]
    check(abs(lin.strength[0]) <= 1e-5,
          f"fig1: strength at γ=0 {lin.strength[0]}")
    check(abs(lin.strength[-1] - refs["max_strength"])
          <= 0.05 * refs["max_strength"],
          f"fig1: linear gumbel strength at γ=1 {lin.strength[-1]}, "
          f"Ent(P) {refs['max_strength']}")
    check(abs(curves["hu gumbel"].efficiency[0]
              - refs["std_spec_efficiency"]) <= 0.02,
          "fig1: Hu's efficiency at γ=0 is not the standard one")
    for label, c in curves.items():
        at = np.interp(refs["std_spec_efficiency"], c.efficiency[::-1],
                       c.strength[::-1])
        check(at <= refs["max_strength"] + 1e-5,
              f"fig1 {label}: above Alg. 1's point ({at})")


def endpoints(c):
    return dict(gamma0=[float(c.efficiency[0]), float(c.strength[0])],
                gamma1=[float(c.efficiency[-1]), float(c.strength[-1])])


def tiny_tiered_serve(models, device):
    """serve_requests of the TINY pair (dense, 4 slots) with requests of
    all three tiers through a synthid StrengthController whose curve is
    computed on ``device`` (n_seeds 20000, n_gamma 17)."""
    from repro_torch.configs import TINY_TARGET
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.keys import StrengthController
    reqs = [dict(prompt=p, n_tokens=n, uid=i, tier=TIERS[i % len(TIERS)])
            for i, (p, n) in enumerate(serve_workload(
                31, 9, (4, 40), (8, 24), TINY_TARGET.vocab, 12))]
    ctrl = StrengthController("synthid", device=device)
    scfg = E.SpecConfig(K=4, watermark="synthid", m=30, temperature=0.7)
    res = E.serve_requests(*models, scfg, reqs,
                           config=ServeConfig(batch=4, key=99, sync_every=3,
                                              strength_controller=ctrl))
    return res, ctrl, scfg, reqs


def tiny_detection(models, wm, device):
    """A generate of the TINY pair (B=6, 36 tokens), its detection records
    and null records of seeded random text, recovered on ``device``."""
    import numpy as np
    from repro_torch.configs import TINY_TARGET
    from repro_torch.core.detection import pipeline
    from repro_torch.serve import engine as E
    V = TINY_TARGET.vocab
    rng = np.random.default_rng(41)
    prompts = rng.integers(1, V, size=(6, 8))
    null_toks = rng.integers(1, V, size=(6, 36))
    scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
    dec = E.make_decoder(scfg)
    res = E.generate(*models, scfg, prompts, n_tokens=36, key=MEASURE_KEY)
    recs = pipeline.records_from_generation(res, dec, MEASURE_KEY, V,
                                            device=device)
    null = pipeline.null_records(null_toks, dec, MEASURE_KEY, V,
                                 device=device)
    return res, recs, null, scfg, prompts


def kernels_bench_path():
    """The calls of the micro-benchmark (the reference's
    benchmarks/kernels_bench.py) through the port's wrappers: the race and
    the unkeyed tournament at (8, 4096) and (4, 32000), the unkeyed verify
    at (8, 4, 4096); returns each call's median ms."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for B, V in ((8, 4096), (4, 32000)):
        probs = torch.softmax(torch.randn((B, V), generator=g, device=DEV),
                              -1)
        seeds = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
        out[f"gumbel_argmax B={B} V={V}"] = call_ms(
            lambda: ops.gumbel_argmax(probs, seeds), 10)
        out[f"tournament_m30 B={B} V={V}"] = call_ms(
            lambda: ops.tournament(probs, seeds, m=30), 10)
    B, K, V = 8, 4, 4096
    p = torch.softmax(torch.randn((B, K, V), generator=g, device=DEV), -1)
    q = torch.softmax(torch.randn((B, K, V), generator=g, device=DEV), -1)
    toks = torch.randint(0, V, (B, K), generator=g, device=DEV)
    u = torch.rand((B, K), generator=g, device=DEV)
    seeds = torch.randint(0, 2**32, (B, K), generator=g, device=DEV)
    out[f"spec_verify B={B} K={K} V={V}"] = call_ms(
        lambda: ops.spec_verify(p, q, toks, u, seeds), 10)
    return out


def compare_tiers(rc, rg, ctrl_c, ctrl_g, cpu, scfg, reqs):
    """Tiered serving on the card against the CPU: the controllers' curves
    within CURVE_ATOL and their picks equal (a pick may differ only where
    a curve point sits on the tier's floor within CURVE_ATOL); each
    request's γ equal and its tokens, provenance, hashes and coins equal
    outside counted margin rows."""
    import numpy as np
    eff_g = np.asarray(ctrl_g._get_curve().efficiency)
    eff_c = np.asarray(ctrl_c._get_curve().efficiency)
    check(float(np.abs(eff_g - eff_c).max()) <= CURVE_ATOL,
          "tiers: the controller's curve differs between card and CPU")
    picks, on_floor = {}, 0
    for t in TIERS:
        picks[t] = (ctrl_g.pick(t), ctrl_c.pick(t))
        if picks[t][0] != picks[t][1]:
            check(float(np.abs(eff_c - ctrl_c.tiers[t]).min()) <= CURVE_ATOL,
                  f"tiers: {t} picks γ {picks[t]} on the card and the CPU")
            on_floor += 1
    margin_rows = 0
    for a, b, r in zip(rc, rg, reqs):
        check(b.tier == r["tier"], f"tiers uid {b.uid}: tier {b.tier}")
        if a.strength != b.strength:
            check(on_floor > 0, f"tiers uid {a.uid}: γ {b.strength} on the "
                  f"card, {a.strength} on the CPU")
            continue
        margin_rows += compare_requests(
            a.as_generation_result(), b.as_generation_result(), cpu, scfg,
            r["prompt"], f"tiers uid {a.uid}")
    return dict(picks=picks, picks_on_floor=on_floor,
                gammas=sorted({r.strength for r in rg}),
                margin_rows=margin_rows, requests=len(rg))


def compare_detection(wm, got, want, cpu):
    """Detection records of a card generate against the CPU's: rows whose
    generation parts only at a counted near-tie are skipped; the others'
    records (and every null record) equal bitwise, and for gumbel their
    ARS scores within rtol 1e-6.  Returns (the card's scores, the AUC of
    the card's watermarked records against its null records, margin
    rows): Ars-τ for gumbel, Bayes-Prior with a ψ model fitted on the
    card for synthid."""
    import numpy as np
    from repro_torch.core.detection import gumbel_detect, records
    from repro_torch.core.detection import synthid_detect
    from repro_torch.serve import divergence
    res_g, recs_g, null_g, scfg, prompts = got
    res_c, recs_c, null_c, _, _ = want
    same, parted = [], 0
    for b in range(len(recs_g)):
        j = divergence.first_divergence(res_c, res_g, b)
        if j is not None:
            marg = divergence.decision_margin(*cpu, scfg, prompts[b], res_c,
                                              b, j)
            check(marg < MARGIN_TOL, f"detection {wm}: row {b} parts at {j}"
                  f" with margin {marg}")
            parted += 1
            continue
        same.append(b)
    fields = ("tokens", "y_draft", "y_target", "u", "src", "ctx")
    for b in same:
        check(all(np.array_equal(getattr(recs_c[b], f),
                                 getattr(recs_g[b], f)) for f in fields),
              f"detection {wm} row {b}: records differ from the CPU's")
    for a, c in zip(null_c, null_g):
        check(all(np.array_equal(getattr(a, f), getattr(c, f))
                  for f in fields), f"detection {wm}: null records differ")
    if wm == "gumbel":
        sg = gumbel_detect.scores_tau(recs_g, 0.5, 36)
        sc = gumbel_detect.scores_tau(recs_c, 0.5, 36)
        check(np.allclose(sg[same], sc[same], rtol=1e-6, atol=0),
              f"detection: ARS scores {sg} vs CPU {sc}")
        null = gumbel_detect.scores_tau(null_g, 0.5, 36)
    else:
        g = np.concatenate([r.y_draft[r.src == 1] for r in recs_g])
        psi = synthid_detect.fit_psi(g, 30, device=DEV)
        sg = synthid_detect.scores_prior(psi, recs_g, 0.5, 36)
        null = synthid_detect.scores_prior(psi, null_g, 0.5, 36)
    return sg, records.auc(sg, null), parted


def phase_measures(target):
    """Def. 3.1 strength of the LLAMA_7B target's next-token distribution,
    Fig. 1's curves at the reference's defaults, tiered serving and
    detection, each on the card and against the CPU where stated, and the
    micro-benchmark's calls.  Returns (launch counts per path, results)."""
    import numpy as np
    import torch
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.core import strength as S
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, out, secs = {}, {}, {}

    def counted(path, fn):
        res, secs[path], counts[path] = run_counted(fn)
        return res

    probs = next_token_probs(target)
    ent = float(S.entropy(probs))
    ws = counted("strength", lambda: strengths(
        probs, {k: MEASURE_SEEDS for k in SCHEMES})[0])
    for name, r in ws.items():
        check(all(np.isfinite(v) for v in r.values()),
              f"strength {name}: {r}")
        check(-0.05 * ent <= r["ws"] <= 1.05 * ent,
              f"strength {name}: {r['ws']} outside [0, Ent(P) = {ent}]")
        print(f"strength {name}: Ent(P) {ent} " + json.dumps(r))
    out["strength"] = dict(entropy=ent, card=ws,
                           vs_cpu=compare_strengths(probs))
    print("strength card vs CPU: " + json.dumps(out["strength"]["vs_cpu"]))

    curves, refs = counted("fig1", lambda: fig1_curves(DEV))
    check_fig1(curves, refs)
    out["fig1"] = dict(reference_points=refs, curves={
        k: endpoints(c) for k, c in curves.items()})
    for k, c in curves.items():
        print(f"fig1 {k}: " + json.dumps(endpoints(c)))
    print("fig1 reference points: " + json.dumps(refs))
    small_g, refs_g = fig1_curves(DEV, **FIG1_CPU)
    small_c, refs_c = fig1_curves("cpu", **FIG1_CPU)
    worst = max(float(np.abs(getattr(small_g[k], f)
                             - getattr(small_c[k], f)).max())
                for k in small_g for f in ("efficiency", "strength"))
    check(worst <= CURVE_ATOL, f"fig1 card vs CPU: max abs diff {worst}")
    check(all(abs(refs_g[k] - refs_c[k]) <= 1e-6 for k in refs_c),
          "fig1: reference points differ between card and CPU")
    out["fig1"]["card_vs_cpu_max_abs_diff"] = worst

    cpu = [init_params(c, seed=s, device="cpu")
           for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    gpu = [m.to(DEV) for m in (init_params(TINY_TARGET, seed=3, device="cpu"),
                               init_params(TINY_DRAFT, seed=4, device="cpu"))]
    rg, ctrl_g, scfg, reqs = counted("tiers synthid",
                                     lambda: tiny_tiered_serve(gpu, DEV))
    rc, ctrl_c, _, _ = tiny_tiered_serve(cpu, "cpu")
    out["tiers"] = compare_tiers(rc, rg, ctrl_c, ctrl_g, cpu, scfg, reqs)
    print("tiers: " + json.dumps(out["tiers"]))

    out["detection"] = {}
    for wm in ("gumbel", "synthid"):
        got = counted(f"detection {wm}", lambda: tiny_detection(gpu, wm, DEV))
        sg, auc, parted = compare_detection(
            wm, got, tiny_detection(cpu, wm, "cpu"), cpu)
        out["detection"][wm] = dict(auc_vs_null=auc, margin_rows=parted,
                                    scores=[float(x) for x in sg])
        print(f"detection {wm}: " + json.dumps(out["detection"][wm]))

    out["kernels_bench_ms"] = counted("kernels_bench", kernels_bench_path)
    for path, c in counts.items():
        print(f"measures {path}: {secs[path]:.2f} s, launches "
              + json.dumps({k: c[k] for k in MEASURE_KERNELS}))
    for path in ("strength", "fig1", "tiers synthid"):
        check(counts[path]["tournament"] > 0,
              f"{path}: the tournament kernel never launched")
    for path in ("strength", "fig1"):
        check(counts[path]["gumbel_argmax"] > 0,
              f"{path}: the race kernel never launched")
    check(counts["kernels_bench"]["spec_verify"] > 0,
          "kernels_bench: the verify kernel never launched")
    out["path_seconds"] = secs
    return counts, out


# ---------------------------------------------------------------------------
# Phase 6: training on the card
# ---------------------------------------------------------------------------

# zamba2-1.2b at full width (as recurrent_drafts() builds it: ssm.chunk 128,
# vocab 32000) in float32, the type the reference's fit trains in; S = 256
# puts each layer's forward through ssd over two chunks
TRAIN = dict(B=2, S=256, steps=3)
# the recurrences' gradients at full-width layer shapes: rwkv6-3b's WKV,
# zamba2-1.2b's chunked SSD (two chunks of 128) and its per-timestep scan
TRAIN_GRAD_CASES = (("wkv", dict(B=2, S=256, H=40, hd=64), 0),
                    ("ssd", dict(B=2, S=256, H=64, hd=64, N=64), 128),
                    ("ssd_scan", dict(B=2, S=64, H=64, hd=64, N=64), 0))
# the smoke configs' fit on the card against the CPU
TRAIN_CPU = dict(archs=("yi-6b", "rwkv6-3b", "zamba2-1.2b"), steps=5, B=2,
                 S=32, chunk=8, seed=3)
# each step's loss, card against CPU: AdamW's g / (|g| + eps) turns the
# last bits of a gradient near 0 into a visible step, and later losses
# inherit it (tests/test_torch_train.py holds the reference to the same)
TRAIN_LOSS_RTOL = 1e-4
# benchmarks/common.py's pair as repro_torch.train.pair trains it
# (target_cfg / draft_cfg, train_pair: 400 documents, B=16, S=64, 300
# steps), cached under artifacts/ for phase 7b's quickstart; AATPS as
# tab1_efficiency's Gumbel rows (8 prompts of 12 tokens, 48 tokens, K=4,
# temperature 0.5)
PAIR_STEPS = 300
PAIR_AATPS = dict(B=8, prompt=12, n_tokens=48, K=4, temperature=0.5, key=7)
ARTIFACTS = ROOT / "artifacts"


def train_grads():
    """The differentiable recurrences (ops.Replay: the kernel forward, the
    plain version replayed backward) against autograd straight through
    the plain version, at the full-width layer shapes: every input's
    gradient of Σ y² + Σ state² within ref.replay_grad_tol (the chunked
    kernel's output tolerance against the per-timestep replay: the larger
    of ssd_tol at its chunk and at 0).  One kernel launch each."""
    import torch
    from repro_torch.kernels import ops, ref
    out = {}
    for kernel, shape, chunk in TRAIN_GRAD_CASES:
        args = rec_inputs(kernel, shape, torch.float32, seed=sum(
            shape.values()))
        op = {"wkv": ops.wkv, "ssd_scan": ops.ssd_scan,
              "ssd": lambda *a: ops.ssd(*a, chunk=chunk)}[kernel]
        plain = ref.wkv_ref if kernel == "wkv" else ref.ssd_ref

        def grads(fn):
            xs = [a.clone().requires_grad_() for a in args]
            y, st = fn(*xs)
            return (y.detach(), st.detach()), torch.autograd.grad(
                (y ** 2).sum() + (st ** 2).sum(), xs)

        (outs, got), secs, launches = run_counted(lambda: grads(op))
        counted = REC_KERNEL.get(kernel, kernel)
        check(launches[counted] == 1 and sum(launches.values()) == 1,
              f"train grads {kernel}: launches {launches}")
        (_, want), plain_secs, _ = run_counted(lambda: grads(plain))
        tols = ref.wkv_tol(*args) if kernel == "wkv" else [
            torch.maximum(a, b) for a, b in zip(
                ref.ssd_tol(*args, chunk=chunk), ref.ssd_tol(*args))]
        bound = ref.replay_grad_tol(kernel, args, outs, tols)
        ratios = []
        for i, (g, w, b) in enumerate(zip(got, want, bound)):
            check(bool(torch.isfinite(g).all()),
                  f"train grads {kernel}: input {i} not finite")
            ratios.append(float(((g - w).abs() / b).max()))
            check(ratios[-1] <= 1.0, f"train grads {kernel}: input {i} "
                  f"{ratios[-1]:.3g} of its bound")
        out[kernel] = dict(shape=shape, err_over_tol=max(ratios),
                           max_abs_err=max(float((g - w).abs().max())
                                           for g, w in zip(got, want)),
                           seconds=secs, plain_seconds=plain_secs)
        print(f"train grads {kernel} {shape}: within "
              f"{max(ratios):.3g} of ref.replay_grad_tol; "
              f"{secs:.2f} s (plain autograd {plain_secs:.2f} s)")
    return out


def train_full_width():
    """zamba2-1.2b at full width in float32 (random weights, seed 6): 3
    make_train_step steps at B=2, S=256 on synthetic batches.  Every loss
    and gradient norm finite, every parameter moved, ssd launched once a
    layer a step.  -> (launch counts, results)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import loop as TT
    cfg = recurrent_drafts()["zamba2"]
    B, S, steps = TRAIN["B"], TRAIN["S"], TRAIN["steps"]
    check(cfg.ssm.chunk < S, f"S={S} must pass the chunk {cfg.ssm.chunk}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()       # held by earlier phases
    model = init_params(cfg, seed=6, device=DEV)
    n_params = sum(p.numel() for p in model.parameters())
    opt_cfg = adamw.AdamWConfig(total_steps=steps, warmup_steps=20)
    opt_state = adamw.init(dict(model.named_parameters()))
    step = TT.make_train_step(cfg, opt_cfg)
    before = {n: p.detach().flatten()[:4096].clone()
              for n, p in model.named_parameters()}
    stream = synthetic.token_stream(synthetic.SyntheticCorpus(), 300)
    it = synthetic.batches(stream, B, S, seed=0)
    batches = [{"tokens": torch.as_tensor(next(it)["tokens"],
                                          dtype=torch.int64, device=DEV)}
               for _ in range(steps)]
    torch.cuda.synchronize()
    ops.reset_launches()
    step_ms, metrics = [], []
    for batch in batches:
        t = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    for i, m in enumerate(metrics):
        check(all(math.isfinite(m[k]) for k in ("loss", "grad_norm")),
              f"train zamba2-1.2b step {i}: {m}")
    moved = sum(not torch.equal(before[n], p.detach().flatten()[:4096])
                for n, p in model.named_parameters())
    check(moved == len(before), f"train zamba2-1.2b: {moved} of "
          f"{len(before)} parameters moved")
    check(counts["ssd"] == cfg.n_layers * steps and counts["ssd_scalar"] == 0,
          f"train zamba2-1.2b: ssd launches {counts['ssd']}, want "
          f"{cfg.n_layers} a step (tiled) over {steps} steps")
    # where a step's time goes, one more step in its three parts: the
    # forward (ssd kernels), the backward (the per-timestep replay), AdamW
    params = dict(model.named_parameters())
    split = {}
    t = time.perf_counter()
    loss, _ = TT.lm_loss(model, batches[-1])
    torch.cuda.synchronize()
    split["forward_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    split["backward_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    adamw.apply(opt_cfg, params, dict(zip(params, grads)), opt_state)
    torch.cuda.synchronize()
    split["update_ms"] = (time.perf_counter() - t) * 1e3
    del loss, grads
    res = dict(n_params=n_params, B=B, S=S, steps=steps, step_ms=step_ms,
               split=split,
               tokens_per_s=[B * S / (ms / 1e3) for ms in step_ms],
               peak_bytes=peak, bytes_per_param=peak / n_params,
               bytes_held_before=base,
               losses=[m["loss"] for m in metrics],
               grad_norms=[m["grad_norm"] for m in metrics],
               ssd_launches_per_step=counts["ssd"] / steps)
    print(f"train zamba2-1.2b (full width, fp32, {n_params:,} params, B={B}, "
          f"S={S}): ms/step {[round(x, 1) for x in step_ms]}, tokens/s "
          f"{[round(x, 1) for x in res['tokens_per_s']]}, peak "
          f"{peak / 2**30:.2f} GiB ({peak / n_params:.1f} B/param), losses "
          f"{res['losses']}, grad norms {res['grad_norms']}, ssd launches "
          f"{counts['ssd']}; one more step in parts (ms): "
          f"{ {k: round(v, 1) for k, v in split.items()} }")
    del model, opt_state, step
    torch.cuda.empty_cache()
    return counts, res


def train_card_vs_cpu():
    """The smoke configs of yi-6b, rwkv6-3b and zamba2-1.2b (ssm.chunk 8,
    S=32: the ssd kernel over 4 chunks) in float32 from the same weights
    and batches: TRAIN_CPU["steps"] fit steps on the CPU (plain versions)
    and on the card (kernels), each step's loss within TRAIN_LOSS_RTOL.
    -> (launch counts by path, the largest relative loss difference)."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic
    from repro_torch.models.model import init_params
    from repro_torch.train import loop as TT
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = synthetic.token_stream(synthetic.SyntheticCorpus(), 60)
    c = TRAIN_CPU
    counts, worst = {}, {}
    for arch in c["archs"]:
        cfg = get_smoke_config(arch, vocab=synthetic.VOCAB)
        if cfg.ssm is not None and cfg.ssm.kind == "mamba2":
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, chunk=c["chunk"]))
        tree = convert.to_jax_tree(init_params(cfg, seed=c["seed"],
                                               device="cpu"))

        def fit(dev):
            return TT.fit(cfg, synthetic.batches(stream, c["B"], c["S"],
                                                 seed=c["seed"]),
                          steps=c["steps"], params=tree, device=dev,
                          verbose=False)[1]

        want = fit("cpu")
        got, _, launches = run_counted(lambda: fit(DEV))
        path = f"train card vs CPU {cfg.name}"
        counts[path] = launches
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        worst[cfg.name] = max(rel)
        check(max(rel) <= TRAIN_LOSS_RTOL, f"{path}: losses {got} against "
              f"{want}")
        print(f"{path}: losses card {got} cpu {want}, max rel "
              f"{max(rel):.3g}, launches wkv {launches['wkv']} ssd "
              f"{launches['ssd']} ssd_step {launches['ssd_step']}")
    for path, kernel in (("rwkv6-3b-smoke", "wkv"),
                         ("zamba2-1.2b-smoke", "ssd")):
        n = counts[f"train card vs CPU {path}"][kernel]
        check(n == 2 * c["steps"], f"{path}: {kernel} launches {n}")
    return counts, worst


def train_pair():
    """The examples' pair (``repro_torch.train.pair.train_pair``) trained
    on the card, forced, into ARTIFACTS; the loss must fall, as
    examples/train_multiarch.py asserts.  Then Gumbel K=4 AATPS of the
    untrained and the trained pair (printed, not gated).  -> (launch counts
    of the trained pair's generate, results)."""
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    from repro_torch.train import pair
    stats = {}
    tcfg, dcfg, *trained, cp = pair.train_pair(
        PAIR_STEPS, force=True, cache_dir=str(ARTIFACTS), device=DEV,
        stats_out=stats)
    res = {}
    for name, cfg in (("target", tcfg), ("draft", dcfg)):
        hist, secs = stats[name]["losses"], stats[name]["seconds"]
        check(hist[-1] < hist[0], f"train pair {name}: loss {hist[0]} -> "
              f"{hist[-1]} did not fall")
        res[name] = dict(first_loss=hist[0], last_loss=hist[-1],
                         seconds=secs, ms_per_step=secs / PAIR_STEPS * 1e3)
        print(f"train pair {name} ({cfg.n_layers} layers, d "
              f"{cfg.d_model}): loss {hist[0]:.4f} -> {hist[-1]:.4f} over "
              f"{PAIR_STEPS} steps, {secs:.1f} s")
    a = PAIR_AATPS
    prompts = pair.bench_prompts(cp, a["B"], seq=a["prompt"])
    scfg = E.SpecConfig(K=a["K"], watermark="gumbel",
                        temperature=a["temperature"])
    untrained = [init_params(tcfg, seed=0, device=DEV),
                 init_params(dcfg, seed=1, device=DEV)]
    r0 = E.generate(*untrained, scfg, prompts, n_tokens=a["n_tokens"],
                    key=a["key"])
    r1, _, launches = run_counted(lambda: E.generate(
        *trained, scfg, prompts, n_tokens=a["n_tokens"], key=a["key"]))
    res.update(aatps_untrained=r0.aatps, aatps_trained=r1.aatps)
    print(f"train pair: Gumbel K={a['K']} AATPS untrained {r0.aatps:.4f}, "
          f"trained {r1.aatps:.4f}")
    return {"trained pair generate": launches}, res


def phase_train():
    """Training on the card: the recurrences' gradients at full-width
    layer shapes, zamba2-1.2b's full-width train steps, the smoke configs'
    fit on the card against the CPU, and the benchmark pair trained.
    -> (launch counts by path, results)."""
    counts, res = {}, {}
    res["grads"] = train_grads()
    zc, res["zamba2_full_width"] = train_full_width()
    counts["train zamba2-1.2b"] = zc
    cc, res["card_vs_cpu_max_rel"] = train_card_vs_cpu()
    counts.update(cc)
    pc, res["pair"] = train_pair()
    counts.update(pc)
    return counts, res


# ---------------------------------------------------------------------------
# Phase 7b: the serving launcher and the examples, each its own process
# ---------------------------------------------------------------------------

# the launcher's replay: 4 slots of the yi-6b smoke pair (K=3); prompts of
# up to 40 tokens, half opening with a 32-token system prompt (two pages of
# 16), at most 32 tokens: 171 positions, 11 pages a slot at the doubled
# horizon, so 80 pages hold the slots and the prefix cache
LAUNCH_PAGES = 80
LAUNCH_TIMEOUT = 300


def launch_requests():
    """The replay's JSONL lines: token prompts (every other one opening
    with the system prompt), a text line with a tier, one with an explicit
    key and uid."""
    import numpy as np
    rng = np.random.default_rng(11)
    system = rng.integers(3, 256, 32).tolist()
    lines = []
    for i in range(6):
        tail = rng.integers(3, 256, int(rng.integers(4, 9))).tolist()
        lines.append({"tokens": (system if i % 2 else []) + tail,
                      "n_tokens": int(rng.integers(12, 33))})
    lines.append({"text": "the quick brown fox", "n_tokens": 24,
                  "tier": "balanced"})
    lines.append({"tokens": system + [7, 9, 11], "n_tokens": 20,
                  "key": 1234, "uid": 99})
    return lines


def phase_launch():
    """``python -m repro_torch.launch.serve`` on a JSONL replay (stream,
    overlap, paged, prefix cache, key pool, a tier line) and without
    --requests, ``repro_torch.examples.tradeoff_curves`` and
    ``quickstart`` (on phase 6's pair, from its cache), all at once, each
    in its own process on the card; each must exit 0 and print its report
    lines.  -> results."""
    import os
    import re
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    py = [sys.executable, "-m"]
    dev = [] if DEV == "cuda" else ["--device", DEV]   # the default: cuda
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "requests.jsonl"
        path.write_text("".join(json.dumps(r) + "\n"
                                for r in launch_requests()))
        runs = {
            "launch.serve replay": py + [
                "repro_torch.launch.serve", "--requests", str(path),
                "--stream", "--overlap", "--page-size", "16",
                "--num-pages", str(LAUNCH_PAGES), "--prefix-cache",
                "--key-pool", "4"] + dev,
            "launch.serve generate": py + ["repro_torch.launch.serve"] + dev,
            "examples.tradeoff_curves": py + [
                "repro_torch.examples.tradeoff_curves"] + dev,
            "examples.quickstart": py + [
                "repro_torch.examples.quickstart", "--cache-dir",
                str(ARTIFACTS)] + dev,
        }
        t = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
                 for name, cmd in runs.items()}
        outs = {}
        try:
            for name, proc in procs.items():
                out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
                outs[name] = (proc.returncode, out, err,
                              time.perf_counter() - t)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    want = {"launch.serve replay": (
                r"continuous batching paged\(page_size=16, num_pages="
                rf"{LAUNCH_PAGES}, prefix-cache\) key-pool=4: 8 requests "
                r"over 4 slots \[overlap\]", r"AATPS=[0-9.]+ tokens=\d+",
                r"TTFT mean=", r"prefix cache: hits=[1-9]",
                r"tier=balanced", r"req 99: \d+ tokens key=000004d2"),
            "launch.serve generate": (r"AATPS=[0-9.]+ tokens/step=",
                                      r"sample bytes:"),
            "examples.tradeoff_curves": (r"> sampling efficiency",),
            "examples.quickstart": (r"AUC = [0-9.]+", r"AATPS")}
    res = {}
    for name, (rc, out, err, secs) in outs.items():
        check(rc == 0, f"{name}: exit {rc}\n{out[-2000:]}\n{err[-4000:]}")
        for pat in want[name]:
            check(re.search(pat, out), f"{name}: no line matching {pat!r} "
                  f"in\n{out[-3000:]}")
        lines = [ln for ln in out.splitlines()
                 if not ln.startswith("  stream ")]
        res[name] = dict(seconds_by=secs, report=lines[-8:])
        print(f"{name}: exit 0, done {secs:.1f} s after the four started")
        for ln in lines[-8:]:
            print("  | " + ln)
    replay = outs["launch.serve replay"][1]
    tokens = int(re.search(r"AATPS=[0-9.]+ tokens=(\d+)", replay).group(1))
    n_stream = len(re.findall(r"^  stream uid=", replay, re.M))
    check(n_stream == tokens, f"launch.serve replay: {n_stream} streamed "
          f"tokens, {tokens} served")
    check(not re.search(r"step +\d+ loss=", outs["examples.quickstart"][1]),
          "quickstart trained its pair again instead of loading phase 6's")
    return res


# ---------------------------------------------------------------------------
# Phase 8: the other families (MoE, sliding window, VLM, audio, sqrelu)
# ---------------------------------------------------------------------------

# bf16, random weights from seeds, K=4, T=0.7; depth cuts are listed here
# and in PERF.md §4
FAM = dict(K=4, temperature=0.7)
OLMOE_GEN = dict(B=4, prompt=16, n_tokens=48)
OLMOE_SERVE = dict(n_requests=16, prompt=(16, 128), system=32,
                   n_tokens=(16, 32), alone=2)
SWA_SERVE = dict(n_requests=4, prompt=(4300, 4500), n_tokens=32, batch=4,
                 prefill_chunk=256)
SWA_GEN = dict(B=2, prompt=4300, n_tokens=32)
VLM_GEN = dict(B=2, prompt=16, n_tokens=32)
CUT_DEPTH = {"nemotron-4-340b": 1, "kimi-k2-1t-a32b": 1}   # full width
CUT_SERVE = dict(n_requests=4, prompt=(16, 48), n_tokens=16, batch=4)
FAM_KERNELS = ("spec_verify_wm", "spec_verify_wm_tournament",
               "gumbel_argmax", "tournament_keyed", "paged_attention")


def fam_models(name, n_layers=None):
    """The arch's config (depth cut to ``n_layers`` where given) with
    ``draft_for``'s draft (under the target's window), bf16 on the card,
    seeds 0 and 1 -> (target, draft)."""
    import dataclasses
    import torch
    from repro_torch.configs import draft_for, get_config
    from repro_torch.models.model import init_params
    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    target = init_params(cfg, seed=0, dtype=torch.bfloat16, device=DEV)
    draft = init_params(draft_for(cfg, window=cfg.window), seed=1,
                        dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in target.parameters())
    print(f"{name}: {cfg.n_layers} layers, {n / 1e9:.3f} B parameters "
          f"(config {cfg.param_count() / 1e9:.3f} B, active "
          f"{cfg.active_param_count() / 1e9:.3f} B), made in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return target, draft


def fam_frames(cfg, B, dtype, device):
    """The stub frontends' frame embeddings of an audio / VLM target
    (None for the text families)."""
    from repro_torch.models.model import example_batch, extras_of
    return extras_of(example_batch(cfg, B, 1, seed=3, dtype=dtype,
                                   device=device))


def fam_generate(path, target, draft, wm, prompts, n, extras=None):
    """A warm-up, then ``generate`` counted -> (result, numbers,
    launches)."""
    from repro_torch.serve import engine as E
    scfg = E.SpecConfig(K=FAM["K"], watermark=wm,
                        temperature=FAM["temperature"])
    keys = [0x1234 + i for i in range(prompts.shape[0])]
    E.generate(target, draft, scfg, prompts[:, :8], n_tokens=4, key=keys,
               extras=extras)
    r, secs, launches = run_counted(lambda: E.generate(
        target, draft, scfg, prompts, n_tokens=n, key=keys, extras=extras))
    V = target.cfg.vocab
    check(bool(((r.lengths >= n) & (r.lengths <= n + FAM["K"])).all()),
          f"{path}: lengths {r.lengths}")
    check(bool(((r.tokens[:, :n] >= 0) & (r.tokens[:, :n] < V)).all()),
          f"{path}: token out of range")
    out = dict(seconds=secs, n_steps=r.n_steps,
               ms_per_step=secs / r.n_steps * 1e3,
               tokens_per_s=float(r.lengths.sum()) / secs, aatps=r.aatps,
               launches={k: launches[k] for k in FAM_KERNELS})
    print(f"{path}: " + json.dumps(out))
    return r, out, launches


def fam_serve(path, target, draft, reqs, cfg, wm="gumbel"):
    """A warm-up, then paged ``serve_requests`` counted; the pool must
    drain to what the prefix cache holds -> (results, numbers, launches,
    the SpecConfig)."""
    from repro_torch.serve import engine as E
    scfg = E.SpecConfig(K=FAM["K"], watermark=wm,
                        temperature=FAM["temperature"])
    E.serve_requests(target, draft, scfg, reqs[:1], config=cfg)
    stats = {}
    res, secs, launches = run_counted(lambda: E.serve_requests(
        target, draft, scfg, reqs, config=cfg, stats_out=stats))
    V = target.cfg.vocab
    check(len(res) == len(reqs), f"{path}: {len(res)} results")
    for r, (p, nt) in zip(res, reqs):
        check(nt <= r.length <= nt + FAM["K"],
              f"{path}: uid {r.uid} length {r.length}, target {nt}")
        check(bool(((r.tokens >= 0) & (r.tokens < V)).all()),
              f"{path}: token out of range")
    check(stats["pages_used"] == stats["prefix_pages"],
          f"{path}: {stats['pages_used']} pages used at the end, "
          f"{stats['prefix_pages']} held by the prefix cache")
    check(launches["paged_attention"] > 0,
          f"{path}: paged_attention never launched")
    n_steps = int(stats["spec_steps"])
    n_tok = int(sum(r.length for r in res))
    out = dict(seconds=secs, requests_per_s=len(res) / secs,
               tokens_per_s=n_tok / secs, tokens=n_tok, n_steps=n_steps,
               ms_per_step=secs / n_steps * 1e3,
               ttft_mean_s=stats["ttft_mean_s"],
               prefill_chunks=int(stats["prefill_chunks"]),
               aatps=stats["aatps"], pages_peak=stats["pages_peak"],
               num_pages=cfg.num_pages,
               launches={k: launches[k] for k in FAM_KERNELS})
    print(f"{path}: " + json.dumps(out))
    return res, out, launches, scfg


def olmoe_full(by_path, results):
    """olmoe-1b-7b at full width and depth: generate (gumbel, synthid),
    the prefill's dropped share, paged serving with a prefix cache, and
    requests served alone equal to the same requests in the batch."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import engine as E
    target, draft = fam_models("olmoe-1b-7b")
    cfg = target.cfg
    g = torch.Generator(device="cpu").manual_seed(31)
    prompts = torch.randint(1, cfg.vocab, (OLMOE_GEN["B"],
                                           OLMOE_GEN["prompt"]),
                            generator=g).numpy()
    for wm in ("gumbel", "synthid"):
        path = f"olmoe-1b-7b generate {wm}"
        _, results[path], by_path[path] = fam_generate(
            path, target, draft, wm, prompts, OLMOE_GEN["n_tokens"])
    target.prefill(torch.as_tensor(prompts, device=DEV), prompts.shape[1])
    drop = float(target.last_aux["dropped_frac"])
    T = int(prompts.size)
    results["olmoe-1b-7b prefill"] = dict(
        dropped_frac=drop, tokens=T, capacity=moe.capacity(T, cfg.moe))
    print(f"olmoe-1b-7b prefill: B={OLMOE_GEN['B']} x "
          f"{OLMOE_GEN['prompt']} tokens, capacity "
          f"{moe.capacity(T, cfg.moe)}, dropped_frac {drop:.4f} (mean over "
          "the layers; serving's extend is dropless)")
    c = OLMOE_SERVE
    reqs = serve_workload(41, c["n_requests"], c["prompt"], c["n_tokens"],
                          cfg.vocab, c["system"])
    conf = serve_config(reqs)
    path = "olmoe-1b-7b serve_requests paged"
    res, results[path], by_path[path], scfg = fam_serve(
        path, target, draft, reqs, conf)
    # a request served alone (the same slots, the others idle) against the
    # batch: admission and extend are dropless, so no row sees another
    margin = 0
    for i in range(c["alone"]):
        alone = E.serve_requests(target, draft, scfg, [reqs[i]],
                                 config=conf)[0]
        margin += compare_requests(res[i].as_generation_result(),
                                   alone.as_generation_result(),
                                   (target, draft), scfg, reqs[i][0],
                                   f"{path} uid {i} alone")
    results[path]["alone_margin_rows"] = margin
    print(f"{path}: {c['alone']} requests alone equal the batch outside "
          f"{margin} margin rows")
    return target, draft


def swa_full(by_path, results):
    """yi-6b-swa4k at full width and depth with prompts past its window:
    paged serving (chunks of 256, a table wider than 4096 positions) and
    generate."""
    import numpy as np
    import torch
    from repro_torch.serve.config import ServeConfig
    target, draft = fam_models("yi-6b-swa4k")
    cfg = target.cfg
    c = SWA_SERVE
    rng = np.random.default_rng(43)
    reqs = [(rng.integers(1, cfg.vocab, int(rng.integers(*c["prompt"])))
             .astype(np.int32), c["n_tokens"])
            for _ in range(c["n_requests"])]
    base = serve_config(reqs, batch=c["batch"],
                            prefill_chunk=c["prefill_chunk"])
    conf = ServeConfig(batch=base.batch, key=base.key,
                       page_size=base.page_size, num_pages=base.num_pages,
                       prefill_chunk=base.prefill_chunk,
                       sync_every=base.sync_every, prefix_cache=True)
    max_pos = max(len(p) for p, _ in reqs) + c["n_tokens"]
    check(max_pos > cfg.window, "yi-6b-swa4k: the rows must pass the window")
    path = "yi-6b-swa4k serve_requests paged"
    _, results[path], by_path[path], _ = fam_serve(path, target, draft,
                                                   reqs, conf)
    g = torch.Generator(device="cpu").manual_seed(44)
    prompts = torch.randint(1, cfg.vocab, (SWA_GEN["B"], SWA_GEN["prompt"]),
                            generator=g).numpy()
    path = "yi-6b-swa4k generate gumbel"
    _, results[path], by_path[path] = fam_generate(
        path, target, draft, "gumbel", prompts, SWA_GEN["n_tokens"])
    return target, draft


def frames_full(name, wm, by_path, results):
    """A VLM / audio target at full size through generate(extras=...)."""
    import torch
    target, draft = fam_models(name)
    cfg = target.cfg
    g = torch.Generator(device="cpu").manual_seed(45)
    prompts = torch.randint(1, cfg.vocab, (VLM_GEN["B"], VLM_GEN["prompt"]),
                            generator=g).numpy()
    path = f"{name} generate {wm}"
    _, results[path], by_path[path] = fam_generate(
        path, target, draft, wm, prompts, VLM_GEN["n_tokens"],
        extras=fam_frames(cfg, VLM_GEN["B"], torch.bfloat16, DEV))
    return target, draft


def cut_full(name, by_path, results):
    """Full width, depth cut (``CUT_DEPTH``): paged serving of 4 requests
    and a short generate."""
    import torch
    target, draft = fam_models(name, CUT_DEPTH[name])
    cfg = target.cfg
    c = CUT_SERVE
    reqs = serve_workload(47, c["n_requests"], c["prompt"],
                          (c["n_tokens"], c["n_tokens"]), cfg.vocab, 16)
    path = f"{name} serve_requests paged"
    _, results[path], by_path[path], _ = fam_serve(
        path, target, draft, reqs, serve_config(reqs, batch=c["batch"]))
    g = torch.Generator(device="cpu").manual_seed(46)
    prompts = torch.randint(1, cfg.vocab, (2, 16), generator=g).numpy()
    path = f"{name} generate gumbel"
    _, results[path], by_path[path] = fam_generate(
        path, target, draft, "gumbel", prompts, c["n_tokens"])
    return target, draft


def fam_smoke_pairs():
    """The CPU and card copies (fp32, the same seeds) of the smoke pairs:
    olmoe's (an MoE draft too), yi-6b-swa4k's with its window cut to 8 so
    it binds, and the VLM's and the audio model's with a dense draft."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    V = 256
    small = dict(vocab=V, n_layers=1, d_model=64, d_ff=128, n_heads=2,
                 n_kv_heads=2, head_dim=32)
    pairs = {
        "olmoe": (get_smoke_config("olmoe-1b-7b", vocab=V),
                  get_smoke_config("olmoe-1b-7b", **small)),
        "yi-6b-swa4k": (get_smoke_config("yi-6b-swa4k", vocab=V, window=8),
                        get_smoke_config("yi-6b-swa4k", window=8, **small)),
        "vlm": (get_smoke_config("llama-3.2-vision-11b", vocab=V),
                get_smoke_config("yi-6b", **small)),
        "audio": (get_smoke_config("whisper-tiny", vocab=V),
                  get_smoke_config("yi-6b", **small))}
    return {name: ([init_params(c, seed=s, device="cpu")
                    for c, s in ((tc, 5), (dc, 6))],
                   [init_params(c, seed=s, device="cpu").to(DEV)
                    for c, s in ((tc, 5), (dc, 6))])
            for name, (tc, dc) in pairs.items()}


def expert_choices(model, tokens):
    """The expert ids each MoE layer of ``model``'s prefill picks, and the
    near-tie flags of their rows (the k-th and (k+1)-th router
    probabilities within 1e-6)."""
    import torch
    from repro_torch.models import moe, transformer
    seen = []
    real = transformer.apply_moe

    def spy(params, cfg, x, act, **kw):
        probs, _, eids = moe.route(x.reshape(-1, x.shape[-1]),
                                   params["router"], cfg.top_k)
        top = torch.sort(probs, -1, descending=True).values
        gap = (top[:, :cfg.top_k] - top[:, 1:cfg.top_k + 1]).abs()
        seen.append((eids.cpu(), (gap.min(-1).values < 1e-6).cpu()))
        return real(params, cfg, x, act, **kw)

    transformer.apply_moe = spy
    try:
        model.prefill(tokens.to(model.embed.device), tokens.shape[1])
    finally:
        transformer.apply_moe = real
    return seen


def phase_families_tiny():
    """The smoke pairs on the CPU (plain versions) and on the card
    (kernels) in fp32: generate (olmoe, yi-6b-swa4k, VLM, audio) and paged
    serve_requests (olmoe, yi-6b-swa4k), tokens equal outside counted
    margin rows; olmoe's expert choice equal outside near-tie rows."""
    import numpy as np
    import torch
    from repro_torch.serve import divergence
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = fam_smoke_pairs()
    prompts = np.random.default_rng(17).integers(1, 256, (3, 12))
    margin = rows = 0
    for name, (cpu, gpu) in pairs.items():
        scfg = E.SpecConfig(K=4, watermark="gumbel", temperature=0.7)
        ex_c = fam_frames(cpu[0].cfg, 3, torch.float32, "cpu")
        ex_g = None if ex_c is None else {k: v.to(DEV)
                                          for k, v in ex_c.items()}
        rc = E.generate(*cpu, scfg, prompts, n_tokens=24, key=99,
                        extras=ex_c)
        rg = E.generate(*gpu, scfg, prompts, n_tokens=24, key=99,
                        extras=ex_g)
        for b in range(3):
            j = divergence.first_divergence(rc, rg, b)
            rows += 1
            if j is None:
                continue
            row_ex = None if ex_c is None else {
                k: v[b:b + 1] for k, v in ex_c.items()}
            marg = divergence.decision_margin(*cpu, scfg, prompts[b], rc, b,
                                              j, extras=row_ex)
            check(marg < MARGIN_TOL, f"families tiny {name}: row {b} parts "
                  f"at {j} with margin {marg}")
            margin += 1
        if name in ("olmoe", "yi-6b-swa4k"):
            reqs = [(p, 16) for p in prompts] + [(prompts[0, :5], 12)]
            conf = ServeConfig(batch=2, key=99, page_size=4, num_pages=60,
                               prefill_chunk=4, sync_every=3)
            sc = E.serve_requests(*cpu, scfg, reqs, config=conf)
            sg = E.serve_requests(*gpu, scfg, reqs, config=conf)
            for a, b, (p, _) in zip(sc, sg, reqs):
                margin += compare_requests(
                    a.as_generation_result(), b.as_generation_result(), cpu,
                    scfg, p, f"families tiny {name} serve uid {a.uid}")
                rows += 1
    ids_c = expert_choices(pairs["olmoe"][0][0], torch.as_tensor(prompts))
    ids_g = expert_choices(pairs["olmoe"][1][0], torch.as_tensor(prompts))
    near = differ = 0
    for (ec, nc), (eg, ng) in zip(ids_c, ids_g):
        tie = nc | ng
        near += int(tie.sum())
        differ += int(((ec != eg).any(-1) & ~tie).sum())
    check(differ == 0, f"families tiny olmoe: {differ} rows pick other "
          "experts on the card outside near-ties")
    out = dict(margin_rows=margin, rows=rows, expert_near_tie_rows=near,
               expert_rows=sum(len(e) for e, _ in ids_c))
    print(f"families tiny: margin rows {margin} of {rows}; olmoe expert "
          f"choice equal, near-tie rows {near} of {out['expert_rows']}")
    return out


def phase_families():
    """Phase 8: each family's full-size runs in turn (each pair freed
    before the next), then the smoke pairs card against CPU.  Returns the
    launch counts by path and the results; every path must have launched
    the fused tail, and every serving path the paged kernel."""
    import torch
    by_path, results = {}, {}
    runs = [lambda: olmoe_full(by_path, results),
            lambda: swa_full(by_path, results),
            lambda: frames_full("llama-3.2-vision-11b", "gumbel", by_path,
                                results),
            lambda: frames_full("whisper-tiny", "synthid", by_path, results),
            lambda: cut_full("nemotron-4-340b", by_path, results),
            lambda: cut_full("kimi-k2-1t-a32b", by_path, results)]
    for run in runs:
        t = time.perf_counter()
        models = run()
        del models
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"  ({time.perf_counter() - t:.1f} s)")
    results["tiny"] = phase_families_tiny()
    for path, c in by_path.items():
        check(c["spec_verify_wm"] + c["spec_verify_wm_tournament"] > 0,
              f"{path}: the fused tail never launched")
        if "serve_requests" in path:
            check(c["paged_attention"] > 0,
                  f"{path}: paged_attention never launched")
    return by_path, results


# ---------------------------------------------------------------------------
# Phase 9: multi-device serving (sharding.spmd over torch.distributed)
# ---------------------------------------------------------------------------

MESH = dict(B=4, prompt=16, n_tokens=16, K=4, temperature=0.7)
MESH_KEYS = [0x1234, 0xDEADBEEF, 7, 2**31 + 5]
MESH_SCHEMES = ("gumbel", "synthid")
# the ranks' TINY cells are most of phase 9's time (gloo stages every
# collective through the host): 5 requests keep one queued past the 4 slots
MESH_TINY = dict(B=4, prompt=12, n_tokens=12, meshes=((2, 1), (1, 2)),
                 n_requests=5, serve_prompt=(4, 24), serve_tokens=(6, 14))
MESH_TINY_SERVE = {"dense": dict(),
                   "paged": dict(page_size=4, num_pages=120, prefill_chunk=8,
                                 prefix_cache=True)}
# the tensor-parallel bf16 logits against the unsharded run's: each of the
# 2 x 32 row-parallel sums of a LLAMA_7B forward (attention out, FFN out)
# rounds to bf16 twice (each rank's partial, then their sum) where the
# unsharded product rounds once; the bound allows one unit of bf16's
# 2^-8 a sum, of the row's largest |logit|
MESH_LOGIT_RTOL = 2 * 32 * 2.0 ** -8
MESH_FIELDS = ("tokens", "lengths", "from_draft", "u", "ctx_hashes",
               "masked", "y_draft", "y_target", "keys")


def mesh_prompts(B, S, vocab, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(1, vocab, (B, S), generator=g).numpy()


def tiny_mesh_pair():
    """The TINY pair in fp32 from seeds 3 and 4, made on the CPU and moved
    to the card: the same weights in every process."""
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.models.model import init_params
    return [init_params(c, seed=s, device="cpu").to(DEV)
            for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]


def tiny_mesh_runs(t, d, mesh=None):
    """The TINY cells of phase 9 (generate gumbel / synthid, serving dense
    / paged, gumbel): {cell: result}, with each cell's launch counts."""
    from repro_torch.configs import TINY_TARGET
    from repro_torch.kernels import ops
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    c = MESH_TINY
    prompts = mesh_prompts(c["B"], c["prompt"], TINY_TARGET.vocab, 11)
    reqs = serve_workload(9, c["n_requests"], c["serve_prompt"],
                          c["serve_tokens"], TINY_TARGET.vocab, 12)
    out, counts, secs = {}, {}, {}
    for wm in MESH_SCHEMES:
        scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
        ops.reset_launches()
        t0 = time.perf_counter()
        out[wm] = E.generate(t, d, scfg, prompts, n_tokens=c["n_tokens"],
                             key=99, mesh=mesh)
        secs[wm] = time.perf_counter() - t0
        counts[wm] = dict(ops.LAUNCHES)
    scfg = E.SpecConfig(K=4, watermark="gumbel", m=30, temperature=0.7)
    for mode, kw in MESH_TINY_SERVE.items():
        ops.reset_launches()
        t0 = time.perf_counter()
        out[mode] = E.serve_requests(t, d, scfg, reqs, config=ServeConfig(
            batch=4, key=99, sync_every=3, mesh=mesh, **kw))
        secs[mode] = time.perf_counter() - t0
        counts[mode] = dict(ops.LAUNCHES)
    return out, counts, prompts, reqs, secs


def count_collectives():
    """Wrap torch.distributed's all_reduce and all_gather (the layout's
    collectives, the loop's done test among them) to count the calls and
    the bytes this rank sends: -> the counter dict."""
    import torch.distributed as dist
    n = {"calls": 0, "bytes": 0}

    def counted(fn, arg):
        def run(*a, **kw):
            t = a[arg]
            n["calls"] += 1
            n["bytes"] += t.numel() * t.element_size()
            return fn(*a, **kw)
        return run
    dist.all_reduce = counted(dist.all_reduce, 0)
    dist.all_gather = counted(dist.all_gather, 1)
    return n


def mesh_rank(rank, data, model):
    """One of phase 9's two ranks sharing the card over gloo: the TINY
    cells on meshes 2x1 and 1x2, then LLAMA_7B + LLAMA_68M in bf16
    tensor-parallel over 1x2.  Returns numpy results, launch counts,
    first-verify logits, timings, collectives and peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import LLAMA_7B, LLAMA_68M
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    out = {"tiny": {}, "seconds": {}}
    lap = [time.perf_counter()]

    def timed_part(name):
        now = time.perf_counter()
        out["seconds"][name] = now - lap[0]
        lap[0] = now
    build.load()
    timed_part("library loaded")
    for dm in MESH_TINY["meshes"]:
        mesh = make_host_mesh(data=dm[0], model=dm[1])
        res, counts, _, _, secs = tiny_mesh_runs(*tiny_mesh_pair(), mesh)
        out["seconds"].update({f"tiny {dm[0]}x{dm[1]} {k}": v
                               for k, v in secs.items()})
        out["tiny"][dm] = (
            {k: (dataclasses.replace(v, state=None) if k in MESH_SCHEMES
                 else [dataclasses.replace(r, arrivals_s=None, ttft_s=None)
                       for r in v]) for k, v in res.items()}, counts)
        timed_part(f"tiny {dm[0]}x{dm[1]}")
    mesh = make_host_mesh(data=data, model=model)
    torch.cuda.reset_peak_memory_stats()
    target = init_params(LLAMA_7B, seed=0, dtype=torch.bfloat16, device=DEV)
    draft = init_params(LLAMA_68M, seed=1, dtype=torch.bfloat16, device=DEV)
    E.shard(target, draft, mesh, MESH["B"])
    torch.cuda.empty_cache()
    timed_part("7B made and sharded")
    coll = count_collectives()
    prompts = mesh_prompts(MESH["B"], MESH["prompt"], LLAMA_7B.vocab, 7)
    out["full"] = {}
    for wm in MESH_SCHEMES:
        scfg = E.SpecConfig(K=MESH["K"], watermark=wm,
                            temperature=MESH["temperature"])
        got, run = {}, E._run_target

        def first(t_model, fed, t_cache):
            res = run(t_model, fed, t_cache)
            if "fed" not in got:
                got.update(fed=fed.cpu().numpy(),
                           logits=res[0].float().cpu().numpy())
            return res
        E._run_target = first
        ops.reset_launches()
        coll.update(calls=0, bytes=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = E.generate(target, draft, scfg, prompts,
                             n_tokens=MESH["n_tokens"], key=MESH_KEYS,
                             mesh=mesh)
        finally:
            E._run_target = run
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out["full"][wm] = dict(
            result=dataclasses.replace(res, state=None), first=got,
            seconds=secs, ms_per_step=secs / res.n_steps * 1e3,
            collectives_per_step=coll["calls"] / res.n_steps,
            mb_per_step=coll["bytes"] / res.n_steps / 2**20,
            launches=dict(ops.LAUNCHES))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def mesh_parity(name, want, got, models, scfg, prompts):
    """Rows of ``got`` equal to ``want``'s, or parting at a counted margin
    row; -> the margin rows."""
    from repro_torch.serve import divergence
    parted = 0
    for b in range(prompts.shape[0]):
        j = divergence.first_divergence(want, got, b)
        n = int(want.lengths[b]) if j is None else j
        if j is not None:
            marg = divergence.decision_margin(*models, scfg, prompts[b], got,
                                              b, j)
            check(marg < MARGIN_TOL, f"{name}: row {b} parts at {j} with "
                  f"margin {marg}")
            parted += 1
        for f in ("tokens", "from_draft", "ctx_hashes", "masked"):
            check(bool((getattr(want, f)[b, :n] == getattr(got, f)[b, :n])
                       .all()), f"{name}: row {b} {f} differs")
    return parted


def phase_mesh():
    """Phase 9: (a) one rank over NCCL in this process, a 1x1 mesh with
    shard_params at full width, bit for bit against no mesh; (b) two ranks
    sharing the card over gloo, the TINY pair in fp32 on meshes 2x1 and
    1x2 against the unsharded runs on the card; (c) the same two ranks,
    LLAMA_7B + LLAMA_68M in bf16 tensor-parallel over 1x2, against the
    unsharded first verify's logits.  Returns the launch counts by path
    (per rank) and the numbers."""
    import gc
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import LLAMA_7B
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh, spawn
    from repro_torch.serve import engine as E
    from concurrent.futures import ThreadPoolExecutor
    by_path, results = {}, {}
    # the ranks make a full LLAMA_7B each on the same card: hand back what
    # the earlier phases left in this process's allocator cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved "
          "here before the ranks start")
    here = {}        # seconds of this process's parts
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # (b) and (c) run on two spawned ranks while (a) runs here
        job = pool.submit(spawn, mesh_rank, 2, backend="gloo",
                          args=(1, 2), timeout_s=600)
        target, draft = make_pair()
        prompts = mesh_prompts(MESH["B"], MESH["prompt"], LLAMA_7B.vocab, 7)
        want = {}
        for wm in MESH_SCHEMES:
            scfg = E.SpecConfig(K=MESH["K"], watermark=wm,
                                temperature=MESH["temperature"])
            want[wm] = E.generate(target, draft, scfg, prompts,
                                  n_tokens=MESH["n_tokens"], key=MESH_KEYS)
        # (a) a 1x1 mesh over one NCCL rank in this process
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(
                "nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                world_size=1)
            try:
                mesh = make_host_mesh()
                scfg = E.SpecConfig(K=MESH["K"], watermark="gumbel",
                                    temperature=MESH["temperature"])
                ops.reset_launches()
                t0 = time.perf_counter()
                one = E.generate(target, draft, scfg, prompts,
                                 n_tokens=MESH["n_tokens"], key=MESH_KEYS,
                                 mesh=mesh, shard_params=True)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                by_path["mesh 1x1 nccl generate"] = dict(ops.LAUNCHES)
            finally:
                dist.destroy_process_group()
        for f in MESH_FIELDS:
            check(bool(np.array_equal(getattr(one, f),
                                      getattr(want["gumbel"], f))),
                  f"mesh 1x1: {f} differs from no mesh")
        check((one.n_steps, one.aatps) == (want["gumbel"].n_steps,
                                            want["gumbel"].aatps),
              "mesh 1x1: steps or AATPS differ from no mesh")
        results["1x1 nccl"] = dict(ms_per_step=secs / one.n_steps * 1e3,
                                   n_steps=one.n_steps, bitwise=True)
        print("mesh 1x1 nccl: " + json.dumps(results["1x1 nccl"]))
        # (b)'s unsharded side, on the card
        tiny = tiny_mesh_pair()
        tiny_want, _, tiny_prompts, reqs, _ = tiny_mesh_runs(*tiny)
        here["unsharded, 1x1 and TINY here"] = time.perf_counter() - t_phase
        ranks = job.result()
        here["ranks done"] = time.perf_counter() - t_phase
    results["seconds"] = dict(here=here, rank0=ranks[0]["seconds"])
    print("mesh seconds: " + json.dumps(results["seconds"]))
    # (b) the TINY cells on two gloo ranks
    margin_rows = n_rows = 0
    for dm in MESH_TINY["meshes"]:
        tag = f"mesh {dm[0]}x{dm[1]} gloo"
        for rank, r in enumerate(ranks):
            got, counts = r["tiny"][dm]
            for wm in MESH_SCHEMES:
                scfg = E.SpecConfig(K=4, watermark=wm, m=30, temperature=0.7)
                margin_rows += mesh_parity(f"{tag} {wm}", tiny_want[wm],
                                           got[wm], tiny, scfg,
                                           tiny_prompts)
                n_rows += MESH_TINY["B"]
                tail = ("spec_verify_wm" if wm == "gumbel"
                        else "spec_verify_wm_tournament")
                draft_k = ("gumbel_argmax" if wm == "gumbel"
                           else "tournament_keyed")
                check(counts[wm][tail] > 0 and counts[wm][draft_k] > 0,
                      f"{tag} {wm} rank {rank}: launches {counts[wm]}")
            scfg = E.SpecConfig(K=4, watermark="gumbel", m=30,
                                temperature=0.7)
            for mode in MESH_TINY_SERVE:
                for a, b, (p, _) in zip(tiny_want[mode], got[mode], reqs):
                    margin_rows += compare_requests(
                        a.as_generation_result(), b.as_generation_result(),
                        tiny, scfg, p, f"{tag} {mode} uid {a.uid}")
                    n_rows += 1
                check(counts[mode]["spec_verify_wm"] > 0,
                      f"{tag} {mode} rank {rank}: launches {counts[mode]}")
                if mode == "paged":
                    check(counts[mode]["paged_attention"] > 0,
                          f"{tag} paged rank {rank}: paged_attention never "
                          "launched")
            if rank == 0:
                for cell, c in counts.items():
                    by_path[f"{tag} {cell} (rank 0)"] = c
    results["tiny gloo"] = dict(margin_rows=margin_rows, rows=n_rows)
    print(f"mesh tiny gloo: margin rows {margin_rows} of {n_rows}")
    # (c) LLAMA_7B tensor-parallel over 1x2, against the unsharded verify
    # over the same fed tokens (generate's cache extent)
    max_seq = MESH["prompt"] + 1 + (MESH["K"] + 1) * MESH["n_tokens"] + 2
    for wm in MESH_SCHEMES:
        full = [r["full"][wm] for r in ranks]
        res = full[0]["result"]
        check(bool((res.lengths >= MESH["n_tokens"]).all()),
              f"mesh 1x2 {wm}: lengths {res.lengths}")
        check(all(bool(np.array_equal(f["result"].tokens, res.tokens))
                  for f in full), f"mesh 1x2 {wm}: ranks differ")
        fed = torch.as_tensor(full[0]["first"]["fed"], device=DEV)
        with torch.no_grad():
            _, cache = target.prefill(torch.as_tensor(prompts, device=DEV),
                                      max_seq)
            logits, _ = target.extend_step(fed, cache)
        ref = logits.float().cpu().numpy()
        err = np.abs(full[0]["first"]["logits"] - ref).max(-1)
        scale = np.abs(ref).max(-1)
        ratio = float((err / scale).max())
        check(ratio <= MESH_LOGIT_RTOL,
              f"mesh 1x2 {wm}: first-verify logits {ratio:.4g} of the row's "
              f"largest |logit| apart (bound {MESH_LOGIT_RTOL:.4g})")
        same = [int(np.array_equal(res.tokens[b, :n],
                                   want[wm].tokens[b, :n]))
                for b, n in enumerate(np.minimum(res.lengths,
                                                 want[wm].lengths))]
        results[f"1x2 gloo {wm}"] = dict(
            logit_err_over_max=ratio, logit_max_abs_err=float(err.max()),
            rows_equal_to_end=sum(same), rows=len(same),
            ms_per_step=full[0]["ms_per_step"], n_steps=res.n_steps,
            collectives_per_step=full[0]["collectives_per_step"],
            mb_per_step=full[0]["mb_per_step"],
            peak_gib_per_rank=[r["peak_gib"] for r in ranks])
        by_path[f"mesh 1x2 gloo generate {wm} (rank 0)"] = \
            full[0]["launches"]
        print(f"mesh 1x2 gloo {wm}: " + json.dumps(results[f"1x2 gloo {wm}"]))
    del target, draft
    torch.cuda.empty_cache()
    return by_path, results


# ---------------------------------------------------------------------------


KERNELS = [
    ("spec_verify_wm", "src/repro_torch/kernels/csrc/spec_verify_wm.cu",
     "src/repro/kernels/spec_verify.py:244", "spec_verify_wm race V=32000"),
    # the same kernel's tournament branch (the table's row 2), counted apart
    # by ops.spec_verify_wm
    ("spec_verify_wm_tournament",
     "src/repro_torch/kernels/csrc/spec_verify_wm.cu",
     "src/repro/kernels/spec_verify.py:202",
     "spec_verify_wm_tournament V=32000"),
    ("gumbel_argmax", "src/repro_torch/kernels/csrc/gumbel_argmax.cu",
     "src/repro/kernels/gumbel_argmax.py:70", "gumbel_argmax B=4 V=32000"),
    ("tournament_keyed", "src/repro_torch/kernels/csrc/tournament_keyed.cu",
     "src/repro/kernels/tournament.py:88",
     "tournament_keyed B=4 V=32000"),
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:81",
     "paged_attention target verify bfloat16"),
    ("wkv", "src/repro_torch/kernels/csrc/wkv.cu",
     "src/repro/kernels/wkv.py:52", "wkv admission chunk bfloat16"),
    ("wkv_step", "src/repro_torch/kernels/csrc/wkv_step.cu",
     "src/repro/kernels/wkv.py:112", "wkv_step rwkv6-3b bfloat16"),
    ("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
     "src/repro/kernels/ssd.py:64", "ssd batch float32"),
    # the chunked scan's scalar kernel, for the chunks ssd.cu cannot hold
    # (ops.LAUNCHES counts it under ssd too); no model path has such a chunk
    ("ssd_scalar", "src/repro_torch/kernels/csrc/ssd_scalar.cu",
     "src/repro/kernels/ssd.py:64", "ssd_scalar hd32 N250 float32"),
    ("ssd_step", "src/repro_torch/kernels/csrc/ssd_step.cu",
     "src/repro/kernels/ssd.py:121", "ssd_step zamba2-1.2b float32"),
    ("tournament", "src/repro_torch/kernels/csrc/tournament.cu",
     "src/repro/kernels/tournament.py:64", "tournament B=4 V=32000"),
    ("spec_verify", "src/repro_torch/kernels/csrc/spec_verify.cu",
     "src/repro/kernels/spec_verify.py:93", "spec_verify B=4 K=4 V=32000"),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    global SMI
    SMI = smi
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    from repro_torch.kernels import build
    build.load()
    secs, log = build.build_info()
    print(f"build: {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    record = timed("2 kernels", phase_kernels)
    record += timed("2b paged kernel", phase_paged_kernel)
    rec_record, scalar_counts = timed("2c recurrent kernels",
                                      phase_recurrent_kernels)
    record += rec_record
    target, draft = make_pair()
    counts, slice_results = timed("3 generate", phase_slice, target, draft)
    serve_counts, serve_results, served = timed(
        "3b serve_requests", phase_serve, target, draft)
    stream_counts, stream_results = timed("7 streaming", phase_stream,
                                          target, draft, serve_results,
                                          served)
    del served
    del draft
    torch.cuda.empty_cache()
    rec_counts, rec_results = timed("3c recurrent drafts", phase_recurrent,
                                    target)
    measure_counts, measure_results = timed("5 measures", phase_measures,
                                            target)
    del target
    torch.cuda.empty_cache()
    fam_counts, fam_results = timed("8 families", phase_families)
    mesh_counts, mesh_results = timed("9 multi-device", phase_mesh)
    tiny_margin_rows = timed("4 tiny generate", phase_tiny)
    tiny_serve_margin_rows = timed("4b tiny serve_requests",
                                   phase_tiny_serve)
    tiny_rec_margin_rows, tiny_rec_rows, tiny_rec_counts = timed(
        "4c tiny recurrent drafts", phase_tiny_recurrent)
    train_counts, train_results = timed("6 training", phase_train)
    launch_results = timed("7b launcher and examples", phase_launch)

    by_case = {r["case"]: r for r in record}
    paths = {"generate": counts, "serve_requests": serve_counts,
             **stream_counts,
             **rec_counts, **measure_counts, **fam_counts, **mesh_counts,
             "ssd scalar-kernel shapes (phase 2c)": scalar_counts,
             **train_counts}
    kernels = []
    for name, source, replaces, case in KERNELS:
        r = by_case[case]
        prefix = case.split()[0]
        cases = [x for x in record
                 if x.get("kernel", x["case"].split()[0]) == prefix]
        # ssd counts both chunked-scan kernels; its entry is the tiled one's
        by_path = {path: c[name] - (c["ssd_scalar"] if name == "ssd" else 0)
                   for path, c in paths.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(x["max_abs_err"] for x in cases),
            max_err_over_tol=max(x.get("err_over_tol", 0.0) for x in cases),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    print(json.dumps({"slice": slice_results, "serve": serve_results,
                      "recurrent": rec_results,
                      "measures": measure_results,
                      "families": fam_results,
                      "mesh": mesh_results,
                      "launches": paths,
                      "tiny_margin_rows": tiny_margin_rows,
                      "tiny_serve_margin_rows": tiny_serve_margin_rows,
                      "tiny_recurrent_margin_rows": tiny_rec_margin_rows,
                      "tiny_recurrent_rows": tiny_rec_rows,
                      "tiny_recurrent_launches": tiny_rec_counts,
                      "train": train_results,
                      "stream": stream_results,
                      "launch": launch_results,
                      "phase_seconds": phase_s,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
