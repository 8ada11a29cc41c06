#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit; build the kernels with nvcc;
  2. every kernel against its plain PyTorch version on the card, at the
     serving shapes (B=4, K=4, m=30, V=32000 and V=256128), with the
     race, the tournament and the degenerate tail, mixed seen / live rows
     and mixed keys; times of kernel, plain version and bound;
  3. the dense Algorithm 1 slice at full width: LLAMA_7B target and
     LLAMA_68M draft in bf16 (random weights from a seed), B=4, prompt 16,
     48 tokens, K=4, temperature 0.7, for gumbel, synthid and synthid-inf;
     the launch counts of that run show it went through the kernels;
  4. the TINY pair in fp32, generate on the CPU (plain versions) against
     generate on the card (kernels).
It prints a `kernels` JSON line, the card's line, and last a JSON line
{"ok": true, "device": {...}}.  It imports neither JAX nor the JAX
package, and exits non-zero without a result where there is no CUDA card
or no repro_torch package beside it.
"""
from __future__ import annotations

import json
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
DEV = "cuda"                 # rehearsals on the CPU set "cpu"
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


def verify_inputs(B, K, V, seed):
    """p, q with some agreement (so acceptance varies), drafts from q,
    mixed keys, seen and live rows."""
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
    return p, q, toks, u, keys, ctx, seen, live


def check_spec_verify(V, tail, name, streams, record):
    import torch
    from repro_torch.kernels import ops, ref
    B, K = 4, 4
    args = verify_inputs(B, K, V, seed=V + (tail.m if tail else 0))
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
    times = timings(
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


def check_gumbel_argmax(V, record):
    import torch
    from repro_torch.kernels import ops, ref
    B = 4
    g = torch.Generator(device=DEV).manual_seed(V)
    probs = torch.softmax(torch.randn((B, V), generator=g,
                                      device=DEV) * 3, -1)
    probs[3] = 0.0                  # an all-zero row: token 0, U[0]
    seeds = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    tk, uk = ops.gumbel_argmax(probs, seeds)
    tr, ur = ref.gumbel_argmax_ref(probs, seeds)
    scores, _ = ref.race_scores(probs, seeds)
    marg = ref.margin(scores)
    in_margin = marg < MARGIN_TOL
    same = tk == tr
    check(bool((same | in_margin).all()),
          f"gumbel_argmax V={V}: {tk.tolist()} vs {tr.tolist()}")
    check(int(tk[3]) == 0, "gumbel_argmax: all-zero row must give token 0")
    err = float((uk - ur)[same].abs().max())
    check(err == 0.0, f"gumbel_argmax V={V}: U differs by {err}")
    times = timings("gumbel_argmax_kernel",
                    lambda: ops.gumbel_argmax(probs, seeds),
                    lambda: ref.gumbel_argmax_ref(probs, seeds))
    bnd, by = bound_ms(4 * B * V + 8 * B + 12 * B, B * V * OPS_RACE)
    record.append(dict(case=f"gumbel_argmax V={V}",
                       margin_rows=int(in_margin.sum()), max_abs_err=err,
                       **times, bound_ms=bnd, bound_by=by))


def check_tournament(V, record):
    import torch
    from repro_torch.core import prf
    from repro_torch.kernels import ops, ref
    B, m = 4, 30
    g = torch.Generator(device=DEV).manual_seed(V + 1)
    probs = torch.softmax(torch.randn((B, V), generator=g,
                                      device=DEV) * 3, -1)
    keys = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    ctx = torch.randint(0, 2**32, (B,), generator=g, device=DEV)
    stream = prf.STREAM_DRAFT
    dk, ak = ops.tournament_keyed(probs, keys, ctx, stream=stream, m=m)
    dr, ar = ref.tournament_keyed_ref(probs, keys, ctx, stream=stream, m=m)
    err = float((dk - dr).abs().max())
    check(bool(torch.allclose(dk, dr, rtol=DIST_RTOL, atol=DIST_ATOL)),
          f"tournament V={V}: max abs err {err}")
    marg = ref.margin(dr)
    in_margin = marg < MARGIN_TOL
    check(bool(((ak == ar) | in_margin).all()),
          f"tournament V={V}: argmax {ak.tolist()} vs {ar.tolist()}")
    times = timings(
        "tournament_keyed_kernel",
        lambda: ops.tournament_keyed(probs, keys, ctx, stream=stream, m=m),
        lambda: ref.tournament_keyed_ref(probs, keys, ctx, stream=stream,
                                         m=m))
    bnd, by = bound_ms(8 * B * V + 24 * B, B * V * m * OPS_ROUND)
    record.append(dict(case=f"tournament_keyed V={V}",
                       margin_rows=int(in_margin.sum()), max_abs_err=err,
                       **times, bound_ms=bnd, bound_by=by))


def phase_kernels():
    from repro_torch.core.watermark.base import FusedTail
    from repro_torch.kernels import ops
    record = []
    for V in (32000, 256128):
        check_gumbel_argmax(V, record)
        check_tournament(V, record)
        check_spec_verify(V, None, f"spec_verify_wm race V={V}",
                          ops.DEFAULT_STREAMS, record)
        for degen in (False, True):
            tail = FusedTail(kind="tournament", m=30, stat_dim=30,
                             degenerate=degen)
            check_spec_verify(
                V, tail, f"spec_verify_wm tournament{' degen' if degen else ''}"
                f" V={V}", ops.DEFAULT_STREAMS, record)
    for r in record:
        print("kernel-check " + json.dumps(r))
    return record


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------

SLICE = dict(B=4, prompt=16, n_tokens=48, K=4, temperature=0.7)
SCHEMES = ("gumbel", "synthid", "synthid-inf")
PROFILE_TOKENS = 12          # the traced run is short: tracing is slow


def phase_slice():
    """LLAMA_7B / LLAMA_68M in bf16 on the card; returns the launch counts
    of the fused runs and the per-scheme timings."""
    import dataclasses
    import torch
    from repro_torch.configs import LLAMA_7B, LLAMA_68M
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    t0 = time.perf_counter()
    target = init_params(LLAMA_7B, seed=0, dtype=torch.bfloat16, device=DEV)
    draft = init_params(LLAMA_68M, seed=1, dtype=torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    print(f"slice: weights made in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
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
        for k, v in ops.LAUNCHES.items():
            counts[k] += v
        launches = dict(ops.LAUNCHES)
        r2 = E.generate(target, draft, scfg, prompts, n_tokens=n, key=keys)
        r_off = E.generate(target, draft,
                           dataclasses.replace(scfg, fused="off"),
                           prompts, n_tokens=n, key=keys)
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
        check(bool((r1.tokens == r2.tokens).all()),
              f"{wm}: two runs with one key differ")
        check(bool((r1.tokens == r_off.tokens).all()),
              f"{wm}: fused tail and fused='off' tail differ")
        results[wm] = dict(
            seconds=secs, n_steps=r1.n_steps, n_syncs=r1.n_syncs,
            ms_per_step=secs / r1.n_steps * 1e3,
            tokens_per_s=float(r1.lengths.sum()) / secs,
            aatps=r1.aatps, launches=launches,
            profile=profile_generate(lambda: E.generate(
                target, draft, scfg, prompts, n_tokens=PROFILE_TOKENS,
                key=keys)))
        print(f"slice {wm}: " + json.dumps(results[wm]))
    check(all(v > 0 for v in counts.values()),
          f"a kernel of the path was never launched: {counts}")
    del target, draft
    torch.cuda.empty_cache()
    return counts, results


def profile_generate(run):
    """One traced run: wall time, device busy time (the summed self time
    of every kernel on the card), the device's idle share, kernel launches
    per spec step and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # host syncs: every operation that waits for the card warns once
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    top = sorted(rows, reverse=True)[:8]
    return dict(
        wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e3 / (wall * 1e3),
        n_steps=res.n_steps, kernels_per_step=launches / res.n_steps,
        host_syncs=syncs,
        top=[dict(name=k[:60], ms=us / 1e3, count=c) for us, c, k in top])


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


KERNELS = [
    ("spec_verify_wm", "src/repro_torch/kernels/csrc/spec_verify_wm.cu",
     "src/repro/kernels/spec_verify.py:244", "spec_verify_wm race V=32000"),
    ("gumbel_argmax", "src/repro_torch/kernels/csrc/gumbel_argmax.cu",
     "src/repro/kernels/gumbel_argmax.py:70", "gumbel_argmax V=32000"),
    ("tournament_keyed", "src/repro_torch/kernels/csrc/tournament_keyed.cu",
     "src/repro/kernels/tournament.py:88", "tournament_keyed V=32000"),
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
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    from repro_torch.kernels import build
    build.load()
    secs, log = build.build_info()
    print(f"build: {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    record = phase_kernels()
    counts, slice_results = phase_slice()
    tiny_margin_rows = phase_tiny()

    by_case = {r["case"]: r for r in record}
    kernels = []
    for name, source, replaces, case in KERNELS:
        r = by_case[case]
        cases = [x for x in record if x["case"].startswith(name)]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[name],
            max_abs_err=max(x["max_abs_err"] for x in cases),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"slice": slice_results,
                      "tiny_margin_rows": tiny_margin_rows,
                      "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
