#!/usr/bin/env python3
"""Time the paged-attention, keyed-tournament, fused-tail (race and
tournament), Gumbel race, unkeyed tournament, unkeyed verify, SSD step /
scan, chunked SSD and WKV kernels of two checkouts on one CUDA card.

    python3 scripts/kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs each checkout in the order old, new, new, old, one process each, its
kernels built from that checkout's sources: the checkout's own
``chip_smoke.phase_paged_kernel`` (phase 2b) and keyed-tournament checks
(phase 2), then, for every case of NEW's phase 2b and NEW's keyed
tournament shapes that the checkout's own checks did not time, the
checkout's kernel on NEW's inputs (the same seeds, so every case sees the
same tensors in both checkouts; "refused" where the checkout's wrapper
raises on them).  Then, on NEW's inputs through each checkout's wrappers:
the fused tail at NEW's phase 2 cases (``tail_cases``: the race and the
tournament, degenerate or not, at B=4 and V=32000 and 256128, and the race
and the tournament at the B=8 serving shape), the median of its launches;
the Gumbel race at NEW's ``GUMBEL_ARGMAX_SHAPES`` (``gumbel_inputs``), the
median of its launches, and, where the checkout's wrapper chooses a launch
shape (``ops.race_split``), also each serving row count at both
vocabularies with a row over 8 and over 16 blocks (a non-portable
cluster) through the library's entry ("... split C"); the unkeyed
tournament at NEW's ``TOURNAMENT_SHAPES`` (``tournament_unkeyed_inputs``)
and the unkeyed verify at NEW's ``SPEC_VERIFY_SHAPES``
(``spec_verify_unkeyed_inputs``), the median of their launches, and at
the Monte-Carlo shape one row expanded to the batch, as
``modified_dist`` hands it over ("... one row, per call": the device time
of every kernel of one call, a copy included), and the checkout's own
Def. 3.1 strength path (``chip_smoke.strengths``, three schemes at
``MEASURE_SEEDS`` contexts of NEW's (1, 32000) row: "strength path", the
median wall seconds of 3 runs) as it is and with ``ops.tournament`` handed
a contiguous copy of its rows ("strength path, rows copied"); where the checkout's
wrappers choose those launch shapes (``ops.tournament_shape``,
``ops.spec_verify_split``), also the tournament at B = 4, 8 and 16384, V
= 32000, and (8, 4096) in the (threads a block, rows a cluster) shapes of
``TOURNAMENT_SWEEP`` ("... NT=t R=r"; each within rtol 1e-4 of the
wrapper's floats: other threads sum in another order) and the verify
with a row over 1, 8 and 16 blocks ("... split C"; bit for bit); and NEW's
phase 2c cases of the SSD and WKV sequence kernels and the SSD step: the
chunked scan (``ssd``, at each case's chunk), ``wkv`` and the decode
step (``ssd_step``), the median of their launches, and the per-timestep
scan (``ssd_scan``: the device time of every kernel of one call, however
many launches it makes, and, as "... wall", the median wall time of one
call, host work included).  Prints one JSON line per run, then one line per
case: its ms in the four runs.  The ``ssd`` and ``wkv`` cases are also
timed with every input one element off the 16-byte grid ("... off the
16-byte grid": the kernels' element-wise copies).  Compare the two
versions only within one such call: the card's clocks and the host differ
between calls.
"""
from __future__ import annotations

import json
import subprocess
import sys

RUN = r"""
import functools, importlib.util, inspect, json, sys
root, new_root = sys.argv[1], sys.argv[2]
sys.path[:0] = [root + "/src", root]
import chip_smoke
spec = importlib.util.spec_from_file_location("new_smoke",
                                              new_root + "/chip_smoke.py")
new = importlib.util.module_from_spec(spec)
spec.loader.exec_module(new)
import torch
from repro_torch.kernels import build, ops
build.load()
ms, plain, library = {}, {}, {}
for r in chip_smoke.phase_paged_kernel():
    ms[r["case"]] = r["ms"]
    plain[r["case"]] = r["plain_ms"]
    library[r["case"]] = r.get("library_ms")
rec = []
if "B" in inspect.signature(chip_smoke.check_tournament).parameters:
    for B, V in chip_smoke.TOURNAMENT_KEYED_SHAPES:
        chip_smoke.check_tournament(B, V, rec)
else:                                   # one B=4 check per vocabulary
    for V in (32000, 256128):
        chip_smoke.check_tournament(V, rec)
for r in rec:
    case = r["case"]
    if " B=" not in case:
        case = case.replace("tournament_keyed ", "tournament_keyed B=4 ")
    ms[case] = r["ms"]
    plain[case] = r["plain_ms"]
for name, B, Sq, H, Hkv, hd, ps, pos_range in new.PAGED_CASES:
    for dtype in (torch.bfloat16, torch.float32):
        case = f"paged_attention {name} {str(dtype)[6:]}"
        if case in ms:
            continue
        args = new.paged_inputs(B, Sq, H, Hkv, hd, ps, pos_range, dtype,
                                seed=B * Sq * H)
        try:
            ops.paged_attention(*args)
        except ValueError:
            ms[case] = "refused"
            continue
        ms[case] = chip_smoke.device_ms(lambda: ops.paged_attention(*args),
                                        kernel="paged_attention_kernel")
for B, V in new.TOURNAMENT_KEYED_SHAPES:
    case = f"tournament_keyed B={B} V={V}"
    if case in ms:
        continue
    probs, keys, ctx = new.tournament_inputs(B, V)
    ms[case] = chip_smoke.device_ms(
        lambda: ops.tournament_keyed(probs, keys, ctx, stream=0xD0, m=30),
        kernel="tournament_keyed_kernel")

# (threads a block, rows a cluster) launch shapes of the unkeyed
# tournament timed beside the wrapper's own, by V
TOURNAMENT_SWEEP = {32000: ((512, 1), (512, 4), (1024, 1)),
                    4096: ((64, 1), (128, 1), (128, 4))}


def per_call_ms(fn, reps=10):
    # the device time of every kernel that one call of fn launches
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / reps / 1e3


for name, B, V, tail, serving in new.tail_cases():
    args = new.tail_inputs(B, V, tail, serving)
    if " B=" not in name:
        name = name.replace(f" V={V}", f" B={B} V={V}")
    ms[name] = chip_smoke.device_ms(
        lambda: ops.spec_verify_wm(*args, tail=tail),
        kernel="spec_verify_wm")
for B, V in new.GUMBEL_ARGMAX_SHAPES:
    probs, seeds = new.gumbel_inputs(B, V)
    ms[f"gumbel_argmax B={B} V={V}"] = chip_smoke.device_ms(
        lambda: ops.gumbel_argmax(probs, seeds), kernel="gumbel_argmax")
if hasattr(ops, "race_split"):
    lib = build.load()
    for B in (1, 4, 8):
        for V in (32000, 256128):
            probs, seeds = new.gumbel_inputs(B, V)
            tok = torch.empty(B, dtype=torch.int64, device="cuda")
            u = torch.empty(B, device="cuda")
            for split in (8, 16):
                def race():
                    rc = lib.gumbel_argmax_launch(
                        ops._ptr(probs), ops._ptr(seeds), B, V, split,
                        ops._ptr(tok), ops._ptr(u), ops._stream(probs))
                    assert rc == 0, f"split {split}: CUDA error {rc}"
                race()
                want = ops.gumbel_argmax(probs, seeds)
                assert torch.equal(tok, want[0]) and torch.equal(
                    u, want[1]), f"split {split} differs"
                ms[f"gumbel_argmax B={B} V={V} split {split}"] = \
                    chip_smoke.device_ms(race, kernel="gumbel_argmax")
for B, V in new.TOURNAMENT_SHAPES:
    probs, seeds = new.tournament_unkeyed_inputs(B, V)
    ms[f"tournament B={B} V={V}"] = chip_smoke.device_ms(
        lambda: ops.tournament(probs, seeds, m=30), kernel="tournament")
    if B >= 16384:          # one row expanded, as modified_dist hands it
        one = probs[B // 2].expand(B, V)
        ms[f"tournament B={B} V={V} one row, per call"] = per_call_ms(
            lambda: ops.tournament(one, seeds, m=30))
        del one


def strength_s(reps=3):
    # the median wall seconds of the checkout's Def. 3.1 strength path
    import time
    dist = new.tournament_unkeyed_inputs(1, 32000)[0][0]
    n = {k: new.MEASURE_SEEDS for k in new.SCHEMES}
    chip_smoke.strengths(dist, n)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        chip_smoke.strengths(dist, n)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[reps // 2]


ms["strength path"] = strength_s()
tournament = ops.tournament
ops.tournament = lambda probs, seeds, *, m: tournament(probs.contiguous(),
                                                       seeds, m=m)
ms["strength path, rows copied"] = strength_s()
ops.tournament = tournament
for B, K, V in new.SPEC_VERIFY_SHAPES:
    args = new.spec_verify_unkeyed_inputs(B, K, V)
    ms[f"spec_verify B={B} K={K} V={V}"] = chip_smoke.device_ms(
        lambda: ops.spec_verify(*args), kernel="spec_verify_kernel")
if hasattr(ops, "tournament_shape"):
    lib = build.load()
    for B, V, shapes in ((4, 32000, TOURNAMENT_SWEEP[32000]),
                         (8, 32000, TOURNAMENT_SWEEP[32000]),
                         (16384, 32000, TOURNAMENT_SWEEP[32000]),
                         (8, 4096, TOURNAMENT_SWEEP[4096])):
        probs, seeds = new.tournament_unkeyed_inputs(B, V)
        want = ops.tournament(probs, seeds, m=30)
        out = torch.empty_like(want)
        for NT, R in shapes:
            def tour():
                rc = lib.tournament_launch(
                    ops._ptr(probs), ops._ptr(seeds), B, V, V, 30, NT, R,
                    ops._ptr(out), ops._stream(probs))
                assert rc == 0, f"NT={NT} R={R}: CUDA error {rc}"
            tour()
            assert torch.allclose(out, want, rtol=1e-4, atol=1e-7), (NT, R)
            ms[f"tournament B={B} V={V} NT={NT} R={R}"] = \
                chip_smoke.device_ms(tour, kernel="tournament")
        del want, out
if hasattr(ops, "spec_verify_split"):
    lib = build.load()
    for B, K, V in new.SPEC_VERIFY_SHAPES:
        args = new.spec_verify_unkeyed_inputs(B, K, V)
        want = ops.spec_verify(*args)
        got = [torch.empty_like(w) for w in want]
        for split in (1, 8, 16):
            def verify():
                rc = lib.spec_verify_launch(
                    *(ops._ptr(x) for x in args), B, K, V, split,
                    *(ops._ptr(x) for x in got), ops._stream(args[0]))
                assert rc == 0, f"split {split}: CUDA error {rc}"
            verify()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), split
            ms[f"spec_verify B={B} K={K} V={V} split {split}"] = \
                chip_smoke.device_ms(verify, kernel="spec_verify_kernel")
for i, (name, kernel, shape) in enumerate(new.REC_CASES):
    if kernel not in ("ssd_step", "ssd_scan", "ssd", "wkv"):
        continue
    for dtype in (torch.bfloat16, torch.float32):
        case = f"{name} {str(dtype)[6:]}"
        args = new.rec_inputs(kernel, shape, dtype, seed=i + 1)
        fn = getattr(ops, kernel)
        if kernel == "ssd":
            fn = functools.partial(fn, chunk=shape.get("chunk",
                                                       new.REC_CHUNK))
        try:
            fn(*args)
        except ValueError:
            ms[case] = "refused"
            continue
        if kernel != "ssd_scan":        # one launch of <kernel>_kernel
            ms[case] = chip_smoke.device_ms(lambda: fn(*args),
                                            kernel=kernel + "_kernel")
            if kernel in ("ssd", "wkv"):  # every base one element off
                odd = [torch.empty(a.numel() + 1, dtype=a.dtype,
                                   device=a.device)[1:].view(a.shape)
                       .copy_(a) for a in args]
                ms[case + " off the 16-byte grid"] = chip_smoke.device_ms(
                    lambda: fn(*odd), kernel=kernel + "_kernel")
        else:
            ms[case] = per_call_ms(lambda: fn(*args))
            ms[case + " wall"] = chip_smoke.call_ms(lambda: fn(*args))
print("AB " + json.dumps({"checkout": root, "ms": ms, "plain_ms": plain,
                          "library_ms": library}))
"""


def main(old: str, new: str) -> int:
    runs = []
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, "-c", RUN, root, new],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = [x for x in out.stdout.splitlines() if x.startswith("AB ")]
        runs.append(json.loads(line[-1][3:]))
        print(line[-1][3:])
    for case in runs[1]["ms"]:
        print(json.dumps({"case": case, "ms old, new, new, old": [
            r["ms"].get(case) for r in runs]}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
