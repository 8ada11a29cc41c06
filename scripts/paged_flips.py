#!/usr/bin/env python3
"""How many rounding flips a row of the bf16 paged-attention kernel needs
to stay within ``ref.paged_attention_tol`` of its plain version, on one
CUDA card.

    python3 scripts/paged_flips.py [--seeds 8] [--out FILE]

``paged_attention_tol`` allows two bf16 ulps of each output element plus
``flips`` times the row's largest single flip (one score or probability
rounded the other way).  For every bf16 case of ``chip_smoke.PAGED_CASES``
and ``chip_smoke.PAGED_WINDOW_CASES`` and every seed this script computes,
per row (slot, query, head), the flips the row needs: the largest over
the row's elements of (|kernel - plain| - two ulps) / the row's largest
flip, 0 when the ulps cover it (``ref.paged_attention_flips``).  It
prints one JSON line per case: the rows, the largest need over all seeds
and its seed, the need of each seed, and how many rows need more than 1,
2, 3 and 4.  Seed 0 is the
seed phase 2b of ``chip_smoke.py`` uses; the others add 1..n to it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("paged_flips: no CUDA card")
    import chip_smoke as C
    from repro_torch.kernels import build, ops, ref
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lines = []
    cases = [c + (0,) for c in C.PAGED_CASES] + C.PAGED_WINDOW_CASES
    for name, B, Sq, H, Hkv, hd, ps, pos_range, window in cases:
        per_seed, worst, counts = [], (0.0, 0), [0, 0, 0, 0]
        for i in range(a.seeds):
            args = C.paged_inputs(B, Sq, H, Hkv, hd, ps, pos_range,
                                  torch.bfloat16, seed=B * Sq * H + i)
            w = dict(window=window) if window else {}
            out = ops.paged_attention(*args, **w)
            want = ref.paged_attention_ref(*args, **w)
            need = ref.paged_attention_flips(*args, out, want,
                                             window=window)
            top = float(need.max())
            per_seed.append(top)
            if top > worst[0]:
                worst = (top, i)
            for j in range(4):
                counts[j] += int((need > j + 1).sum())
            del args, out, want, need
            torch.cuda.empty_cache()
        line = dict(case=name, window=window, rows=B * Sq * H,
                    seeds=a.seeds, max_flips=worst[0], max_seed=worst[1],
                    max_flips_by_seed=per_seed,
                    rows_over_1=counts[0], rows_over_2=counts[1],
                    rows_over_3=counts[2], rows_over_4=counts[3], card=smi)
        print("paged-flips " + json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
