#!/usr/bin/env python3
"""Which (hd, N, chunk) the chunked SSD scan takes, against the earlier
kernel's shared-memory rule, on a machine that builds the kernels.

    PYTHONPATH=src python3 scripts/ssd_shapes.py

``ops.ssd`` refuses a chunk of Lc = min(chunk, S) tokens whose block needs
more than ``ops.SMEM_BLOCK_MAX`` bytes of shared memory, as
``csrc/ssd.cu``'s ``ssd_smem_bytes`` counts them.  The scalar kernel it
replaced needed 4 (3 Lc + Lc hd + 2 Lc (N + 1) + Lc^2 + hd (N + 1)) bytes.
Over hd and Lc in 1..256 and N in 1..2048 this prints how many shapes the
earlier rule took, how many of those the kernel refuses now, and the range
of hd, N and Lc where it does; then how many it takes that the earlier
rule refused.  Both counts rise with N, so each (hd, Lc) is settled by the
largest N either takes (a binary search over ``ssd_smem_bytes``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_MAX = 2048


def old_max_n(hd, Lc, limit):
    """The largest N <= N_MAX the earlier rule took (0: none)."""
    fixed = 3 * Lc + Lc * hd + 2 * Lc + Lc * Lc + hd
    return max(0, min(N_MAX, (limit // 4 - fixed) // (2 * Lc + hd)))


def new_max_n(lib, hd, Lc, limit):
    lo, hi = 0, N_MAX            # lo is taken (0: nothing is)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if lib.ssd_smem_bytes(hd, mid, Lc) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def main() -> int:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build, ops
    lib = build.load()
    limit = ops.SMEM_BLOCK_MAX
    took = lost = gained = 0
    lost_hd, lost_lc, lost_n = set(), set(), []
    for hd in range(1, 257):
        for Lc in range(1, 257):
            a, b = old_max_n(hd, Lc, limit), new_max_n(lib, hd, Lc, limit)
            took += a
            if b < a:
                lost += a - b
                lost_hd.add(hd)
                lost_lc.add(Lc)
                lost_n.append(b + 1)
            else:
                gained += b - a
    rng = (lambda s: [min(s), max(s)] if s else None)
    print(json.dumps({"took_before": took, "refused_now": lost,
                      "refused_hd": rng(lost_hd), "refused_Lc": rng(lost_lc),
                      "refused_N_from": min(lost_n) if lost_n else None,
                      "taken_now_refused_before": gained,
                      "zamba2_bytes": lib.ssd_smem_bytes(64, 64, 128)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
