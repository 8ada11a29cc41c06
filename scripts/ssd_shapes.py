#!/usr/bin/env python3
"""Which (hd, N, chunk) the chunked SSD scan takes, against the scalar
kernel's own shared-memory rule, on a machine that builds the kernels.

    PYTHONPATH=src python3 scripts/ssd_shapes.py

``ops.ssd`` runs a chunk of Lc = min(chunk, S) tokens on the tiled kernel
(``csrc/ssd.cu``) wherever its layout fits ``ops.SMEM_BLOCK_MAX`` bytes of
shared memory (``ssd_smem_bytes``), else on the scalar kernel
(``csrc/ssd_scalar.cu``, the tiled kernel's predecessor) where that one's
layout fits (``ssd_scalar_smem_bytes``: 4 (3 Lc + Lc hd + 2 Lc (N + 1) +
Lc^2 + hd (N + 1)) bytes), and refuses it elsewhere.  Over hd and Lc in
1..256 and N in 1..2048 this prints how many shapes the scalar rule takes,
how many of those ``ops.ssd`` refuses (0 unless the choice is broken), how
many run on the scalar kernel because the tiled layout does not hold them
and the range of hd, N and Lc where they lie, how many the tiled layout
takes that the scalar one does not, and whether ``ops.ssd_kernel_for``
names the tiled kernel at every shape its layout holds.  Every count rises
with N, so each (hd, Lc) is settled by the largest N each layout takes (a
binary search over its byte count).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_MAX = 2048


def max_n(smem_bytes, hd, Lc, limit):
    """The largest N <= N_MAX whose chunk the layout holds (0: none)."""
    lo, hi = 0, N_MAX            # lo is taken (0: nothing is)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_bytes(hd, mid, Lc) <= limit:
            lo = mid
        else:
            hi = mid - 1
    return lo


def main() -> int:
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.kernels import build, ops
    lib = build.load()
    limit = ops.SMEM_BLOCK_MAX

    def wrapper(hd, N, Lc):         # 0 where ops.ssd takes the chunk
        return 0 if ops.ssd_kernel_for(hd, N, Lc) else limit + 1

    took = refused = scalar = tiled_only = 0
    mismatched = []
    sc_hd, sc_lc, sc_n = set(), set(), []
    for hd in range(1, 257):
        for Lc in range(1, 257):
            a = max_n(lib.ssd_scalar_smem_bytes, hd, Lc, limit)
            b = max_n(lib.ssd_smem_bytes, hd, Lc, limit)
            taken = max_n(wrapper, hd, Lc, limit)   # what ops.ssd takes
            took += a
            refused += max(0, a - taken)
            tiled_only += max(0, b - a)
            if b < a:
                scalar += a - b
                sc_hd.add(hd)
                sc_lc.add(Lc)
                sc_n.append(b + 1)
            # the wrapper's choice on each side of each layout's edge
            for n, want in ((b, "tiled"), (b + 1, "scalar" if a > b else
                                           None), (max(a, b) + 1, None)):
                if 0 < n <= N_MAX and ops.ssd_kernel_for(hd, n, Lc) != want:
                    mismatched.append([hd, n, Lc])
    rng = (lambda s: [min(s), max(s)] if s else None)
    print(json.dumps({"scalar_rule_takes": took, "refused_of_those": refused,
                      "run_on_scalar": scalar, "scalar_hd": rng(sc_hd),
                      "scalar_Lc": rng(sc_lc),
                      "scalar_N_from": min(sc_n) if sc_n else None,
                      "tiled_takes_scalar_rule_refuses": tiled_only,
                      "choice_mismatches": mismatched[:10],
                      "zamba2_bytes": lib.ssd_smem_bytes(64, 64, 128)}))
    return 0 if refused == 0 and not mismatched else 1


if __name__ == "__main__":
    sys.exit(main())
