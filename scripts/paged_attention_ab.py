#!/usr/bin/env python3
"""Time the paged-attention kernel of two checkouts on one CUDA card.

    python3 scripts/paged_attention_ab.py OLD_CHECKOUT NEW_CHECKOUT

Runs ``chip_smoke.phase_paged_kernel`` of each checkout (its kernel built
from that checkout's sources) in the order old, new, new, old, one process
each, and prints one JSON line per run: the checkout, then per case the
kernel's ms, the plain version's ms and the max abs error.  Compare the
two versions only within one such call: the card's clocks and the host
differ between calls.
"""
from __future__ import annotations

import subprocess
import sys

RUN = r"""
import json, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import chip_smoke
from repro_torch.kernels import build
build.load()
rec = chip_smoke.phase_paged_kernel()
print("AB " + json.dumps({"checkout": root, "cases": [
    [r["case"], r["ms"], r["plain_ms"], r["max_abs_err"]] for r in rec]}))
"""


def main(old: str, new: str) -> int:
    for root in (old, new, new, old):
        out = subprocess.run([sys.executable, "-c", RUN, root],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print([line for line in out.stdout.splitlines()
               if line.startswith("AB ")][-1][3:])
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1], sys.argv[2]))
