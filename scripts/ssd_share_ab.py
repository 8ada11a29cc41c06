#!/usr/bin/env python3
"""Time the chunked SSD scan with C.B^T shared over heads against the
library's kernel, on one CUDA card.

    PYTHONPATH=src python3 scripts/ssd_share_ab.py

Builds ``scripts/ssd_share_ab/ssd_head_shared.cu`` (one nvcc per variant,
all started together) in these variants: blocks of 256 threads over 16
rows, two a SM, with clusters of at most 2, 4 and 8 blocks (``dt16_c*``);
the library's geometry, 512 threads over 32 rows (``dt32_c*``); and that
geometry with each block's decayed copy of every tile gathered into its own
shared memory before y (``gather32_c*``).  Prints, per variant, how many
clusters the card holds at once at zamba2-1.2b's shape (B=1 and B=4), then
for every ``ssd`` case of ``chip_smoke.REC_CASES`` at ``REC_CHUNK`` (float32)
each variant's median launch time, whether its outputs are within
``ref.ssd_tol`` of the plain version, and the library kernel's
(``kernel``) time on the same inputs.  The last line is the card's name and
power limit.  Compare only within one call.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "scripts" / "ssd_share_ab" / "ssd_head_shared.cu"
OUT = ROOT / "build" / "ssd_share_ab"
WIDE = ["-DSSD_THREADS=512", "-DSSD_DT=32", "-DSSD_MINB=1"]


def variants():
    v = {}
    for c in (2, 4, 8):
        v[f"dt16_c{c}"] = [f"-DSSD_CMAX={c}"]
        v[f"dt32_c{c}"] = WIDE + [f"-DSSD_CMAX={c}"]
        v[f"gather32_c{c}"] = WIDE + ["-DSSD_GATHER", f"-DSSD_CMAX={c}"]
    return v


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    if not torch.cuda.is_available():
        print("ssd_share_ab: no CUDA card", file=sys.stderr)
        return 1
    build.load()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in variants().items():
        so = OUT / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC),
             "-shared", "-o", str(so), str(SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"ssd_share_ab: {name} did not build:\n{out[-3000:]}",
                  file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        lib.ssd_launch.argtypes = build.SIGNATURES["ssd_launch"]
        libs[name] = lib
        occ = {f"B={B}": lib.ssd_occ(64, 64, 128, 64, B) for B in (1, 4)}
        print(json.dumps({"variant": name, "cluster": occ["B=1"] % 1000,
                          "clusters_at_once": {k: o // 1000
                                               for k, o in occ.items()}}))
    for i, (case, kernel, shape) in enumerate(cs.REC_CASES):
        if kernel != "ssd" or "chunk" in shape:
            continue
        args = cs.rec_inputs(kernel, shape, torch.float32, seed=i + 1)
        la, dtx, Bf, Cf, h0 = args
        B, S, H, hd = dtx.shape
        N = Bf.shape[-1]
        want = ref.ssd_chunked_ref(*args, cs.REC_CHUNK)
        tol = ref.ssd_tol(*args, chunk=cs.REC_CHUNK)
        res = {"kernel": [True, cs.device_ms(
            lambda: ops.ssd(*args, chunk=cs.REC_CHUNK), kernel="ssd_kernel")]}
        for name, lib in libs.items():
            got = [torch.empty((B, S, H, hd), device="cuda"),
                   torch.empty_like(h0)]

            def run(lib=lib, got=got):
                return lib.ssd_launch(
                    *(ops._ptr(x) for x in (*args, *got)), B, S, H, hd, N,
                    min(cs.REC_CHUNK, S), 0, ops._stream(la))
            rc = run()
            torch.cuda.synchronize()
            ok = rc == 0 and all(bool(((g - w).abs() <= t).all())
                                 for g, w, t in zip(got, want, tol))
            res[name] = [ok, cs.device_ms(run, kernel="ssd_kernel")]
        print(json.dumps({"case": case, "ms": res}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
