"""Build and bind the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together), links them into one shared library with a
plain C interface, and ``ctypes`` loads it.  Nothing here runs at import:
the first kernel launch calls :func:`load`.  The library lands in
``build/repro_torch_kernels/`` at the root of the checkout, named by a
hash of the sources, so an edited source is never served a stale binary.
No ``--use_fast_math``: the kernels' float results must follow IEEE rules
to agree with their plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
SIGNATURES = {
    "gumbel_argmax_launch": [_P, _P, _I, _I, _P, _P, _P],
    "tournament_keyed_launch": [_P, _P, _P, _I, _I, _I, _U, _I, _P, _P, _P],
    "spec_verify_wm_launch": [_P] * 13 + [_I] * 7 + [_U] * 4 + [_P],
}


class KernelBuildError(RuntimeError):
    pass


class _Lib:
    """The loaded library, its build log and build seconds (one per
    process; the loader below fills it on first use)."""
    handle: Optional[ctypes.CDLL] = None
    log: str = ""
    seconds: float = 0.0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError("nvcc not found: the CUDA kernels build only "
                               "on a machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for f in cuhs + cus:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    cus, _ = _sources()
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for cu in cus:
        obj = BUILD_DIR / f"{cu.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o", str(obj)]
        procs.append((cu, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cu, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {cu.name}\n{out}")
        if proc.returncode != 0:
            failed.append(cu.name)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    _Lib.seconds = time.perf_counter() - t0
    _Lib.log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(_Lib.log)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _Lib.handle is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _Lib.handle = handle
    return _Lib.handle


def build_info():
    """(seconds the build took in this process, nvcc's -Xptxas -v log)."""
    return _Lib.seconds, _Lib.log
