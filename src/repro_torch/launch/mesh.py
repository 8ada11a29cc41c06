"""Meshes over ``torch.distributed`` — the port of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
initialised default process group, whose dimensions carry the
reference's axis names ("data", "model", and "pod" when multi-pod).  Its
collectives run on the card over NCCL, or over gloo (on the CPU, or for
ranks that share one card: gloo stages CUDA tensors through the host).

``spawn(fn, n, backend=...)`` starts ``n`` local ranks, each running
``fn(rank, *args)`` inside an initialised process group, and returns
their results in rank order::

    def body(rank, data, model):
        mesh = make_host_mesh(data=data, model=model)
        ...
    results = spawn(body, 4, backend="gloo", args=(2, 2))

The caller names the backend: ``nccl`` where each rank owns a card
(rank r takes ``cuda:r``), ``gloo`` where ranks share one card or run
on the CPU.  Nothing here chooses another backend, device or rank count
when one fails.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = ("gloo", "nccl")


def _make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """A DeviceMesh over ranks 0 .. prod(shape) - 1, row-major over
    ``axes``: on the card's device type over NCCL, on the CPU's over gloo
    (gloo takes CUDA tensors too)."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks with a "pod" axis.
    Raises unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} over {axes} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{n}")
    return _make_mesh(shape, axes)


def make_host_mesh(*, data: int = 1, model: int = 1) -> DeviceMesh:
    """A small ("data", "model") mesh over the process group's ranks,
    clamped to them as the reference clamps to its devices."""
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _make_mesh((data, model), ("data", "model"))


def _rank_main(fn, rank: int, n: int, backend: str, store_path: str,
               timeout_s: float, args, out: "mp.Queue") -> None:
    """One spawned rank: join the group, run fn, report its result (or
    its traceback) on ``out``, leave the group."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out.put(("ok", rank, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], n: int, *, backend: str,
          args: Sequence[Any] = (), timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``n`` fresh local processes (the
    ``spawn`` start method) joined in one ``backend`` process group;
    rendezvous through a ``FileStore`` in a temporary directory.
    ``fn`` and its results are pickled: a module-level function.  Returns
    the results in rank order; the first rank that raises, or the
    deadline, ends every rank and raises here with its traceback."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"nccl gives each rank a card: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, n, backend, store, timeout_s,
                                   tuple(args), out), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        results: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n} ranks ran past {timeout_s} s "
                                       f"({sorted(results)} finished)")
                try:
                    kind, rank, value = out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died with exit "
                                           f"code {procs[dead[0]].exitcode}")
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                if p.is_alive() and len(results) < n:
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(n)]
