"""Kernel wrappers: dispatch on the tensor's device, count launches.

A CPU tensor takes the plain version in ``ref``.  A CUDA tensor launches
the hand-written kernel (built on first use by ``build.load``) on the
current stream; a failed build or launch raises, and nothing routes a
CUDA tensor to the plain version.  Any other device raises.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do
not count); ``reset_launches`` zeroes it, so a caller can show that a run
went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.core import prf as _prf
from repro_torch.kernels import build, ref

# the fused tail's PRF streams: the ζ^T watermark stream, the plain
# residual / bonus streams of repeated contexts, the finite-m draw stream
DEFAULT_STREAMS = (_prf.STREAM_TARGET, _prf.STREAM_PLAIN + 2,
                   _prf.STREAM_PLAIN + 3,
                   _prf.STREAM_PLAIN + _prf.STREAM_TARGET)

# a working row of 4·V bytes lives in shared memory up to this size
# (V <= 51200); past it the kernels keep the row in device memory
SMEM_ROW_MAX = 200 * 1024

LAUNCHES: Dict[str, int] = {"spec_verify_wm": 0, "gumbel_argmax": 0,
                            "tournament_keyed": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on mixed devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {dev}")


def _arg(t: torch.Tensor, dtype: torch.dtype, shape, name: str):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t.contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def gumbel_argmax(probs: torch.Tensor, seeds: torch.Tensor):
    """Seeded Gumbel race per row: probs (B, V) f32 (any nonnegative
    scale), seeds (B,) int64 words -> (tokens (B,) int64, U[token] (B,))."""
    if not _on_cuda(probs, seeds):
        return ref.gumbel_argmax_ref(probs, seeds)
    B, V = probs.shape
    probs = _arg(probs, torch.float32, (B, V), "probs")
    seeds = _arg(seeds, torch.int64, (B,), "seeds")
    tok = torch.empty(B, dtype=torch.int64, device=probs.device)
    u = torch.empty(B, dtype=torch.float32, device=probs.device)
    rc = build.load().gumbel_argmax_launch(
        _ptr(probs), _ptr(seeds), B, V, _ptr(tok), _ptr(u), _stream(probs))
    _launched("gumbel_argmax", rc)
    return tok, u


def tournament_keyed(probs: torch.Tensor, keys: torch.Tensor,
                     ctx_hashes: torch.Tensor, *, stream: int, m: int):
    """m SynthID rounds per (B, V) f32 row (not normalised here), g-seed
    chained from keys (B,), ``stream`` and ctx_hashes (B,) -> (the
    distribution (B, V) f32, its argmax (B,) int64)."""
    if not _on_cuda(probs, keys, ctx_hashes):
        return ref.tournament_keyed_ref(probs, keys, ctx_hashes,
                                        stream=stream, m=m)
    B, V = probs.shape
    probs = _arg(probs, torch.float32, (B, V), "probs")
    keys = _arg(keys, torch.int64, (B,), "keys")
    ctx_hashes = _arg(ctx_hashes, torch.int64, (B,), "ctx_hashes")
    out = torch.empty_like(probs)
    arg = torch.empty(B, dtype=torch.int64, device=probs.device)
    smem = 4 * V if 4 * V <= SMEM_ROW_MAX else 0
    rc = build.load().tournament_keyed_launch(
        _ptr(probs), _ptr(keys), _ptr(ctx_hashes), B, V, m, stream, smem,
        _ptr(out), _ptr(arg), _stream(probs))
    _launched("tournament_keyed", rc)
    return out, arg


def spec_verify_wm(p, q, tokens, u, keys, ctx_hashes, seen, live=None, *,
                   streams=None, tail=None):
    """The fused watermarked verification tail of Alg. 1.

    p (B, K+1, V) and q (B, K, V) f32; tokens (B, K) int64; u (B, K) f32;
    keys (B,) and ctx_hashes (B, K+1) int64 words; seen (B, K+1) bool;
    live (B,) bool or None (all live).  ``streams`` is the
    (wm, plain_resid, plain_bonus, draw) stream tuple (default
    ``DEFAULT_STREAMS``); ``tail`` the scheme's ``FusedTail`` (default the
    Gumbel race).  Returns (n_acc (B,), prefix (B, K), etok (B,), estat):
    estat is U[etok] (B,) for a race and the m g-bits (B, m) for a
    tournament."""
    streams = tuple(int(s) for s in (streams or DEFAULT_STREAMS))
    kind = tail.kind if tail is not None else "race"
    m = tail.m if tail is not None else 0
    degenerate = bool(tail.degenerate) if tail is not None else False
    B, K1, V = p.shape
    K = K1 - 1
    if live is None:
        live = torch.ones(B, dtype=torch.bool, device=p.device)
    if not _on_cuda(p, q, tokens, u, keys, ctx_hashes, seen, live):
        return ref.spec_verify_wm_ref(p, q, tokens, u, keys, ctx_hashes,
                                      seen, live, streams=streams, kind=kind,
                                      m=m, degenerate=degenerate)
    if kind not in ("race", "tournament"):
        raise ValueError(f"unknown fused tail kind {kind!r}")
    p = _arg(p, torch.float32, (B, K1, V), "p")
    q = _arg(q, torch.float32, (B, K, V), "q")
    tokens = _arg(tokens, torch.int64, (B, K), "tokens")
    u = _arg(u, torch.float32, (B, K), "u")
    keys = _arg(keys, torch.int64, (B,), "keys")
    ctx_hashes = _arg(ctx_hashes, torch.int64, (B, K1), "ctx_hashes")
    seen = _arg(seen, torch.bool, (B, K1), "seen")
    live = _arg(live, torch.bool, (B,), "live")
    tournament = kind == "tournament"
    stat_dim = m if tournament else 1
    dev = p.device
    scratch = (torch.empty((B, V), dtype=torch.float32, device=dev)
               if tournament and 4 * V > SMEM_ROW_MAX else None)
    n_acc = torch.empty(B, dtype=torch.int64, device=dev)
    prefix = torch.empty((B, K), dtype=torch.int64, device=dev)
    etok = torch.empty(B, dtype=torch.int64, device=dev)
    estat = torch.empty((B, stat_dim), dtype=torch.float32, device=dev)
    rc = build.load().spec_verify_wm_launch(
        _ptr(p), _ptr(q), _ptr(tokens), _ptr(u), _ptr(keys),
        _ptr(ctx_hashes), _ptr(seen), _ptr(live), _ptr(scratch),
        _ptr(n_acc), _ptr(prefix), _ptr(etok), _ptr(estat),
        B, K, V, m, int(tournament), int(degenerate), stat_dim,
        *streams, _stream(p))
    _launched("spec_verify_wm", rc)
    return n_acc, prefix, etok, (estat if tournament else estat[:, 0])
