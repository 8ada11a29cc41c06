"""Kernel wrappers: dispatch on the tensor's device, count launches.

A CPU tensor takes the plain version in ``ref``.  A CUDA tensor launches
the hand-written kernel (built on first use by ``build.load``) on the
current stream; a failed build or launch raises, and nothing routes a
CUDA tensor to the plain version.  Any other device raises.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls do
not count; ``spec_verify_wm`` counts its race and its tournament branch
apart, under ``spec_verify_wm`` and ``spec_verify_wm_tournament``; ``ssd``
counts both chunked-scan kernels, and ``ssd_scalar`` the scalar one's
launches again, so the tiled kernel's are ``ssd`` less ``ssd_scalar``);
``reset_launches`` zeroes them, so a caller can show that a run went
through the kernels.

``wkv``, ``ssd`` and ``ssd_scan`` are differentiable: where autograd
records, they go through ``Replay``, whose forward is the same dispatch
(a CUDA tensor still launches the kernel) and whose backward replays the
per-timestep plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
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
# the fused tail splits a row over a cluster of this many blocks
# (csrc/spec_verify_wm.cu's TAIL_CLUSTER), the race and the tournament
# alike; a tournament slice of ceil(V / TAIL_CLUSTER) entries lives in
# shared memory up to SMEM_ROW_MAX
TAIL_CLUSTER = 8
# the paged-attention kernel's head sizes: multiples of 8 (16-byte bf16
# vectors) up to 256 (csrc/paged_attention.cu's PA_MAX_HD)
PAGED_MAX_HD = 256

# the recurrent kernels' head sizes (one instantiation each for the WKV
# kernels, whose threads keep a state column in registers) and the shared
# memory a block may opt into on sm_90
WKV_HEAD_DIMS = (16, 32, 64, 128)
SMEM_BLOCK_MAX = 227 * 1024
# the SSD step kernel keeps a row's N state columns in registers over at
# most 32 lanes of 4·8 columns (csrc/ssd_step.cu's SSD_MAX_NK)
SSD_MAX_N = 1024

# the Gumbel race's launch shape (csrc/gumbel_argmax.cu), from (B, V)
# alone: rows up to RACE_SEG_MAX_V entries race in segments of a warp;
# wider ones over a cluster of blocks at the serving batches (RACE_SPLITS:
# up to b_max rows, c blocks a row; 16, a non-portable cluster, up to 4
# rows: on an H100 it beat 8 there, 0.0045 against 0.0053 ms at V=32000,
# and lost at 8 rows), else one block a row
RACE_SEG_MAX_V = 1024
RACE_SPLITS = ((4, 16), (8, 8))
# the unkeyed tournament's launch shape (csrc/tournament.cu): from V
# alone, so a row's sums and floats are the same at any B, rows up to
# TOURNAMENT_SEG_MAX_V entries in segments of a warp whose lanes hold up to
# TOURNAMENT_SEG_PER entries each (at most 32 lanes), wider ones over a
# cluster of TOURNAMENT_CLUSTER blocks (the kernel's TU_SEG_MAX_V and
# TU_CLUSTER hold the same two numbers) whose threads hold about
# TOURNAMENT_PER entries of the block's slice each (at most
# TOURNAMENT_THREADS threads, then up to 8 entries a thread, then 1024
# threads over a slice in shared memory); from B, the rows a cluster holds
# at once, which no row's sums depend on: one up to TOURNAMENT_ONE_ROW_B
# rows in the batch (the micro-benchmark's 4 and 8), else
# TOURNAMENT_ROWS (the measures' Monte Carlo; segments hold one)
TOURNAMENT_SEG_MAX_V = 1024
TOURNAMENT_SEG_PER = 2
TOURNAMENT_CLUSTER = 8
TOURNAMENT_PER = 4
TOURNAMENT_THREADS = 512
TOURNAMENT_ONE_ROW_B = 8
TOURNAMENT_ROWS = 4

LAUNCHES: Dict[str, int] = {"spec_verify_wm": 0,
                            "spec_verify_wm_tournament": 0,
                            "gumbel_argmax": 0,
                            "tournament_keyed": 0, "paged_attention": 0,
                            "wkv": 0, "wkv_step": 0, "ssd": 0,
                            "ssd_scalar": 0, "ssd_step": 0,
                            "tournament": 0, "spec_verify": 0}


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


def _checked(t: torch.Tensor, dtype: torch.dtype, shape, name: str):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    return t


def _arg(t: torch.Tensor, dtype: torch.dtype, shape, name: str):
    return _checked(t, dtype, shape, name).contiguous()


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
        _ptr(probs), _ptr(seeds), B, V, race_split(B, V), _ptr(tok),
        _ptr(u), _stream(probs))
    _launched("gumbel_argmax", rc)
    return tok, u


def race_split(B: int, V: int) -> int:
    """The race kernel's launch shape for B rows of V entries: 0 for
    segments of a warp, else the blocks that race one row (a cluster when
    above 1).  Every shape gives the same tokens and U bit for bit."""
    if V <= RACE_SEG_MAX_V:
        return 0
    return next((c for b_max, c in RACE_SPLITS if B <= b_max), 1)


def tournament(probs: torch.Tensor, seeds: torch.Tensor, *, m: int):
    """m SynthID rounds per (B, V) f32 row (not normalised here) with the
    row's host seed (B,) int64 word -> the distribution (B, V) f32.  On
    the card, one row expanded to (B, V) (row stride 0) is read as it is,
    without a copy; any other layout is made contiguous."""
    if not _on_cuda(probs, seeds):
        return ref.tournament_ref(probs, seeds, m=m)
    B, V = probs.shape
    probs = _checked(probs, torch.float32, (B, V), "probs")
    if B > 1 and probs.stride(0) == 0 and (probs.stride(1) == 1 or V == 1):
        row_stride = 0
    else:
        probs, row_stride = probs.contiguous(), V
    seeds = _arg(seeds, torch.int64, (B,), "seeds")
    out = torch.empty((B, V), dtype=torch.float32, device=probs.device)
    rc = build.load().tournament_launch(
        _ptr(probs), _ptr(seeds), B, V, row_stride, m, tournament_shape(V)[1],
        tournament_rows(B, V), _ptr(out), _stream(probs))
    _launched("tournament", rc)
    return out


def tournament_shape(V: int):
    """The unkeyed tournament's launch shape for rows of V entries, from V
    alone (it fixes every row's sum order): (0, lanes a segment) for rows
    in segments of a warp, else (the blocks of a row's cluster, threads a
    block)."""
    if V <= TOURNAMENT_SEG_MAX_V:
        lanes = 1 << max(0, -(-V // TOURNAMENT_SEG_PER) - 1).bit_length()
        return 0, min(32, lanes)
    per_block = -(-V // TOURNAMENT_CLUSTER)
    threads = (-(-per_block // TOURNAMENT_PER) + 31) // 32 * 32
    if threads <= TOURNAMENT_THREADS:
        return TOURNAMENT_CLUSTER, threads
    if per_block <= 8 * TOURNAMENT_THREADS:
        return TOURNAMENT_CLUSTER, TOURNAMENT_THREADS
    return TOURNAMENT_CLUSTER, 1024


def tournament_rows(B: int, V: int) -> int:
    """The rows a cluster of the unkeyed tournament holds at once in a
    batch of B rows of V entries (they share the counters' hashes and each
    round's exchange; rows in segments take one at a time); no row's
    floats depend on it."""
    if V <= TOURNAMENT_SEG_MAX_V or B <= TOURNAMENT_ONE_ROW_B:
        return 1
    return TOURNAMENT_ROWS


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
    rc = build.load().tournament_keyed_launch(
        _ptr(probs), _ptr(keys), _ptr(ctx_hashes), B, V, m, stream,
        _ptr(out), _ptr(arg), _stream(probs))
    _launched("tournament_keyed", rc)
    return out, arg


def spec_verify(p, q, tokens, u, resid_seeds):
    """The unkeyed Alg. 1 verify: p, q (B, K, V) f32; tokens (B, K)
    int64; u (B, K) f32 coins; resid_seeds (B, K) int64 words.  Returns
    (n_acc (B,), prefix (B, K), the residual token (B,), its U (B,)) from
    a Gumbel race over (p − q)_+ at slot min(n_acc, K − 1)."""
    if not _on_cuda(p, q, tokens, u, resid_seeds):
        return ref.spec_verify_ref(p, q, tokens, u, resid_seeds)
    B, K, V = p.shape
    if K < 1:
        raise ValueError("spec_verify: needs K >= 1 drafted slots")
    p = _arg(p, torch.float32, (B, K, V), "p")
    q = _arg(q, torch.float32, (B, K, V), "q")
    tokens = _arg(tokens, torch.int64, (B, K), "tokens")
    u = _arg(u, torch.float32, (B, K), "u")
    resid_seeds = _arg(resid_seeds, torch.int64, (B, K), "resid_seeds")
    dev = p.device
    n_acc = torch.empty(B, dtype=torch.int64, device=dev)
    prefix = torch.empty((B, K), dtype=torch.int64, device=dev)
    rtok = torch.empty(B, dtype=torch.int64, device=dev)
    ru = torch.empty(B, dtype=torch.float32, device=dev)
    rc = build.load().spec_verify_launch(
        _ptr(p), _ptr(q), _ptr(tokens), _ptr(u), _ptr(resid_seeds), B, K, V,
        spec_verify_split(B, V), _ptr(n_acc), _ptr(prefix), _ptr(rtok),
        _ptr(ru), _stream(p))
    _launched("spec_verify", rc)
    return n_acc, prefix, rtok, ru


def spec_verify_split(B: int, V: int) -> int:
    """The unkeyed verify's launch shape for B rows of V entries: the
    blocks that race one row (a cluster when above 1), the Gumbel race's
    ``race_split`` with one block a row where that races in segments of a
    warp.  Every split gives the same tokens and U bit for bit."""
    return race_split(B, V) or 1


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
    slice_bytes = 4 * -(-V // TAIL_CLUSTER)
    scratch = (torch.empty((B, V), dtype=torch.float32, device=dev)
               if tournament and slice_bytes > SMEM_ROW_MAX else None)
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
    _launched("spec_verify_wm_tournament" if tournament else
              "spec_verify_wm", rc)
    return n_acc, prefix, etok, (estat if tournament else estat[:, 0])


def paged_heads_error(H: int, Hkv: int, hd: int) -> str:
    """Why the paged kernel refuses H query heads over Hkv kv heads of
    size hd ("" where it takes them)."""
    if H % Hkv or hd % 8 or not 0 < hd <= PAGED_MAX_HD:
        return (f"H={H}, Hkv={Hkv}, hd={hd}; the kernel needs H % Hkv == 0 "
                f"and hd a multiple of 8 up to {PAGED_MAX_HD}")
    return ""


def paged_attention(q, k_pool, v_pool, page_table, pos, *, window=0):
    """Attention of q (B, Sq, H, hd) over a paged KV pool: pools (P,
    page_size, Hkv, hd), page_table (B, max_pages) int64 physical page ids
    (0 = null), pos () or (B,) int64; query i attends logical kv positions
    < pos + i, GQA head h reads kv head h // (H / Hkv).  A ``window``
    below the extent max_pages · page_size reads one slice of that many
    positions a row (``layers.decode_attention``'s rule: from
    ``layers.window_start``, keys within ``window`` of the query).
    Returns (B, Sq, H, hd) in the
    pool's type.  The kernel takes float32 or bfloat16 pools (q of the
    same type), int64 tables and positions (no conversion), 16-byte
    aligned pools (it reads them in 16-byte vectors), hd a multiple of 8
    up to PAGED_MAX_HD, and any page size."""
    B, Sq, H, hd = q.shape
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    if not _on_cuda(q, k_pool, v_pool, page_table, pos):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, pos,
                                       window=window)
    P, ps, Hkv, _ = k_pool.shape
    max_pages = page_table.shape[1]
    window = int(window) if 0 < window < max_pages * ps else 0
    dtype = k_pool.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention: pool dtype {dtype}, the kernel "
                        "takes float32 or bfloat16")
    error = paged_heads_error(H, Hkv, hd)
    if error:
        raise ValueError(f"paged_attention: {error}")
    q = _arg(q, dtype, (B, Sq, H, hd), "q")
    k_pool = _arg(k_pool, dtype, (P, ps, Hkv, hd), "k_pool")
    v_pool = _arg(v_pool, dtype, (P, ps, Hkv, hd), "v_pool")
    page_table = _arg(page_table, torch.int64, (B, max_pages), "page_table")
    pos = _arg(pos, torch.int64, (B,), "pos")
    if (k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention: the kernel reads the pools in "
                         "16-byte vectors; they must be 16-byte aligned")
    out = torch.empty((B, Sq, H, hd), dtype=dtype, device=q.device)
    if B == 0:           # a zero-row call (a sharded peer's) launches nothing
        return out
    rc = build.load().paged_attention_launch(
        _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(page_table), _ptr(pos),
        _ptr(out), B, Sq, H, Hkv, hd, ps, max_pages, window,
        int(dtype == torch.bfloat16), 1.0 / math.sqrt(hd), _stream(q))
    _launched("paged_attention", rc)
    return out


class Replay(torch.autograd.Function):
    """A recurrence whose forward is ``fwd`` (the kernel on a CUDA tensor,
    the plain version on a CPU tensor) and whose backward replays the
    per-timestep plain version ``plain`` under autograd, as the reference's
    ``custom_vjp``s (``kernels/wkv.py::_wkv_bwd``,
    ``kernels/ssd.py::_ssd_bwd``) replay theirs through ``jax.vjp``.  The
    reference has no backward kernel, so there is none here: the backward
    keeps one timestep's graph per step, and the recurrence's inputs are
    the only tensors saved.  Both outputs (y, the final state) take a
    cotangent or None."""

    @staticmethod
    def forward(ctx, fwd, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return fwd(*args)

    @staticmethod
    def backward(ctx, *cots):
        args = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(n) for a, n in zip(args, need)]
            outs = ctx.plain(*xs)
            pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
            wanted = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [c for _, c in pairs],
                allow_unused=True) if pairs else [None] * len(wanted))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in need)


def _differentiable(fwd, plain, *args):
    """``fwd(*args)``, through ``Replay`` where autograd must see it."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return Replay.apply(fwd, plain, *args)
    return fwd(*args)


def _rec_type(t: torch.Tensor, name: str) -> torch.dtype:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 "
                        "or bfloat16 inputs")
    return t.dtype


def _wkv_args(name, r, k, v, w, u, s0):
    """Checked, contiguous WKV inputs: r, k, v and u of one type (float32
    or bfloat16), w and the state float32, hd in WKV_HEAD_DIMS."""
    shape = tuple(r.shape)
    H, hd = shape[-2:]
    dtype = _rec_type(r, name)
    if hd not in WKV_HEAD_DIMS:
        raise ValueError(f"{name}: head size {hd}; the kernel takes "
                         f"{WKV_HEAD_DIMS}")
    B = shape[0]
    return (_arg(r, dtype, shape, "r"), _arg(k, dtype, shape, "k"),
            _arg(v, dtype, shape, "v"), _arg(w, torch.float32, shape, "w"),
            _arg(u, dtype, (H, hd), "u"),
            _arg(s0, torch.float32, (B, H, hd, hd), "s0"), dtype)


def wkv_step(r, k, v, w, u, s0):
    """One RWKV6 WKV decode step, state in / state out: r, k, v, w (B, H,
    hd), u (H, hd), s0 (B, H, hd, hd) (key i, value j) -> (y (B, H, hd)
    f32, the new state (B, H, hd, hd) f32, a new buffer).  The kernel takes
    r, k, v, u in one type, float32 or bfloat16, and w and s0 in float32."""
    if not _on_cuda(r, k, v, w, u, s0):
        return ref.wkv_step_ref(r, k, v, w, u, s0)
    r, k, v, w, u, s0, dtype = _wkv_args("wkv_step", r, k, v, w, u, s0)
    B, H, hd = r.shape
    y = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    s1 = torch.empty_like(s0)
    rc = build.load().wkv_step_launch(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s0), _ptr(y),
        _ptr(s1), B, H, hd, int(dtype == torch.bfloat16), _stream(r))
    _launched("wkv_step", rc)
    return y, s1


def wkv(r, k, v, w, u, s0):
    """The WKV recurrence over a sequence: r, k, v, w (B, S, H, hd), u (H,
    hd), s0 (B, H, hd, hd) -> (y (B, S, H, hd) f32, the final state f32).
    Types as ``wkv_step``.  Differentiable: the backward replays
    ``ref.wkv_ref`` (``Replay``)."""
    return _differentiable(_wkv, ref.wkv_ref, r, k, v, w, u, s0)


def _wkv(r, k, v, w, u, s0):
    if not _on_cuda(r, k, v, w, u, s0):
        return ref.wkv_ref(r, k, v, w, u, s0)
    r, k, v, w, u, s0, dtype = _wkv_args("wkv", r, k, v, w, u, s0)
    B, S, H, hd = r.shape
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s1 = torch.empty_like(s0)
    if B == 0:           # a zero-row call (a sharded peer's) launches nothing
        return y, s1
    rc = build.load().wkv_launch(
        _ptr(r), _ptr(k), _ptr(v), _ptr(w), _ptr(u), _ptr(s0), _ptr(y),
        _ptr(s1), B, S, H, hd, int(dtype == torch.bfloat16), _stream(r))
    _launched("wkv", rc)
    return y, s1


def _ssd_args(name, la, dtx, Bf, Cf, h0):
    """Checked, contiguous SSD inputs: la and the state float32, dtx, B and
    C of one type (float32 or bfloat16)."""
    lead = tuple(la.shape)              # (B, H) or (B, S, H)
    hd, N = dtx.shape[-1], Bf.shape[-1]
    dtype = _rec_type(dtx, name)
    return (_arg(la, torch.float32, lead, "la"),
            _arg(dtx, dtype, lead + (hd,), "dtx"),
            _arg(Bf, dtype, lead[:-1] + (N,), "B"),
            _arg(Cf, dtype, lead[:-1] + (N,), "C"),
            _arg(h0, torch.float32, (lead[0], lead[-1], hd, N), "h0"), dtype)


def _ssd_step_launch(name, la, dtx, Bf, Cf, h0):
    """The step kernel over the inputs' S steps (S = 1 without a time
    axis): one launch, counted under ``ssd_step``."""
    la, dtx, Bf, Cf, h0, dtype = _ssd_args(name, la, dtx, Bf, Cf, h0)
    B, H, hd, N = h0.shape
    S = la.shape[1] if la.dim() == 3 else 1
    if N > SSD_MAX_N:
        raise ValueError(f"{name}: state width N={N}; the kernel takes up "
                         f"to {SSD_MAX_N}")
    y = torch.empty(dtx.shape, dtype=torch.float32, device=la.device)
    h1 = torch.empty_like(h0)
    if B == 0:           # a zero-row call (a sharded peer's) launches nothing
        return y, h1
    rc = build.load().ssd_step_launch(
        _ptr(la), _ptr(dtx), _ptr(Bf), _ptr(Cf), _ptr(h0), _ptr(y),
        _ptr(h1), B, S, H, hd, N, int(dtype == torch.bfloat16), _stream(la))
    _launched("ssd_step", rc)
    return y, h1


def ssd_step(la, dtx, Bf, Cf, h0):
    """One Mamba2 SSD decode step, state in / state out: la (B, H), dtx (B,
    H, hd), B and C (B, N), h0 (B, H, hd, N) -> (y (B, H, hd) f32, the new
    state f32, a new buffer).  The kernel takes la and h0 in float32, dtx,
    B, C in one type, float32 or bfloat16, and N up to SSD_MAX_N."""
    if not _on_cuda(la, dtx, Bf, Cf, h0):
        return ref.ssd_step_ref(la, dtx, Bf, Cf, h0)
    return _ssd_step_launch("ssd_step", la, dtx, Bf, Cf, h0)


def ssd_scan(la, dtx, Bf, Cf, h0):
    """The per-timestep Mamba2 recurrence over a sequence: la (B, S, H),
    dtx (B, S, H, hd), B and C (B, S, N), h0 (B, H, hd, N) -> (y (B, S, H,
    hd) f32, the final state f32, a new buffer).  A CPU tensor takes
    ``ref.ssd_ref``; on the card the ``ssd_step`` kernel walks the S steps
    in one launch (counted once under ``ssd_step``), and gives bit for
    bit what S calls of ``ssd_step`` give.  Types as ``ssd_step``.
    Differentiable: the backward replays ``ref.ssd_ref`` (``Replay``)."""
    return _differentiable(_ssd_scan, ref.ssd_ref, la, dtx, Bf, Cf, h0)


def _ssd_scan(la, dtx, Bf, Cf, h0):
    if not _on_cuda(la, dtx, Bf, Cf, h0):
        return ref.ssd_ref(la, dtx, Bf, Cf, h0)
    return _ssd_step_launch("ssd_scan", la, dtx, Bf, Cf, h0)


def ssd(la, dtx, Bf, Cf, h0, *, chunk: int):
    """The chunked Mamba2 SSD scan: la (B, S, H), dtx (B, S, H, hd), B and
    C (B, S, N), h0 (B, H, hd, N), in chunks of min(chunk, S) tokens, the
    last identity-padded -> (y (B, S, H, hd) f32, the final state f32).
    Types as ``ssd_step``; one chunk must fit a block's shared memory in
    one of the two kernels' layouts (``ssd_kernel_for``).  Differentiable:
    the backward replays the per-timestep ``ref.ssd_ref`` (``Replay``), as
    the reference's ``ssd`` replays its ``ssd_ref``."""
    if chunk < 1:
        raise ValueError(f"ssd: chunk {chunk}; the chunked scan needs >= 1")
    return _differentiable(functools.partial(_ssd, chunk=chunk), ref.ssd_ref,
                           la, dtx, Bf, Cf, h0)


def _ssd(la, dtx, Bf, Cf, h0, *, chunk: int):
    if not _on_cuda(la, dtx, Bf, Cf, h0):
        return ref.ssd_chunked_ref(la, dtx, Bf, Cf, h0, chunk)
    la, dtx, Bf, Cf, h0, dtype = _ssd_args("ssd", la, dtx, Bf, Cf, h0)
    B, S, H, hd = dtx.shape
    N = Bf.shape[-1]
    Lc = min(chunk, S)
    kernel = ssd_kernel_for(hd, N, Lc)
    if kernel is None:
        raise ValueError(f"ssd: a chunk of {Lc} at hd={hd}, N={N} fits "
                         f"neither kernel's layout in a block's "
                         f"{SMEM_BLOCK_MAX} bytes of shared memory")
    lib = build.load()
    launch = lib.ssd_launch if kernel == "tiled" else lib.ssd_scalar_launch
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=la.device)
    h1 = torch.empty_like(h0)
    if B == 0:           # a zero-row call (a sharded peer's) launches nothing
        return y, h1
    rc = launch(
        _ptr(la), _ptr(dtx), _ptr(Bf), _ptr(Cf), _ptr(h0), _ptr(y),
        _ptr(h1), B, S, H, hd, N, Lc, int(dtype == torch.bfloat16),
        _stream(la))
    _launched("ssd", rc)
    if kernel == "scalar":
        LAUNCHES["ssd_scalar"] += 1
    return y, h1


def ssd_kernel_for(hd: int, N: int, Lc: int) -> Optional[str]:
    """The chunked-scan kernel for chunks of Lc tokens at (hd, N), from
    these alone (never from B, so a row alone runs what its batch runs):
    "tiled" (csrc/ssd.cu) wherever its layout fits a block's shared memory
    (``ssd_smem_bytes``), else "scalar" (csrc/ssd_scalar.cu) where its own
    does (``ssd_scalar_smem_bytes``), else None."""
    lib = build.load()
    if lib.ssd_smem_bytes(hd, N, Lc) <= SMEM_BLOCK_MAX:
        return "tiled"
    if lib.ssd_scalar_smem_bytes(hd, N, Lc) <= SMEM_BLOCK_MAX:
        return "scalar"
    return None
