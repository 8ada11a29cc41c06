"""Layers of the dense transformer — the port of ``repro.models.layers``
(the functions the serving path and the training forward run).  Plain
PyTorch, differentiable through autograd; weights keep the reference's
einsum layouts: wq/wk/wv (d, H, hd), wo (H, hd, d), w_in/w_gate (d, ff),
w_out (ff, d)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG = torch.finfo(torch.float32).min   # the reference's mask sentinel


def rms_norm(x, scale, eps=1e-5):
    """RMSNorm computed in float32, cast back to x's type."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":           # jax.nn.gelu is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sqrelu":         # nemotron's squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def apply_rope(x, positions, theta: float):
    """x (B, S, H, hd), positions (B, S): rotate the split halves."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def qkv_proj(wq, wk, wv, x, positions, theta, rope: bool = True):
    """q, k, v of x; RoPE on q and k unless ``rope`` is False (whisper's
    non-causal encoder)."""
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if rope:
        q, k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    return q, k, v


def out_proj(wo, attn_out):
    return torch.einsum("bshk,hkd->bsd", attn_out, wo)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _masked_attention(q, k, v, valid):
    """q (B,Sq,H,hd), k/v (B,S,Hkv,hd), valid (B|1, Sq, S) bool."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    scores = torch.where(valid[:, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", probs.to(v.dtype), v)


def attention_full(q, k, v, *, causal=True, window=0):
    """The reference's naive attention over one sequence block: q (B, Sq,
    H, hd), k/v (B, Sk, Hkv, hd) -> (B, Sq, H, hd); query i attends to
    the keys at positions <= i when ``causal`` (and > i - ``window`` when
    ``window``), to every key otherwise."""
    qp = torch.arange(q.shape[1], device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = torch.ones((1, 1), dtype=torch.bool, device=q.device)
    if causal:
        valid = qp >= kp
        if window:
            valid = valid & (qp - kp < window)
    return _masked_attention(q, k, v, valid[None])


def _pad_seq(x, mult: int):
    """Zero-pad axis 1 of x up to a multiple of ``mult``."""
    pad = (-x.shape[1]) % mult
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def attention_blockwise(q, k, v, *, causal=True, window=0, q_block=512,
                        kv_block=512, skip_masked_blocks=True):
    """Flash-attention structure in plain PyTorch (the reference's
    ``attention_blockwise``): an online softmax over kv blocks, one q
    block at a time, memory bounded by a block's scores.  With
    ``skip_masked_blocks`` a q block visits only the kv blocks that meet
    its causal (and window) band; otherwise every block, masked.
    Differentiable through autograd."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    q, k, v = _pad_seq(q, q_block), _pad_seq(k, kv_block), \
        _pad_seq(v, kv_block)
    nq, nk = q.shape[1] // q_block, k.shape[1] // kv_block
    scale = 1.0 / math.sqrt(hd)
    big_neg = -1e30
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * q_block:(qi + 1) * q_block]
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        hi = nk
        lo = 0
        if skip_masked_blocks and causal:
            hi = min(nk, (qi * q_block + q_block + kv_block - 1) // kv_block)
            if window:
                lo = max(0, (qi * q_block - window) // kv_block)
        m = torch.full((B, H, q_block), big_neg, device=dev)
        l_sum = torch.zeros((B, H, q_block), device=dev)
        acc = torch.zeros((B, H, q_block, hd), device=dev)
        for kj in range(lo, hi):
            kblk = k[:, kj * kv_block:(kj + 1) * kv_block]
            vblk = v[:, kj * kv_block:(kj + 1) * kv_block]
            s = torch.einsum("bqhk,bshk->bhqs", qblk, kblk).float() * scale
            kv_pos = kj * kv_block + torch.arange(kv_block, device=dev)
            valid = kv_pos[None, :] < Sk
            if causal:
                valid = valid & (q_pos[:, None] >= kv_pos[None, :])
                if window:
                    valid = valid & (q_pos[:, None] - kv_pos[None, :] < window)
            s = torch.where(valid[None, None], s, big_neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshk->bhqk", p, vblk.float())
            m = m_new
        out = acc / torch.clamp_min(l_sum[..., None], 1e-30)
        outs.append(out.to(q.dtype).transpose(1, 2))      # (B, qb, H, hd)
    return torch.cat(outs, 1)[:, :Sq]


def attention(q, k, v, *, causal=True, window=0, blockwise_threshold=2048,
              q_block=512, kv_block=512, skip_masked_blocks=True):
    """The reference's dispatch: ``attention_full`` while Sq·Sk is within
    ``blockwise_threshold``², ``attention_blockwise`` beyond."""
    if q.shape[1] * k.shape[1] <= blockwise_threshold ** 2:
        return attention_full(q, k, v, causal=causal, window=window)
    return attention_blockwise(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block,
                               skip_masked_blocks=skip_masked_blocks)


def window_start(pos, Sq: int, S: int, window: int):
    """The first logical position of each row's window slice in a cache
    of extent S: ``pos + Sq - 1 - window`` (pos (B,) the limit of query
    0), clamped to [0, S - window] as the reference's dynamic slice is.
    -> (B,) int64."""
    return torch.clamp(pos + Sq - 1 - window, min=0, max=S - window)


def window_valid(pos, start, Sq: int, window: int):
    """(B, Sq, window) bool: slice position j (logical ``start + j``) is a
    key of query i when ``start + j < pos + i`` and ``pos + i - (start +
    j) <= window``."""
    kv = start[:, None] + torch.arange(window, device=pos.device)[None]
    lim = pos[:, None] + torch.arange(Sq, device=pos.device)[None]
    return ((kv[:, None, :] < lim[:, :, None])
            & (lim[:, :, None] - kv[:, None, :] <= window))


def window_mask(pos, Sq: int, S: int, window: int = 0):
    """``decode_attention``'s masks over a whole cache of extent S: (valid
    (B, Sq, S), the keys of each query; present (B, 1, S), the positions
    its softmax runs over: the window's slice under ``0 < window < S``,
    else the extent), placed from ``window_start`` / ``window_valid``."""
    B = pos.shape[0]
    kv = torch.arange(S, device=pos.device)
    lim = pos[:, None] + torch.arange(Sq, device=pos.device)[None]
    if not (window and window < S):
        return (kv[None, None] < lim[:, :, None],
                torch.ones((B, 1, S), dtype=torch.bool, device=pos.device))
    start = window_start(pos, Sq, S, window)
    idx = start[:, None] + torch.arange(window, device=pos.device)[None]
    present = torch.zeros((B, S), dtype=torch.bool, device=pos.device)
    present.scatter_(1, idx, True)
    valid = torch.zeros((B, Sq, S), dtype=torch.bool, device=pos.device)
    valid.scatter_(2, idx[:, None].expand(B, Sq, window),
                   window_valid(pos, start, Sq, window))
    return valid, present[:, None]


def decode_attention(q, k_cache, v_cache, pos, *, window=0, grouped=False):
    """The reference's ``decode_attention``: q (B, Sq, H, hd), caches (B,
    S, Hkv, hd), pos (B,) the limit of query 0 (the cache position + 1).
    Query i of row b attends cache positions [0, pos[b] + i).

    With ``0 < window < S`` every query of a row reads one slice of
    ``window`` positions from ``window_start`` and attends the positions
    of it below its limit and within ``window`` of it, so query 0 of an
    extend sees ``window - Sq + 1`` keys, and a query with none averages v
    over the slice (the masked softmax is uniform).  ``grouped`` (the
    config's ``opt_decode``) is accepted for the reference's signature:
    its fold of the GQA queries is the same function summed in another
    order, so one masked path computes both."""
    B, S = k_cache.shape[:2]
    Sq = q.shape[1]
    pos = torch.as_tensor(pos, device=q.device).expand(B)
    if window and window < S:
        start = window_start(pos, Sq, S, window)
        idx = start[:, None] + torch.arange(window, device=q.device)[None]
        rows = torch.arange(B, device=q.device)[:, None]
        return _masked_attention(q, k_cache[rows, idx], v_cache[rows, idx],
                                 window_valid(pos, start, Sq, window))
    return _masked_attention(q, k_cache, v_cache,
                             window_mask(pos, Sq, S)[0])


def cache_write(cache, kv, pos):
    """Write kv (B, Sq, Hkv, hd) into cache (B, S, Hkv, hd) at positions
    pos[b]..pos[b]+Sq-1, in place.  Callers size the cache so every write
    is in bounds (an out-of-bounds index raises; the reference drops it)."""
    B, Sq = kv.shape[:2]
    idx = pos[:, None] + torch.arange(Sq, device=kv.device)[None]
    rows = torch.arange(B, device=kv.device)[:, None]
    cache[rows, idx] = kv.to(cache.dtype)
    return cache


def paged_decode_attention(q, k_pool, v_pool, page_table, pos, *, window=0,
                           grouped=False):
    """``decode_attention`` through page indirection: pools (P, page_size,
    Hkv, hd) and per-slot page tables (B, max_pages) of physical page ids
    (0 = the null page) replace the dense (B, S, Hkv, hd) cache.  A CPU
    tensor takes the plain gather + masked softmax, a CUDA tensor the
    paged-attention kernel (``kernels.ops.paged_attention``), which takes
    the window too.  ``grouped`` is accepted as ``decode_attention``
    accepts it."""
    return ops.paged_attention(q, k_pool, v_pool, page_table, pos,
                               window=window)


def paged_cache_write(pool, page_table, kv, pos):
    """Write kv (B, Sq, Hkv, hd) into a paged pool (P, page_size, Hkv, hd)
    at logical positions pos..pos+Sq-1 of each slot (pos () or (B,)),
    routed through the slot's page-table row, in place.  A position past
    the table, or on a null tail, lands in page 0, which the position gate
    hides from every read."""
    n_pool, page_size = pool.shape[:2]
    B, Sq = kv.shape[:2]
    max_pages = page_table.shape[1]
    pos = torch.as_tensor(pos, device=kv.device).expand(B)
    idx = pos[:, None] + torch.arange(Sq, device=kv.device)[None]
    lpage = idx // page_size
    phys = page_table.gather(1, torch.clamp_max(lpage, max_pages - 1))
    phys = torch.where(lpage < max_pages, phys, 0)
    flat = pool.view((n_pool * page_size,) + tuple(pool.shape[2:]))
    flat[(phys * page_size + idx % page_size).reshape(-1)] = \
        kv.reshape((B * Sq,) + tuple(kv.shape[2:])).to(pool.dtype)
    return pool


def apply_ffn(w_in, w_gate, w_out, x, act: str):
    f = activation(act)
    h = torch.einsum("...d,df->...f", x, w_in)
    h = f(torch.einsum("...d,df->...f", x, w_gate)) * h if w_gate is not None \
        else f(h)
    return torch.einsum("...f,fd->...d", h, w_out)
