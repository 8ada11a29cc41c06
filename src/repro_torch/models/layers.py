"""Layers of the dense transformer — the port of ``repro.models.layers``
(the functions the dense serving path runs).  Plain PyTorch; weights keep
the reference's einsum layouts: wq/wk/wv (d, H, hd), wo (H, hd, d),
w_in/w_gate (d, ff), w_out (ff, d)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def qkv_proj(wq, wk, wv, x, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


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


def causal_attention(q, k, v):
    """Prefill attention over one sequence block (full causal, no window)."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    return _masked_attention(q, k, v, (pos[:, None] >= pos[None, :])[None])


def decode_attention(q, k_cache, v_cache, pos, *, window=0, grouped=False):
    """Query i of row b attends to cache positions [0, pos[b] + i)."""
    if window or grouped:
        raise NotImplementedError(
            "decode_attention: only the non-grouped path with window=0 is "
            "ported")
    S, Sq = k_cache.shape[1], q.shape[1]
    kv_pos = torch.arange(S, device=q.device)
    lim = pos[:, None] + torch.arange(Sq, device=q.device)[None]
    return _masked_attention(q, k_cache, v_cache,
                             kv_pos[None, None, :] < lim[:, :, None])


def cache_write(cache, kv, pos):
    """Write kv (B, Sq, Hkv, hd) into cache (B, S, Hkv, hd) at positions
    pos[b]..pos[b]+Sq-1, in place.  Callers size the cache so every write
    is in bounds (an out-of-bounds index raises; the reference drops it)."""
    B, Sq = kv.shape[:2]
    idx = pos[:, None] + torch.arange(Sq, device=kv.device)[None]
    rows = torch.arange(B, device=kv.device)[:, None]
    cache[rows, idx] = kv.to(cache.dtype)
    return cache


def apply_ffn(w_in, w_gate, w_out, x, act: str):
    f = activation(act)
    h = torch.einsum("...d,df->...f", x, w_in)
    h = f(torch.einsum("...d,df->...f", x, w_gate)) * h if w_gate is not None \
        else f(h)
    return torch.einsum("...f,fd->...d", h, w_out)
