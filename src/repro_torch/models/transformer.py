"""Dense decoder-only transformer — the port of the dense branch of
``repro.models.transformer`` (``init_params``, ``init_cache``,
``prefill``, ``decode_step``, ``extend_step``).

Weights are layer-stacked like the reference's scanned params (leading
axis L), under the reference's names, so ``convert`` copies a JAX params
tree leaf for leaf.  The KV cache is a dict {k, v: (L, B, S, Hkv, hd),
pos: (B,) int64}; unlike the reference, extend/prefill write it in place.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]


def _block_shapes(cfg: ModelConfig):
    """Block leaf name -> its shape without the leading layer axis."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    shapes = {"ln_attn": (d,), "ln_ffn": (d,),
              "wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (H, hd, d), "w_in": (d, ff), "w_out": (ff, d)}
    if cfg.act == "silu":
        shapes["w_gate"] = (d, ff)
    return shapes


class Transformer(nn.Module):
    """A dense LM with random weights drawn from ``seed`` (the reference's
    init distribution: N(0, 1/fan_in) with fan_in the leading weight axis,
    embed N(0, 0.02^2), norms one), or weights copied in by ``convert``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if cfg.arch_type != "dense":
            raise NotImplementedError(
                f"arch_type={cfg.arch_type!r}: only dense is ported")
        if cfg.window:
            raise NotImplementedError("sliding-window attention is not ported")
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, std):
            if len(shape) <= 2:
                out = (torch.randn(shape, generator=gen, device=device)
                       * std).to(dtype)
            else:                        # one layer at a time in f32
                out = torch.empty(shape, dtype=dtype, device=device)
                for i in range(shape[0]):
                    out[i] = (torch.randn(shape[1:], generator=gen,
                                          device=device) * std).to(dtype)
            return nn.Parameter(out, requires_grad=False)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.embed = normal((cfg.vocab, cfg.d_model), 0.02)
        self.head = normal((cfg.d_model, cfg.vocab), 1 / math.sqrt(cfg.d_model))
        self.ln_out = ones((cfg.d_model,))
        n = cfg.n_layers
        self.blocks = nn.ParameterDict({
            name: ones((n,) + shape) if name.startswith("ln") else
            normal((n,) + shape, 1 / math.sqrt(shape[0]))
            for name, shape in _block_shapes(cfg).items()})

    # -- cache -------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A zero KV cache in the weights' type."""
        cfg = self.cfg
        dev, dtype = self.embed.device, self.embed.dtype
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos": torch.zeros(batch, dtype=torch.int64, device=dev)}

    # -- forward -----------------------------------------------------------

    def _layer(self, i: int, x, positions, attend):
        b, cfg = self.blocks, self.cfg
        h = L.rms_norm(x, b["ln_attn"][i], cfg.rms_eps)
        q, k, v = L.qkv_proj(b["wq"][i], b["wk"][i], b["wv"][i], h,
                             positions, cfg.rope_theta)
        x = x + L.out_proj(b["wo"][i], attend(i, q, k, v))
        h = L.rms_norm(x, b["ln_ffn"][i], cfg.rms_eps)
        w_gate = b["w_gate"][i] if "w_gate" in b else None
        return x + L.apply_ffn(b["w_in"][i], w_gate, b["w_out"][i], h,
                               cfg.act)

    def _logits(self, x):
        x = L.rms_norm(x, self.ln_out, self.cfg.rms_eps)
        return torch.einsum("bsd,dv->bsv", x, self.head)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (logits (B, S, V), cache with pos = S)."""
        B, S = tokens.shape
        cache = self.init_cache(B, max_seq)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

        def attend(i, q, k, v):
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            return L.causal_attention(q, k, v)

        x = self.embed[tokens]
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x, positions, attend)
        cache["pos"] = torch.full((B,), S, dtype=torch.int64,
                                  device=tokens.device)
        return self._logits(x), cache

    @torch.no_grad()
    def extend_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """Run tokens (B, Sq) on from per-row positions cache["pos"] (B,):
        -> (logits (B, Sq, V), cache with pos advanced by Sq)."""
        pos = cache["pos"]
        Sq = tokens.shape[1]
        positions = pos[:, None] + torch.arange(Sq, device=tokens.device)[None]

        def attend(i, q, k, v):
            L.cache_write(cache["k"][i], k, pos)
            L.cache_write(cache["v"][i], v, pos)
            return L.decode_attention(q, cache["k"][i], cache["v"][i],
                                      pos + 1)

        x = self.embed[tokens]
        for i in range(self.cfg.n_layers):
            x = self._layer(i, x, positions, attend)
        return self._logits(x), dict(cache, pos=pos + Sq)

    def decode_step(self, token: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B,) -> (logits (B, V), cache)."""
        logits, cache = self.extend_step(token[:, None], cache)
        return logits[:, 0], cache
