"""Attention families — the port of ``repro.models.transformer``: dense
LMs (llama / nemotron / yi / deepseek, optionally with a sliding window),
MoE LMs (olmoe, kimi-k2), VLM decoders with a cross-attention block after
every ``cross_attn_every`` self blocks (llama-3.2-vision), and enc-dec
audio backbones (whisper) (``init_params``, ``forward``, ``init_cache``,
``prefill``, ``decode_step``, ``extend_step``).

``forward`` is the training forward (autograd records it); the serving
methods run under ``torch.no_grad``.

Weights are layer-stacked like the reference's scanned params (leading
axis L), under the reference's names, so ``convert`` copies a JAX params
tree leaf for leaf.  A block's attention and dense-FFN leaves sit flat in
its group (``blocks.wq``, ``blocks.w_in``); the MoE FFN and the
cross-attention carry their group in the name (``blocks.moe.w_in``,
``blocks.cross.wq``, ``cross_blocks.cross.wq``).  The VLM's self blocks
and their KV cache stay flat over (n_groups · g) layers; ``convert``
reshapes to the reference's (n_groups, g, ...) at its boundary.

The KV cache is a dict {k, v: (L, B, S, Hkv, hd), pos: (B,) int64}, plus
the fixed cross-attention memories {xk, xv: (n_groups, B, n_image_tokens,
Hkv, hd)} of a VLM or {ck, cv: (L, B, n_audio_frames, Hkv, hd)} of an
audio model; unlike the reference, extend/prefill write it in place.  A
paged cache (``init_paged_cache``, text families only) holds pools {k, v:
(L, P, page_size, Hkv, hd)}, a ``page_table`` (B, max_pages) and ``pos``;
``extend_step`` reads and appends through the table when the cache has
one.

``prefill`` / ``forward`` run the MoE FFN under its capacity bound and
``extend_step`` dropless, as the reference splits them; ``last_aux``
holds the MoE terms of the latest call ({"lb_loss": summed over the
layers, "dropped_frac": their mean}).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import apply_moe, moe_shapes

Cache = Dict[str, torch.Tensor]
ATTN_ARCHS = ("dense", "moe", "vlm", "audio")


def _block_shapes(cfg: ModelConfig, *, cross: bool = False,
                  use_moe: bool = False) -> Dict[str, Any]:
    """Block leaf name -> its shape without the leading layer axis (a
    dict of them for the ``moe`` and ``cross`` groups)."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
            "wo": (H, hd, d)}
    shapes = {"ln_attn": (d,), "ln_ffn": (d,), **attn}
    if use_moe:
        shapes["moe"] = moe_shapes(d, cfg.moe, cfg.act)
    else:
        shapes.update(w_in=(d, ff), w_out=(ff, d))
        if cfg.act == "silu":
            shapes["w_gate"] = (d, ff)
    if cross:
        shapes["ln_cross"] = (d,)
        shapes["cross"] = dict(attn)
    return shapes


def n_cross_groups(cfg: ModelConfig) -> int:
    """A VLM's cross-attention blocks (one after every
    ``cross_attn_every`` self blocks)."""
    return cfg.n_layers // cfg.cross_attn_every


def n_self_layers(cfg: ModelConfig) -> int:
    """Self-attention blocks (the KV cache's leading axis)."""
    if cfg.arch_type == "vlm":
        return n_cross_groups(cfg) * cfg.cross_attn_every
    return cfg.n_layers


class Transformer(nn.Module):
    """An attention LM of any of ``ATTN_ARCHS`` with random weights drawn
    from ``seed`` (the reference's init distribution: N(0, 1/fan_in) with
    fan_in the leading weight axis, embed N(0, 0.02^2), norms one; one
    layer, or one expert, at a time in float32), or weights copied in by
    ``convert``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if cfg.arch_type not in ATTN_ARCHS:
            raise ValueError(f"arch_type={cfg.arch_type!r} is not an "
                             f"attention family ({ATTN_ARCHS})")
        if cfg.moe_shard_constraints:
            raise NotImplementedError(
                "moe_shard_constraints pins the MoE dispatch buffers' experts "
                "to \"model\" for the partitioner; ROADMAP §1, \"Multi-"
                "device and TPU tooling\": \"model\" > 1 for MoE (expert-"
                "parallel) is not ported")
        if cfg.moe is not None and cfg.moe_every != 1:
            raise ValueError(
                f"moe_every={cfg.moe_every}: every layer holds the MoE FFN "
                "(the reference's transformer and param_count read no "
                "moe_every either)")
        self.cfg = cfg
        self.last_aux: Dict[str, torch.Tensor] = {}
        self.spmd = None     # this rank's shards (``sharding.spmd``)
        meta = torch.device(device).type == "meta"
        gen = None if meta else torch.Generator(device=device).manual_seed(
            seed)

        def normal(shape, std, lead=1):
            if meta:         # shapes only: ``sharding.param_specs`` at size
                out = torch.empty(shape, dtype=dtype, device=device)
            elif len(shape) <= 2:
                out = (torch.randn(shape, generator=gen, device=device)
                       * std).to(dtype)
            else:                # a slice of the first `lead` axes at a time
                out = torch.empty(shape, dtype=dtype, device=device)
                flat = out.view((-1,) + tuple(shape[lead:]))
                for i in range(flat.shape[0]):
                    flat[i] = (torch.randn(shape[lead:], generator=gen,
                                           device=device) * std).to(dtype)
            return nn.Parameter(out)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=dtype, device=device))

        def group(n, shapes):
            return nn.ParameterDict({
                name: (group(n, shape) if isinstance(shape, dict) else
                       ones((n,) + shape) if name.startswith("ln") else
                       normal((n,) + shape, 1 / math.sqrt(shape[0]),
                              lead=2 if len(shape) == 3 and name.startswith(
                                  "w_") else 1))
                for name, shape in shapes.items()})

        d = cfg.d_model
        self.embed = normal((cfg.vocab, d), 0.02)
        self.head = normal((d, cfg.vocab), 1 / math.sqrt(d))
        self.ln_out = ones((d,))
        use_moe = cfg.moe is not None
        if cfg.arch_type == "vlm":
            self.blocks = group(n_self_layers(cfg),
                                _block_shapes(cfg, use_moe=use_moe))
            self.cross_blocks = group(n_cross_groups(cfg),
                                      _block_shapes(cfg, cross=True))
            self.img_proj = normal((d, d), 1 / math.sqrt(d))
        elif cfg.arch_type == "audio":
            self.enc_blocks = group(cfg.n_encoder_layers, _block_shapes(cfg))
            self.audio_proj = normal((d, d), 1 / math.sqrt(d))
            self.blocks = group(cfg.n_layers, _block_shapes(cfg, cross=True))
        else:
            self.blocks = group(cfg.n_layers,
                                _block_shapes(cfg, use_moe=use_moe))

    # -- cache -------------------------------------------------------------

    def _kv_heads(self) -> int:
        """The kv heads this rank computes (its block of them when the
        model's heads are sharded over "model")."""
        n = self.cfg.n_kv_heads
        return n if self.spmd is None else self.spmd.local("blocks.wk", -2, n)

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A zero KV cache in the weights' type (with the zero cross
        memories of a VLM or audio model, which prefill fills), over this
        rank's kv heads."""
        cfg = self.cfg
        dev, dtype = self.embed.device, self.embed.dtype
        hd, Hkv = cfg.resolved_head_dim, self._kv_heads()

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cache = {"k": zeros(n_self_layers(cfg), batch, max_seq, Hkv, hd),
                 "v": zeros(n_self_layers(cfg), batch, max_seq, Hkv, hd),
                 "pos": torch.zeros(batch, dtype=torch.int64, device=dev)}
        if cfg.arch_type == "vlm":
            shape = (n_cross_groups(cfg), batch, cfg.n_image_tokens, Hkv, hd)
            cache.update(xk=zeros(*shape), xv=zeros(*shape))
        if cfg.arch_type == "audio":
            shape = (cfg.n_layers, batch, cfg.n_audio_frames, Hkv, hd)
            cache.update(ck=zeros(*shape), cv=zeros(*shape))
        return cache

    def init_paged_cache(self, batch: int, num_pages: int, page_size: int,
                         max_pages: int) -> Cache:
        """A zero block-paged KV cache in the weights' type: a pool of
        ``num_pages`` pages of ``page_size`` positions per layer, a
        per-slot page table of physical page ids, all null (page 0, which
        allocators never hand out), and pos 0.  Slots share the pool, so
        memory is bounded by the tokens in flight, not by ``batch ×
        max_seq``.  VLM and audio models raise: their cross memories are
        per-request dense blocks."""
        cfg = self.cfg
        if cfg.arch_type in ("vlm", "audio"):
            raise ValueError(
                f"paged KV caching does not support arch_type="
                f"{cfg.arch_type!r}: the cross-attention memories "
                "(image/audio frames) are per-request dense blocks, not "
                "token pages")
        dev, dtype = self.embed.device, self.embed.dtype
        shape = (cfg.n_layers, num_pages, page_size, self._kv_heads(),
                 cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "page_table": torch.zeros((batch, max_pages),
                                          dtype=torch.int64, device=dev),
                "pos": torch.zeros(batch, dtype=torch.int64, device=dev)}

    # -- weights -----------------------------------------------------------

    def _w(self, name: str, t):
        """t, parameter ``name`` or a slice of it, whole but for the dims
        it is sharded over "model" (``sharding.spmd``: the FSDP dims are
        gathered here, just before use)."""
        return t if self.spmd is None else self.spmd.full(name, t)

    def _layer(self, prefix: str, i: int) -> Dict[str, Any]:
        """Layer i of the group ``prefix`` ("blocks", "enc_blocks",
        "cross_blocks"): {leaf: weight}, the ``moe`` / ``cross`` leaves in
        sub-dicts."""
        def take(path, grp):
            return {k: (take(f"{path}.{k}", v)
                        if isinstance(v, nn.ParameterDict)
                        else self._w(f"{path}.{k}", v[i]))
                    for k, v in grp.items()}
        return take(prefix, getattr(self, prefix))

    def _reduce(self, name: str, dim: int, y):
        """The sum over "model" of a row-parallel product's partial y."""
        return y if self.spmd is None else self.spmd.reduce(name, dim, y)

    def _embed(self, tokens):
        table = self._w("embed", self.embed)
        return table[tokens] if self.spmd is None else \
            self.spmd.embed(table, tokens)

    # -- blocks ------------------------------------------------------------

    def _ffn(self, prefix: str, w, x, dropless: bool):
        """The FFN half of a block of ``prefix`` with weights ``w`` -> (x,
        MoE aux or None)."""
        cfg = self.cfg
        h = L.rms_norm(x, w["ln_ffn"], cfg.rms_eps)
        if "moe" in w:
            y, aux = apply_moe(w["moe"], cfg.moe, h, cfg.act,
                               dropless=dropless)
            return x + y, aux
        y = L.apply_ffn(w["w_in"], w.get("w_gate"), w["w_out"], h, cfg.act)
        return x + self._reduce(f"{prefix}.w_out", -2, y), None

    def _cross(self, w, x, mk, mv):
        """Cross-attention of x to the memory k/v of a site (no mask)."""
        c = w["cross"]
        h = L.rms_norm(x, w["ln_cross"], self.cfg.rms_eps)
        q = torch.einsum("bsd,dhk->bshk", h, c["wq"])
        out = L.attention_full(q, mk, mv, causal=False)
        return x + torch.einsum("bshk,hkd->bsd", out, c["wo"])

    def _block(self, prefix: str, i: int, x, positions, attend, cross_kv,
               dropless: bool, rope: bool = True):
        """Block i of ``prefix``: self-attention (``attend(i, q, k, v)``,
        over this rank's heads), then cross-attention to ``cross_kv(i)``
        where given, then the FFN -> (x, MoE aux or None)."""
        cfg = self.cfg
        w = self._layer(prefix, i)
        h = L.rms_norm(x, w["ln_attn"], cfg.rms_eps)
        q, k, v = L.qkv_proj(w["wq"], w["wk"], w["wv"], h, positions,
                             cfg.rope_theta, rope=rope)
        x = x + self._reduce(f"{prefix}.wo", -3,
                             L.out_proj(w["wo"], attend(i, q, k, v)))
        if cross_kv is not None:
            x = self._cross(w, x, *cross_kv(i))
        return self._ffn(prefix, w, x, dropless)

    def _cross_block(self, gi: int, x, cross_kv, dropless: bool):
        """A VLM's cross block gi: cross-attention, then its FFN."""
        w = self._layer("cross_blocks", gi)
        x = self._cross(w, x, *cross_kv(gi))
        return self._ffn("cross_blocks", w, x, dropless)

    def _decoder(self, x, positions, attend, cross_kv, *, dropless: bool,
                 remat: bool = False):
        """The decoder stack over x (B, S, d); ``attend(j, q, k, v)`` is
        self layer j's attention, ``cross_kv(i)`` cross site i's memory
        k/v.  Sets ``last_aux``; -> (x, the summed load-balance loss)."""
        cfg = self.cfg
        auxes = []

        def run(fn, *args):
            if remat:
                x, aux = checkpoint(fn, *args, use_reentrant=False)
            else:
                x, aux = fn(*args)
            if aux is not None:
                auxes.append(aux)
            return x

        if cfg.arch_type == "vlm":
            g = cfg.cross_attn_every
            for gi in range(n_cross_groups(cfg)):
                for j in range(gi * g, (gi + 1) * g):
                    x = run(self._block, "blocks", j, x, positions,
                            attend, None, dropless)
                x = run(self._cross_block, gi, x, cross_kv, dropless)
        else:
            for i in range(cfg.n_layers):
                x = run(self._block, "blocks", i, x, positions, attend,
                        cross_kv if cfg.arch_type == "audio" else None,
                        dropless)
        lb = torch.zeros((), device=x.device)
        if auxes:
            lb = torch.stack([a["lb_loss"] for a in auxes]).sum()
            self.last_aux = {"lb_loss": lb, "dropped_frac": torch.stack(
                [a["dropped_frac"] for a in auxes]).mean()}
        return x, lb

    def _memory(self, extras: Optional[Mapping[str, torch.Tensor]]):
        """The cross-attention memory of the stub frontends: the image
        embeddings through ``img_proj`` (VLM) or the audio frames through
        ``audio_proj`` and the non-causal, RoPE-free encoder (audio);
        None for the text families.  A missing input raises KeyError, as
        the reference's batch lookup does."""
        cfg = self.cfg
        if cfg.arch_type not in ("vlm", "audio"):
            return None
        extras = extras or {}
        dtype = self.embed.dtype
        if cfg.arch_type == "vlm":
            return torch.einsum("bsd,de->bse", extras["image_emb"].to(dtype),
                                self._w("img_proj", self.img_proj))
        x = torch.einsum("bsd,de->bse", extras["audio_emb"].to(dtype),
                         self._w("audio_proj", self.audio_proj))
        pos = torch.arange(x.shape[1], device=x.device)[None].expand(
            x.shape[0], -1)

        def attend(i, q, k, v):
            return L.attention(q, k, v, causal=False, window=cfg.window)

        for i in range(cfg.n_encoder_layers):
            x, _ = self._block("enc_blocks", i, x, pos, attend, None,
                               dropless=False, rope=False)
        return x

    def _cross_kv_of(self, mem, store: Optional[Cache] = None):
        """cross_kv(i) over the memory: site i's k/v projections (written
        into ``store``'s cross memories where given)."""
        if mem is None:
            return None
        vlm = self.cfg.arch_type == "vlm"
        prefix = "cross_blocks" if vlm else "blocks"
        cross = getattr(self, prefix)["cross"]

        def cross_kv(i):
            mk = torch.einsum("bsd,dhk->bshk", mem,
                              self._w(f"{prefix}.cross.wk", cross["wk"][i]))
            mv = torch.einsum("bsd,dhk->bshk", mem,
                              self._w(f"{prefix}.cross.wv", cross["wv"][i]))
            if store is not None:
                store["xk" if vlm else "ck"][i] = mk
                store["xv" if vlm else "cv"][i] = mv
            return mk, mv
        return cross_kv

    def _logits(self, x):
        """Logits over the whole vocabulary (this rank's vocab block
        gathered over "model" when the head is split)."""
        x = L.rms_norm(x, self.ln_out, self.cfg.rms_eps)
        y = torch.einsum("bsd,dv->bsv", x, self._w("head", self.head))
        return y if self.spmd is None else self.spmd.logits(y)

    # -- forward -----------------------------------------------------------

    def forward(self, tokens: torch.Tensor, *, remat: bool = False,
                extras: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward: tokens (B, S) (and the ``extras``
        "image_emb" / "audio_emb" of a VLM / audio model) -> (logits (B,
        S, V), the summed MoE load-balance loss, 0 without experts),
        causal attention through ``layers.attention`` (full or blockwise
        by S, windowed by the config).  ``remat`` recomputes each block
        in the backward (``torch.utils.checkpoint``, for the reference's
        ``jax.checkpoint``)."""
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        window = self.cfg.window

        def attend(i, q, k, v):
            return L.attention(q, k, v, window=window)

        x, aux = self._decoder(self._embed(tokens), positions, attend,
                               self._cross_kv_of(self._memory(extras)),
                               dropless=False, remat=remat)
        return self._logits(x), aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int,
                extras: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) (and the modality ``extras``) -> (logits (B, S,
        V), cache with pos = S and the cross memories filled)."""
        B, S = tokens.shape
        cache = self.init_cache(B, max_seq)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        window = self.cfg.window

        def attend(i, q, k, v):
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            return L.attention(q, k, v, window=window)

        x, _ = self._decoder(self._embed(tokens), positions, attend,
                             self._cross_kv_of(self._memory(extras), cache),
                             dropless=False)
        cache["pos"] = torch.full((B,), S, dtype=torch.int64,
                                  device=tokens.device)
        return self._logits(x), cache

    @torch.no_grad()
    def extend_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """Run tokens (B, Sq) on from per-row positions cache["pos"] (B,):
        -> (logits (B, Sq, V), cache with pos advanced by Sq).  A cache
        with a ``page_table`` is read and written through it."""
        cfg = self.cfg
        pos = cache["pos"]
        Sq = tokens.shape[1]
        positions = pos[:, None] + torch.arange(Sq, device=tokens.device)[None]
        table = cache.get("page_table")
        opts = dict(window=cfg.window)

        def attend(i, q, k, v):
            if table is not None:
                L.paged_cache_write(cache["k"][i], table, k, pos)
                L.paged_cache_write(cache["v"][i], table, v, pos)
                return L.paged_decode_attention(
                    q, cache["k"][i], cache["v"][i], table, pos + 1, **opts)
            L.cache_write(cache["k"][i], k, pos)
            L.cache_write(cache["v"][i], v, pos)
            return L.decode_attention(q, cache["k"][i], cache["v"][i],
                                      pos + 1, **opts)

        cross_kv = None
        if cfg.arch_type in ("vlm", "audio"):
            mk, mv = ("xk", "xv") if cfg.arch_type == "vlm" else ("ck", "cv")

            def cross_kv(i):
                return cache[mk][i], cache[mv][i]

        x, _ = self._decoder(self._embed(tokens), positions, attend, cross_kv,
                             dropless=True)
        return self._logits(x), dict(cache, pos=pos + Sq)

    def decode_step(self, token: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B,) -> (logits (B, V), cache)."""
        logits, cache = self.extend_step(token[:, None], cache)
        return logits[:, 0], cache
