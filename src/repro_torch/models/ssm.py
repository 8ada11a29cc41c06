"""Attention-free and hybrid families — the port of ``repro.models.ssm``.

- RWKV6 ("Finch", arXiv:2404.05892): token shift and a per-channel
  data-dependent decay WKV recurrence (O(1) state per sequence).
- Mamba2 (SSD) blocks, and the Zamba2 hybrid (arXiv:2411.15242): a Mamba2
  backbone with one SHARED attention + gelu MLP block applied after every
  ``hybrid_attn_every`` layers, with a per-site ``ln_attn`` scale.

``RecurrentLM`` has the ``Transformer``'s method surface (``cfg``,
``embed``, ``forward``, ``init_cache``, ``prefill``, ``decode_step``,
``extend_step``), so the engine, the scheduler and the trainer need no
arch conditionals; ``forward`` is the training forward (autograd records
it, the recurrences through ``ops``' differentiable wrappers), the serving
methods run under ``torch.no_grad``.  Weights are
layer-stacked under the reference's names (``blocks.*``; the hybrid's
``shared.*`` with ``attn.*``/``ffn.*`` flattened), so ``convert`` copies
a JAX params tree leaf for leaf.

The cache is a dict of (L, B, ...) rows: RWKV6 ``wkv`` (L, B, H, hd, hd)
f32 with ``att_shift``/``ffn_shift`` (L, B, d); Mamba2 ``conv`` (L, B,
d_conv-1, C) and ``ssm`` (L, B, H, hd, N) f32; the hybrid adds ``k``/``v``
(n_sites, B, max_seq, Hkv, hd); ``pos`` (B,) int64.  Every step returns
NEW recurrent state tensors (the kernels and plain versions write state
out, never in place), so a drafter's per-step checkpoint is a reference and
a frozen slot's rows can be restored; only the hybrid's position-gated
k/v are written in place, as the transformer's are.

The recurrences go through ``kernels.ops``: sequence mode is ``ops.wkv``
(RWKV6, any length) and, for Mamba2, ``ops.ssd`` (the chunked scan) when
``ssm.chunk > 0`` and the sequence is longer than it, else ``ops.ssd_scan``
(the per-timestep recurrence, as the reference dispatches: the two orders
round differently); decode is ``ops.wkv_step`` / ``ops.ssd_step``.  A CPU
tensor takes the plain versions, a CUDA tensor the kernels.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Cache = Dict[str, torch.Tensor]
LORA_DIM = 32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus's form: logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def n_sites(cfg: ModelConfig) -> int:
    """Shared-attention applications of a hybrid model."""
    return max(1, cfg.n_layers // cfg.hybrid_attn_every)


def sites_after(cfg: ModelConfig) -> List[int]:
    """Per layer, the shared-attention site applied right after it, or -1.
    As the reference's loop: site s follows layer min((s+1)·e, L) - 1 (so a
    model shallower than ``hybrid_attn_every`` still applies its one site,
    after its last layer); the layers past n_sites·e apply none."""
    out = [-1] * cfg.n_layers
    if cfg.arch_type == "hybrid":
        e = cfg.hybrid_attn_every
        for site in range(n_sites(cfg)):
            out[min((site + 1) * e, cfg.n_layers) - 1] = site
    return out


def _shift(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> the previous token's x, zeros at position 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def _block_inits(cfg: ModelConfig):
    """Block leaf name -> (per-layer shape, init): ("const", value) or
    ("normal", std), the reference's init distribution (normal with std
    1/sqrt(fan_in), fan_in the leading per-layer axis, unless scaled)."""
    d, s = cfg.d_model, cfg.ssm

    def normal(shape, std=None):
        return shape, ("normal", std or 1 / math.sqrt(shape[0]))

    def const(shape, value):
        return shape, ("const", value)

    if s.kind == "rwkv6":
        H = d // s.head_dim
        da = H * s.head_dim
        return {
            "ln_att": const((d,), 1.0), "ln_ffn": const((d,), 1.0),
            "mu": const((5, d), 0.5),            # r, k, v, g, w shifts
            "w_r": normal((d, da)), "w_k": normal((d, da)),
            "w_v": normal((d, da)), "w_g": normal((d, da)),
            "w_o": normal((da, d)),
            "w_base": const((da,), -6.0),        # decay ~ exp(-exp(-6))
            "lora_a": normal((d, LORA_DIM)),
            "lora_b": normal((LORA_DIM, da), 0.01),
            "u": normal((H, s.head_dim)),        # bonus
            "ln_x": const((da,), 1.0),           # per-head groupnorm
            "mu_ck": const((d,), 0.5), "mu_cr": const((d,), 0.5),
            "w_ck": normal((d, cfg.d_ff)), "w_cv": normal((cfg.d_ff, d)),
            "w_cr": normal((d, d)),
        }
    d_in = s.expand * d
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return {
        "ln": const((d,), 1.0),
        "in_proj": normal((d, 2 * d_in + 2 * s.d_state + H)),
        "conv_w": normal((s.d_conv, conv_ch), 0.5),
        "conv_b": const((conv_ch,), 0.0),
        "a_log": const((H,), 0.0), "d_skip": const((H,), 1.0),
        "dt_bias": const((H,), 0.0), "ln_y": const((d_in,), 1.0),
        "out_proj": normal((d_in, d)),
    }


def _shared_inits(cfg: ModelConfig):
    """The hybrid's shared attention + gelu MLP block (attn.* and ffn.*
    flattened; the gelu FFN has no w_gate)."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "ln_attn": ((n_sites(cfg), d), ("const", 1.0)),   # per-site scale
        "ln_ffn": ((d,), ("const", 1.0)),
        "wq": ((d, H, hd), ("normal", 1 / math.sqrt(d))),
        "wk": ((d, Hkv, hd), ("normal", 1 / math.sqrt(d))),
        "wv": ((d, Hkv, hd), ("normal", 1 / math.sqrt(d))),
        "wo": ((H, hd, d), ("normal", 1 / math.sqrt(H))),
        "w_in": ((d, ff), ("normal", 1 / math.sqrt(d))),
        "w_out": ((ff, d), ("normal", 1 / math.sqrt(ff))),
    }


class RecurrentLM(nn.Module):
    """An RWKV6, Mamba2 or Zamba2-hybrid LM with random weights drawn from
    ``seed`` (the reference's init distribution), or weights copied in by
    ``convert``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        if cfg.arch_type not in ("ssm", "hybrid") or cfg.ssm is None:
            raise ValueError(f"arch_type={cfg.arch_type!r} with ssm="
                             f"{cfg.ssm!r} is not a recurrent model")
        if cfg.arch_type == "hybrid" and cfg.ssm.kind != "mamba2":
            raise ValueError("the hybrid family is a Mamba2 backbone")
        self.cfg = cfg
        self.spmd = None     # this rank's shards (``sharding.spmd``)
        meta = torch.device(device).type == "meta"
        gen = None if meta else torch.Generator(device=device).manual_seed(
            seed)

        def param(shape, init):
            kind, value = init
            if meta:         # shapes only: ``sharding.param_specs`` at size
                out = torch.empty(shape, dtype=dtype, device=device)
            elif kind == "const":
                out = torch.full(shape, value, dtype=dtype, device=device)
            elif len(shape) <= 2:
                out = (torch.randn(shape, generator=gen, device=device)
                       * value).to(dtype)
            else:                        # one layer at a time in f32
                out = torch.empty(shape, dtype=dtype, device=device)
                for i in range(shape[0]):
                    out[i] = (torch.randn(shape[1:], generator=gen,
                                          device=device) * value).to(dtype)
            return nn.Parameter(out)

        d, V = cfg.d_model, cfg.vocab
        self.embed = param((V, d), ("normal", 0.02))
        self.ln_out = param((d,), ("const", 1.0))
        self.head = param((d, V), ("normal", 1 / math.sqrt(d)))
        n = cfg.n_layers
        self.blocks = nn.ParameterDict({
            name: param((n,) + shape, init)
            for name, (shape, init) in _block_inits(cfg).items()})
        if cfg.arch_type == "hybrid":
            self.shared = nn.ParameterDict({
                name: param(shape, init)
                for name, (shape, init) in _shared_inits(cfg).items()})
        self._sites = sites_after(cfg)

    # -- shapes ------------------------------------------------------------

    @property
    def _rwkv(self) -> bool:
        return self.cfg.ssm.kind == "rwkv6"

    def _dims(self):
        """(heads, head size, state width N) of the recurrence."""
        s = self.cfg.ssm
        if self._rwkv:
            return self.cfg.d_model // s.head_dim, s.head_dim, s.head_dim
        return s.expand * self.cfg.d_model // s.head_dim, s.head_dim, \
            s.d_state

    def _w(self, name: str, t):
        """t, parameter ``name`` or a slice of it, with its FSDP dims
        gathered (``sharding.spmd``; a recurrent model shards over no
        "model" axis)."""
        return t if self.spmd is None else self.spmd.full(name, t)

    def _layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: self._w(f"blocks.{k}", v[i])
                for k, v in self.blocks.items()}

    def _shared(self) -> Dict[str, torch.Tensor]:
        """The hybrid's shared block."""
        return {k: self._w(f"shared.{k}", v) for k, v in self.shared.items()}

    def _embed(self, tokens):
        table = self._w("embed", self.embed)
        return table[tokens] if self.spmd is None else \
            self.spmd.embed(table, tokens)

    # -- cache -------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int) -> Cache:
        """A zero cache in the reference's layout: recurrent state f32,
        shift and conv states and the hybrid's k/v in the weights' type,
        ``pos`` (B,) int64."""
        cfg, s = self.cfg, self.cfg.ssm
        dev, dtype = self.embed.device, self.embed.dtype
        H, hd, N = self._dims()
        Lr = cfg.n_layers

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        if self._rwkv:
            cache = {"wkv": zeros((Lr, batch, H, hd, hd), torch.float32),
                     "att_shift": zeros((Lr, batch, cfg.d_model)),
                     "ffn_shift": zeros((Lr, batch, cfg.d_model))}
        else:
            conv_ch = s.expand * cfg.d_model + 2 * s.d_state
            cache = {"conv": zeros((Lr, batch, s.d_conv - 1, conv_ch)),
                     "ssm": zeros((Lr, batch, H, hd, N), torch.float32)}
        if cfg.arch_type == "hybrid":
            shape = (n_sites(cfg), batch, max_seq, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            cache["k"] = zeros(shape)
            cache["v"] = zeros(shape)
        cache["pos"] = zeros((batch,), torch.int64)
        return cache

    # -- RWKV6 -------------------------------------------------------------

    def _time_mix_proj(self, p, x, x_prev):
        """x, x_prev (B, S, d) -> r, k, v, g (B, S, H, hd) in x's type and
        the decay w (B, S, H, hd) f32."""
        H, hd, _ = self._dims()
        xx = x_prev - x
        xr, xk, xv, xg, xw = [x + xx * p["mu"][j] for j in range(5)]
        shp = x.shape[:-1] + (H, hd)
        r = (xr @ p["w_r"]).reshape(shp)
        k = (xk @ p["w_k"]).reshape(shp)
        v = (xv @ p["w_v"]).reshape(shp)
        g = F.silu(xg @ p["w_g"]).reshape(shp)
        # data-dependent per-channel decay (the "Finch" contribution)
        w_log = p["w_base"] + torch.tanh(xw @ p["lora_a"]) @ p["lora_b"]
        w = torch.exp(-torch.exp(w_log.float())).reshape(shp)
        return r, k, v, g, w

    @staticmethod
    def _channel_mix(p, x, x_prev):
        xx = x_prev - x
        xk = x + xx * p["mu_ck"]
        xr = x + xx * p["mu_cr"]
        k = torch.square(torch.relu(xk @ p["w_ck"]))
        return torch.sigmoid(xr @ p["w_cr"]) * (k @ p["w_cv"])

    def _out_mix(self, p, x, y, g):
        """x + w_o · (groupnorm(y) ⊙ g) over the flattened heads."""
        shp = y.shape[:-2] + (y.shape[-2] * y.shape[-1],)
        y = L.rms_norm(y.reshape(shp).to(x.dtype), p["ln_x"],
                       self.cfg.rms_eps) * g.reshape(shp).to(x.dtype)
        return x + y @ p["w_o"]

    def _rwkv_block_seq(self, p, x, state, att_prev=None, ffn_prev=None,
                        valid=None, last=None):
        """One RWKV6 block over x (B, S, d) from ``state``.  ``att_prev`` /
        ``ffn_prev`` (B, d) carry the token-shift hiddens of a continued
        sequence (None: a fresh one, zeros); ``valid`` (B, S) bool
        identity-masks the WKV update at padded positions (w = 1, k = 0);
        ``last`` (B,) gathers the returned shift states at a per-row
        position instead of S - 1.  -> (x, state, att shift, ffn shift)."""
        eps = self.cfg.rms_eps
        h = L.rms_norm(x, p["ln_att"], eps)
        x_prev = _shift(h) if att_prev is None else torch.cat(
            [att_prev[:, None].to(h.dtype), h[:, :-1]], 1)
        r, k, v, g, w = self._time_mix_proj(p, h, x_prev)
        if valid is not None:
            w = torch.where(valid[..., None, None], w, 1.0)
            k = torch.where(valid[..., None, None], k, 0.0)
        y, state = ops.wkv(r, k, v, w, p["u"], state)
        x = self._out_mix(p, x, y, g)
        h2 = L.rms_norm(x, p["ln_ffn"], eps)
        x_prev2 = _shift(h2) if ffn_prev is None else torch.cat(
            [ffn_prev[:, None].to(h2.dtype), h2[:, :-1]], 1)
        x = x + self._channel_mix(p, h2, x_prev2)
        if last is None:
            return x, state, h[:, -1], h2[:, -1]
        rows = torch.arange(x.shape[0], device=x.device)
        return x, state, h[rows, last], h2[rows, last]

    def _rwkv_block_step(self, p, x, wkv, att_shift, ffn_shift):
        """One token x (B, d); the shifts are the previous normed hiddens.
        -> (x, wkv, att shift, ffn shift)."""
        eps = self.cfg.rms_eps
        h = L.rms_norm(x, p["ln_att"], eps)
        r, k, v, g, w = (a[:, 0] for a in self._time_mix_proj(
            p, h[:, None], att_shift[:, None]))
        y, wkv = ops.wkv_step(r, k, v, w, p["u"], wkv)
        x = self._out_mix(p, x, y, g)
        h2 = L.rms_norm(x, p["ln_ffn"], eps)
        out = self._channel_mix(p, h2[:, None], ffn_shift[:, None])[:, 0]
        return x + out, wkv, h, h2

    # -- Mamba2 ------------------------------------------------------------

    def _mamba_split(self, p, x):
        s = self.cfg.ssm
        d_in = s.expand * self.cfg.d_model
        H = d_in // s.head_dim
        z, xc, Bc, Cc, dt = torch.split(
            x @ p["in_proj"], [d_in, d_in, s.d_state, s.d_state, H], -1)
        return z, xc, Bc, Cc, dt, d_in, H

    def _mamba_out(self, p, x, ys, xh, z, d_in):
        y = ys + p["d_skip"].float()[:, None] * xh
        y = y.reshape(x.shape[:-1] + (d_in,)).to(x.dtype)
        y = L.rms_norm(y * F.silu(z), p["ln_y"], self.cfg.rms_eps)
        return x + y @ p["out_proj"]

    def _mamba_block_seq(self, p, x, conv_state, ssm_state, valid=None,
                         last=None):
        """x (B, S, d); conv_state (B, d_conv-1, C), the causal conv's left
        context (zeros for a fresh sequence, the previous chunk's input
        tail for a continued one); ssm_state (B, H, hd, N) f32.  ``valid``
        identity-masks the SSD update at padded positions (la = 0, dtx = 0,
        B = 0); ``last`` picks the returned conv window ending at a per-row
        position instead of S.  -> (x, conv_state, ssm_state)."""
        s = self.cfg.ssm
        z, xc, Bc, Cc, dt, d_in, H = self._mamba_split(
            p, L.rms_norm(x, p["ln"], self.cfg.rms_eps))
        conv_in = torch.cat([xc, Bc, Cc], -1)
        B_, S = x.shape[:2]
        xp = torch.cat([conv_state.to(conv_in.dtype), conv_in], 1)
        acc = 0
        for i in range(s.d_conv):
            acc = acc + xp[:, i:i + S] * p["conv_w"][i]
        conv_out = F.silu(acc + p["conv_b"])
        if last is None:
            new_conv = xp[:, S:]
        else:
            idx = last[:, None] + 1 + torch.arange(s.d_conv - 1,
                                                   device=x.device)[None]
            new_conv = xp[torch.arange(B_, device=x.device)[:, None], idx]
        xc, Bc, Cc = torch.split(conv_out, [d_in, s.d_state, s.d_state], -1)
        xh = xc.reshape(B_, S, H, s.head_dim).float()
        dt = softplus(dt.float() + p["dt_bias"])                 # (B, S, H)
        la = -torch.exp(p["a_log"].float()) * dt
        Bf, Cf = Bc.float(), Cc.float()
        dtx = dt[..., None] * xh
        if valid is not None:
            la = torch.where(valid[..., None], la, 0.0)
            dtx = torch.where(valid[..., None, None], dtx, 0.0)
            Bf = torch.where(valid[..., None], Bf, 0.0)
        if s.chunk and S > s.chunk:
            ys, ssm_state = ops.ssd(la, dtx, Bf, Cf, ssm_state, chunk=s.chunk)
        else:
            ys, ssm_state = ops.ssd_scan(la, dtx, Bf, Cf, ssm_state)
        return self._mamba_out(p, x, ys, xh, z, d_in), new_conv, ssm_state

    def _mamba_block_step(self, p, x, conv_state, ssm_state):
        """x (B, d); conv_state (B, d_conv-1, C); ssm_state (B, H, hd, N)."""
        s = self.cfg.ssm
        z, xc, Bc, Cc, dt, d_in, H = self._mamba_split(
            p, L.rms_norm(x, p["ln"], self.cfg.rms_eps))
        conv_in = torch.cat([xc, Bc, Cc], -1)                     # (B, C)
        window = torch.cat([conv_state, conv_in[:, None]], 1)
        conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                          + p["conv_b"])
        xc, Bc, Cc = torch.split(conv_out, [d_in, s.d_state, s.d_state], -1)
        xh = xc.reshape(-1, H, s.head_dim).float()
        dt = softplus(dt.float() + p["dt_bias"])
        la = -torch.exp(p["a_log"].float()) * dt
        y, h = ops.ssd_step(la, dt[..., None] * xh, Bc.float(), Cc.float(),
                            ssm_state)
        return self._mamba_out(p, x, y, xh, z, d_in), window[:, 1:], h

    # -- hybrid shared block -------------------------------------------------

    def _shared_tail(self, sp, x, out):
        eps = self.cfg.rms_eps
        x = x + L.out_proj(sp["wo"], out)
        h = L.rms_norm(x, sp["ln_ffn"], eps)
        return x + L.apply_ffn(sp["w_in"], None, sp["w_out"], h, "gelu")

    def _shared_attn_seq(self, x, site: int, positions):
        """The shared block over x (B, S, d) -> (x, k, v)."""
        sp = self._shared()
        h = L.rms_norm(x, sp["ln_attn"][site], self.cfg.rms_eps)
        q, k, v = L.qkv_proj(sp["wq"], sp["wk"], sp["wv"], h, positions,
                             self.cfg.rope_theta)
        return self._shared_tail(sp, x, L.attention(q, k, v)), k, v

    def _shared_attn_step(self, x, site: int, k_cache, v_cache, pos):
        """The shared block on one token x (B, d) at per-row positions
        ``pos`` (B,), appending its k/v to the site's cache (in place)."""
        sp = self._shared()
        h = L.rms_norm(x, sp["ln_attn"][site], self.cfg.rms_eps)
        q, k, v = L.qkv_proj(sp["wq"], sp["wk"], sp["wv"], h[:, None],
                             pos[:, None], self.cfg.rope_theta)
        L.cache_write(k_cache, k, pos)
        L.cache_write(v_cache, v, pos)
        out = L.decode_attention(q, k_cache, v_cache, pos + 1)
        return self._shared_tail(sp, x[:, None], out)[:, 0]

    # -- forward -----------------------------------------------------------

    def _logits(self, x):
        x = L.rms_norm(x, self.ln_out, self.cfg.rms_eps)
        y = torch.einsum("...d,dv->...v", x, self._w("head", self.head))
        return y if self.spmd is None else self.spmd.logits(y)

    def _fresh_block(self, i: int, x):
        """Layer i over a fresh sequence x (B, S, d) (zero states) -> x."""
        B = x.shape[0]
        H, hd, N = self._dims()
        st0 = torch.zeros((B, H, hd, N), device=x.device)
        if self._rwkv:
            return self._rwkv_block_seq(self._layer(i), x, st0)[0]
        s = self.cfg.ssm
        conv0 = torch.zeros(
            (B, s.d_conv - 1, s.expand * self.cfg.d_model + 2 * s.d_state),
            dtype=x.dtype, device=x.device)
        return self._mamba_block_seq(self._layer(i), x, conv0, st0)[0]

    def forward(self, tokens: torch.Tensor, *, remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training forward (the reference's ``forward``, its
        ``_forward_with_cache`` without a cache): tokens (B, S) -> (logits
        (B, S, V), aux 0.0 f32), the hybrid's shared block after the layers
        ``sites_after`` names.  ``remat`` recomputes each recurrent layer in
        the backward (``torch.utils.checkpoint``, for ``jax.checkpoint``)."""
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x = self._embed(tokens)
        for i in range(self.cfg.n_layers):
            if remat:
                x = checkpoint(self._fresh_block, i, x, use_reentrant=False)
            else:
                x = self._fresh_block(i, x)
            site = self._sites[i]
            if site >= 0:
                x = self._shared_attn_seq(x, site, positions)[0]
        return self._logits(x), torch.zeros((), device=tokens.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int
                ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (logits (B, S, V), cache with pos = S)."""
        B, S = tokens.shape
        cache = self.init_cache(B, max_seq)
        H, hd, N = self._dims()
        dev = tokens.device
        x = self._embed(tokens)
        if self._rwkv:
            outs = []
            for i in range(self.cfg.n_layers):
                st0 = torch.zeros((B, H, hd, hd), device=dev)
                x, *state = self._rwkv_block_seq(self._layer(i), x, st0)
                outs.append(state)
            wkv, a_s, f_s = (torch.stack(z) for z in zip(*outs))
            cache.update(wkv=wkv, att_shift=a_s.to(cache["att_shift"].dtype),
                         ffn_shift=f_s.to(cache["ffn_shift"].dtype))
        else:
            positions = torch.arange(S, device=dev)[None].expand(B, S)
            conv0 = torch.zeros_like(cache["conv"][0], dtype=x.dtype)
            outs = []
            for i in range(self.cfg.n_layers):
                st0 = torch.zeros((B, H, hd, N), device=dev)
                x, cs, st = self._mamba_block_seq(self._layer(i), x, conv0,
                                                  st0)
                outs.append((cs, st))
                site = self._sites[i]
                if site >= 0:
                    x, k, v = self._shared_attn_seq(x, site, positions)
                    cache["k"][site, :, :S] = k
                    cache["v"][site, :, :S] = v
            conv, ssm = (torch.stack(z) for z in zip(*outs))
            cache.update(conv=conv.to(cache["conv"].dtype), ssm=ssm)
        cache["pos"] = torch.full((B,), S, dtype=torch.int64, device=dev)
        return self._logits(x), cache

    @torch.no_grad()
    def extend_step(self, tokens: torch.Tensor, cache: Cache,
                    n_valid=None) -> Tuple[torch.Tensor, Cache]:
        """Chunked-prefill continuation: tokens (B, ck) through the sequence
        path from the cache's carried state, advancing ``pos`` by
        ``n_valid`` (an int or (B,); default ck).  Positions >= n_valid
        are identity-masked, so a padded chunk tail adds nothing to any
        carried state.  -> (logits (B, ck, V), cache); the caller reads row
        n_valid - 1 for the last prompt logits.  A hybrid model raises
        (its shared-attention sites have no chunked extend)."""
        if self.cfg.arch_type == "hybrid":
            raise NotImplementedError(
                "chunked extend_step is not wired for hybrid (shared-"
                "attention) arches — admit hybrid drafters through a "
                "dense-mode engine (models.ssm.prefill + decode_step)")
        B, S = tokens.shape
        dev = tokens.device
        nv = (torch.full((B,), S, dtype=torch.int64, device=dev)
              if n_valid is None else
              torch.as_tensor(n_valid, dtype=torch.int64, device=dev)
              .expand(B))
        valid = torch.arange(S, device=dev)[None] < nv[:, None]
        last = torch.clamp_min(nv - 1, 0)
        x = self._embed(tokens)
        outs = []
        if self._rwkv:
            keep = (nv > 0)[:, None]       # rows with no valid tokens
            for i in range(self.cfg.n_layers):
                x, st, a_s, f_s = self._rwkv_block_seq(
                    self._layer(i), x, cache["wkv"][i],
                    att_prev=cache["att_shift"][i],
                    ffn_prev=cache["ffn_shift"][i], valid=valid, last=last)
                # the wkv state holds itself under the identity mask; the
                # gathered shift states need an explicit hold
                outs.append((st, torch.where(keep, a_s, cache["att_shift"][i]),
                             torch.where(keep, f_s, cache["ffn_shift"][i])))
            wkv, a_s, f_s = (torch.stack(z) for z in zip(*outs))
            new = dict(wkv=wkv, att_shift=a_s.to(cache["att_shift"].dtype),
                       ffn_shift=f_s.to(cache["ffn_shift"].dtype))
        else:
            for i in range(self.cfg.n_layers):
                x, cs, st = self._mamba_block_seq(
                    self._layer(i), x, cache["conv"][i], cache["ssm"][i],
                    valid=valid, last=last)
                outs.append((cs, st))
            conv, ssm = (torch.stack(z) for z in zip(*outs))
            new = dict(conv=conv.to(cache["conv"].dtype), ssm=ssm)
        return self._logits(x), dict(cache, **new, pos=cache["pos"] + nv)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """token (B,) -> (logits (B, V), cache with pos + 1)."""
        x = self._embed(token)
        pos = cache["pos"]
        outs = []
        if self._rwkv:
            for i in range(self.cfg.n_layers):
                x, *state = self._rwkv_block_step(
                    self._layer(i), x, cache["wkv"][i],
                    cache["att_shift"][i], cache["ffn_shift"][i])
                outs.append(state)
            wkv, a_s, f_s = (torch.stack(z) for z in zip(*outs))
            new = dict(wkv=wkv, att_shift=a_s.to(cache["att_shift"].dtype),
                       ffn_shift=f_s.to(cache["ffn_shift"].dtype))
        else:
            for i in range(self.cfg.n_layers):
                x, cs, st = self._mamba_block_step(
                    self._layer(i), x, cache["conv"][i], cache["ssm"][i])
                outs.append((cs, st))
                site = self._sites[i]
                if site >= 0:
                    x = self._shared_attn_step(x, site, cache["k"][site],
                                               cache["v"][site], pos)
            conv, ssm = (torch.stack(z) for z in zip(*outs))
            new = dict(conv=conv.to(cache["conv"].dtype), ssm=ssm)
        return self._logits(x), dict(cache, **new, pos=pos + 1)
