"""Model configuration — a copy of ``repro.configs.base`` (``MoEConfig``,
``SSMConfig``, ``ModelConfig`` with its parameter counts, and
``reduced``), kept here so the port imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # hidden dim of each expert FFN
    capacity_factor: float = 1.25
    # dense shared FFN applied alongside the experts (DeepSeek / Kimi)
    d_shared: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"       # "mamba2" | "rwkv6"
    d_state: int = 64
    d_conv: int = 4            # causal conv width (mamba2)
    head_dim: int = 64
    expand: int = 2            # d_inner = expand * d_model (mamba2)
    # sequence-mode recurrence chunk: 0 = per-timestep recurrence; >0 =
    # Mamba2 sequences longer than this run the chunked SSD scan in chunks
    # of this length (on the card the ``ssd`` kernel)
    chunk: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str             # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    act: str = "silu"          # silu | sqrelu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    moe_every: int = 1         # the reference's field; models take only 1
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # hybrid: number of ssm layers between shared attention applications
    hybrid_attn_every: int = 6
    # --- enc-dec (audio) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500     # stub frontend output length
    # --- vlm ---
    cross_attn_every: int = 0      # a cross-attention block after every k
    n_image_tokens: int = 1601     # stub vision frontend output length
    # --- attention variants ---
    window: int = 0            # 0 = full causal attention; >0 sliding window
    # the reference's grouped-GQA decode (the queries folded to (B, Sq,
    # Hkv, n_rep, hd)): the same function, which the port computes one way
    opt_decode: bool = False
    # the reference's (E -> model, C -> dp) MoE buffer constraints; they act
    # only on a mesh, which the port does not have (models.moe raises)
    moe_shard_constraints: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def supports_long_decode(self) -> bool:
        """True if a 500k-token decode is sub-quadratic for this config."""
        return self.arch_type in ("ssm", "hybrid") or self.window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head), the
        reference's formula."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        n_emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.arch_type in ("dense", "moe", "vlm", "audio"):
            attn = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                    + self.n_heads * hd * d)
            nmat = 3 if self.act == "silu" else 2  # gated vs plain FFN
            if self.moe is not None:
                m = self.moe
                ffn = m.n_experts * nmat * d * m.d_expert + d * m.n_experts
                ffn += nmat * d * m.d_shared
            else:
                ffn = nmat * d * self.d_ff
            per_layer = attn + ffn
        elif self.arch_type == "ssm":
            if self.ssm and self.ssm.kind == "rwkv6":
                per_layer = 5 * d * d + d * d + 3 * d * self.d_ff
            else:
                di = (self.ssm.expand if self.ssm else 2) * d
                per_layer = 2 * d * di + di * d + 3 * d * self.d_ff
        elif self.arch_type == "hybrid":
            di = (self.ssm.expand if self.ssm else 2) * d
            per_layer = 2 * d * di + di * d + 3 * d * self.d_ff
        n = n_emb + self.n_layers * per_layer
        if self.arch_type == "audio":
            n += self.n_encoder_layers * per_layer
        return n

    def active_param_count(self) -> int:
        """Parameters touched a token (MoE: the routed experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        nmat = 3 if self.act == "silu" else 2
        dense_ffn_per_layer = nmat * self.d_model * (
            m.top_k * m.d_expert + m.d_shared)
        full_ffn_per_layer = nmat * self.d_model * (
            m.n_experts * m.d_expert + m.d_shared)
        return self.param_count() - self.n_layers * (
            full_ffn_per_layer - dense_ffn_per_layer)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family — the reference's
    ``configs.base.reduced`` over the fields the port has: 2 layers,
    d_model <= 256, <= 4 heads, d_ff <= 512, vocab <= 512, head_dim 64, a
    hybrid's shared block every 2 layers, an SSM's d_state <= 16 and head
    size 32 (and ``chunk`` back at 0); ``overrides`` win, then n_kv_heads
    falls to 1 where it does not divide n_heads."""
    small = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4),
        n_kv_heads=min(cfg.n_kv_heads, max(1, min(cfg.n_heads, 4) // 2)),
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 512),
        head_dim=64,
        n_encoder_layers=2 if cfg.n_encoder_layers else 0,
        n_audio_frames=(32 if cfg.arch_type == "audio"
                        else cfg.n_audio_frames),
        n_image_tokens=16 if cfg.arch_type == "vlm" else cfg.n_image_tokens,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        hybrid_attn_every=(2 if cfg.arch_type == "hybrid"
                           else cfg.hybrid_attn_every),
        name=cfg.name + "-smoke",
    )
    if cfg.moe is not None:
        small["moe"] = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=min(cfg.moe.d_expert, 256),
            # smoke parity runs compare train and serve logits: a capacity
            # that never drops at smoke sizes
            capacity_factor=max(cfg.moe.capacity_factor, 8.0),
            d_shared=min(cfg.moe.d_shared, 256) if cfg.moe.d_shared else 0,
        )
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(
            kind=cfg.ssm.kind,
            d_state=min(cfg.ssm.d_state, 16),
            d_conv=cfg.ssm.d_conv,
            head_dim=32,
            expand=cfg.ssm.expand,
        )
    small.update(overrides)
    if small["n_heads"] % small["n_kv_heads"]:
        small["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **small)
