"""Model configuration — a copy of ``repro.configs.base.ModelConfig``
with the fields the ported families read (dense, and the recurrent ``ssm``
and ``hybrid`` families), and of its ``reduced``, kept here so the port
imports nothing of the JAX package.  Later slices add the fields of the
families they port."""
from __future__ import annotations

import dataclasses
from typing import Optional


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
    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    # hybrid: number of ssm layers between shared attention applications
    hybrid_attn_every: int = 6
    window: int = 0            # 0 = full causal attention
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)


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
        hybrid_attn_every=(2 if cfg.arch_type == "hybrid"
                           else cfg.hybrid_attn_every),
        name=cfg.name + "-smoke",
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
