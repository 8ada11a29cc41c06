"""Model configuration — a copy of ``repro.configs.base.ModelConfig``
with the fields the ported families read (dense, and the recurrent ``ssm``
and ``hybrid`` families), kept here so the port imports nothing of the JAX
package.  Later slices add the fields of the families they port."""
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
