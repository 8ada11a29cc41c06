"""Model configuration — a copy of ``repro.configs.base.ModelConfig``
with the fields the dense path reads, kept here so the port imports
nothing of the JAX package.  Later slices add the fields of the families
they port."""
from __future__ import annotations

import dataclasses


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
    act: str = "silu"          # silu | gelu
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    rms_eps: float = 1e-5
    window: int = 0            # 0 = full causal attention
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)
