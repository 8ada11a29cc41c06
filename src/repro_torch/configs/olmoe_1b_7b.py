"""olmoe-1b-7b [moe] — 64 experts, top-8 [arXiv:2409.02060].  A copy of
``repro.configs.olmoe_1b_7b``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    act="silu",
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    source="arXiv:2409.02060",
)
