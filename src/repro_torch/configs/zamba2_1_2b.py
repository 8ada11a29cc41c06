"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  A copy of ``repro.configs.zamba2_1_2b``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    act="gelu",
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, head_dim=64, expand=2),
    hybrid_attn_every=6,   # shared attn block applied every 6 mamba layers
    source="arXiv:2411.15242",
)
