"""yi-6b [dense] — llama-arch GQA kv=4 [arXiv:2403.04652].  A copy of
``repro.configs.yi_6b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    act="silu",
    source="arXiv:2403.04652",
)
