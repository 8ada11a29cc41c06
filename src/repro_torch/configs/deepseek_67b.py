"""deepseek-67b [dense] — llama-arch GQA [arXiv:2401.02954].  A copy of
``repro.configs.deepseek_67b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    act="silu",
    source="arXiv:2401.02954",
)
