"""nemotron-4-340b [dense] — GQA, squared-ReLU FFN [arXiv:2402.16819].  A copy of
``repro.configs.nemotron_4_340b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    head_dim=192,          # 18432 / 96
    act="sqrelu",
    source="arXiv:2402.16819",
)
