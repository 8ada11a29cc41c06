"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8, shared
expert (paper-table config) [arXiv:2501.kimi2].  A copy of
``repro.configs.kimi_k2_1t_a32b``."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    act="silu",
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048, d_shared=2048),
    source="arXiv:2501.kimi2",
)
