"""rwkv6-3b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892].  A copy of ``repro.configs.rwkv6_3b``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads = d_model / head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    head_dim=64,
    act="sqrelu",          # rwkv channel-mix uses squared relu
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64),
    source="arXiv:2404.05892",
)
