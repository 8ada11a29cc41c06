"""The paper's model pairs (Sec. 5) and the tiny CPU pair — copies of
``repro.configs.paper_models``."""
from repro_torch.configs.base import ModelConfig

LLAMA_68M = ModelConfig(
    name="llama-68m", arch_type="dense", n_layers=2, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=32000, head_dim=64,
    act="silu", source="arXiv:2305.09781 (SpecInfer draft)")

LLAMA_7B = ModelConfig(
    name="llama-7b", arch_type="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=32000, head_dim=128,
    act="silu", source="arXiv:2302.13971")

GEMMA_2B = ModelConfig(
    name="gemma-2b", arch_type="dense", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=256128, head_dim=256,
    act="gelu", source="arXiv:2403.08295")

GEMMA_7B = ModelConfig(
    name="gemma-7b", arch_type="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256128, head_dim=256,
    act="gelu", source="arXiv:2403.08295")

TINY_TARGET = ModelConfig(
    name="tiny-target", arch_type="dense", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab=256, head_dim=64, act="silu",
    source="(this repo: CPU e2e example)")

TINY_DRAFT = ModelConfig(
    name="tiny-draft", arch_type="dense", n_layers=2, d_model=128,
    n_heads=2, n_kv_heads=2, d_ff=256, vocab=256, head_dim=64, act="silu",
    source="(this repo: CPU e2e example)")
