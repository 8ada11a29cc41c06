"""llama-3.2-vision-11b [vlm] — text decoder with cross-attn image layers;
vision encoder (ViT) is a STUB — input_specs provides patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision].  A copy of
``repro.configs.llama_3_2_vision_11b``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    act="silu",
    cross_attn_every=5,    # every 5th layer cross-attends to image tokens
    n_image_tokens=1601,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
