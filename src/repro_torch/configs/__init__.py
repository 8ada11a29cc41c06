"""Model configs of the port — a copy of ``repro.configs``: every
assigned architecture, the paper's dense pairs and the sliding-window
yi-6b, and a registry over them (``get_config("olmoe-1b-7b")`` /
``--arch olmoe-1b-7b``)."""
import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduced
from repro_torch.configs.deepseek_67b import CONFIG as DEEPSEEK_67B
from repro_torch.configs.deepseek_7b import CONFIG as DEEPSEEK_7B
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_K2_1T_A32B
from repro_torch.configs.llama_3_2_vision_11b import \
    CONFIG as LLAMA_3_2_VISION_11B
from repro_torch.configs.nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.paper_models import (GEMMA_2B, GEMMA_7B, LLAMA_7B,
                                              LLAMA_68M, TINY_DRAFT,
                                              TINY_TARGET)
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

_ASSIGNED = [NEMOTRON_4_340B, DEEPSEEK_67B, DEEPSEEK_7B, ZAMBA2_1_2B,
             RWKV6_3B, OLMOE_1B_7B, WHISPER_TINY, KIMI_K2_1T_A32B, YI_6B,
             LLAMA_3_2_VISION_11B]

# the reference's beyond-paper variant: sliding-window yi-6b
YI_6B_SWA = dataclasses.replace(
    YI_6B, name="yi-6b-swa4k", window=4096,
    source="arXiv:2403.04652 + sliding-window variant (this repo)")

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in _ASSIGNED + [
    LLAMA_68M, LLAMA_7B, GEMMA_2B, GEMMA_7B, TINY_TARGET, TINY_DRAFT,
    YI_6B_SWA]}
ASSIGNED_ARCHS = [c.name for c in _ASSIGNED]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    """The reduced variant of the same family (``reduced``) for CPU smoke
    tests."""
    return reduced(get_config(name), **overrides)


def draft_for(cfg: ModelConfig, *, n_layers: int = 4, d_model: int = 1024,
              window: int = 0) -> ModelConfig:
    """The companion draft for speculative serving: a small dense
    transformer sharing the target's vocabulary, whatever the target's
    family (the paper's drafts are small dense LMs)."""
    return ModelConfig(
        name=cfg.name + "-draft", arch_type="dense", n_layers=n_layers,
        d_model=d_model, n_heads=8, n_kv_heads=8, d_ff=4 * d_model,
        vocab=cfg.vocab, head_dim=d_model // 8, act="silu", window=window,
        source="draft companion (this repo)")


@dataclasses.dataclass(frozen=True)
class InputShape:
    """An assigned input shape: ``kind`` "train" (a train step), "prefill"
    or "decode" (one new token against a KV cache of ``seq_len``)."""
    name: str
    kind: str
    seq_len: int
    global_batch: int


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def supports_shape(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k needs sub-quadratic attention (SSM, hybrid or a sliding
    window); every other shape applies to every architecture."""
    if shape_name == "long_500k":
        return cfg.supports_long_decode
    return True


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "reduced", "REGISTRY",
           "ASSIGNED_ARCHS", "get_config", "get_smoke_config", "draft_for",
           "InputShape", "INPUT_SHAPES", "supports_shape", "LLAMA_68M",
           "LLAMA_7B", "GEMMA_2B", "GEMMA_7B", "TINY_TARGET", "TINY_DRAFT",
           "YI_6B", "YI_6B_SWA", "RWKV6_3B", "ZAMBA2_1_2B", "OLMOE_1B_7B",
           "KIMI_K2_1T_A32B", "NEMOTRON_4_340B", "DEEPSEEK_7B",
           "DEEPSEEK_67B", "LLAMA_3_2_VISION_11B", "WHISPER_TINY"]
