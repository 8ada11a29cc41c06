"""Model configs of the port: the paper's dense pairs, yi-6b and the
recurrent draft families (rwkv6-3b, zamba2-1.2b), and a registry over them
(``get_config("yi-6b")`` / ``--arch yi-6b``)."""
from typing import Dict

from repro_torch.configs.base import ModelConfig, SSMConfig, reduced
from repro_torch.configs.paper_models import (GEMMA_2B, GEMMA_7B, LLAMA_7B,
                                              LLAMA_68M, TINY_DRAFT,
                                              TINY_TARGET)
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.yi_6b import CONFIG as YI_6B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in (
    YI_6B, RWKV6_3B, ZAMBA2_1_2B, LLAMA_68M, LLAMA_7B, GEMMA_2B, GEMMA_7B,
    TINY_TARGET, TINY_DRAFT)}

# the reference's other archs; their families arrive with ROADMAP's
# "Other families" item
NOT_PORTED = ("nemotron-4-340b", "deepseek-67b", "deepseek-7b",
              "olmoe-1b-7b", "whisper-tiny", "kimi-k2-1t-a32b",
              "llama-3.2-vision-11b", "yi-6b-swa4k")


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported; its family arrives with "
            "ROADMAP's \"Other families\" item")
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    """The reduced variant of the same family (``reduced``) for CPU smoke
    tests."""
    return reduced(get_config(name), **overrides)


__all__ = ["ModelConfig", "SSMConfig", "reduced", "REGISTRY", "get_config",
           "get_smoke_config", "LLAMA_68M", "LLAMA_7B", "GEMMA_2B",
           "GEMMA_7B", "TINY_TARGET", "TINY_DRAFT", "YI_6B", "RWKV6_3B",
           "ZAMBA2_1_2B"]
