"""Model configs of the port: the paper's dense pairs and the recurrent
draft families (rwkv6-3b, zamba2-1.2b)."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.paper_models import (GEMMA_2B, GEMMA_7B, LLAMA_7B,
                                              LLAMA_68M, TINY_DRAFT,
                                              TINY_TARGET)
from repro_torch.configs.rwkv6_3b import CONFIG as RWKV6_3B
from repro_torch.configs.zamba2_1_2b import CONFIG as ZAMBA2_1_2B

__all__ = ["ModelConfig", "SSMConfig", "LLAMA_68M", "LLAMA_7B",
           "GEMMA_2B", "GEMMA_7B", "TINY_TARGET", "TINY_DRAFT", "RWKV6_3B",
           "ZAMBA2_1_2B"]
