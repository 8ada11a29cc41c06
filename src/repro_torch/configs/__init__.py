"""Model configs of the port (dense families of the paper's pairs)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.paper_models import (GEMMA_2B, GEMMA_7B, LLAMA_7B,
                                              LLAMA_68M, TINY_DRAFT,
                                              TINY_TARGET)

__all__ = ["ModelConfig", "LLAMA_68M", "LLAMA_7B",
           "GEMMA_2B", "GEMMA_7B", "TINY_TARGET", "TINY_DRAFT"]
