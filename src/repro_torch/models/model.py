"""Model API of the port — the dense counterpart of ``repro.models.model``.

    model = init_params(cfg, seed=0, dtype=torch.bfloat16)   # on cuda
    logits, cache = model.prefill(tokens, max_seq)
    logits, cache = model.decode_step(token, cache)
    logits, cache = model.extend_step(tokens, cache)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Transformer:
    """A model with random weights drawn from ``seed``; only the dense
    arch is ported, any other ``arch_type`` raises."""
    return Transformer(cfg, seed=seed, dtype=dtype, device=device)
