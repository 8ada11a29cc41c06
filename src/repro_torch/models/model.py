"""Model API of the port — the counterpart of ``repro.models.model`` for
the ported families (dense, and the recurrent ``ssm`` / ``hybrid``).

    model = init_params(cfg, seed=0, dtype=torch.bfloat16)   # on cuda
    logits, aux = forward(model, {"tokens": tokens})         # training
    logits, cache = model.prefill(tokens, max_seq)
    logits, cache = model.decode_step(token, cache)
    logits, cache = model.extend_step(tokens, cache)
    cache = init_paged_cache(model, batch, num_pages, page_size, max_pages)
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import RecurrentLM
from repro_torch.models.transformer import Cache, Transformer

Model = Union[Transformer, RecurrentLM]
RECURRENT_ARCHS = ("ssm", "hybrid")


def is_recurrent(cfg: ModelConfig) -> bool:
    return cfg.arch_type in RECURRENT_ARCHS


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Model:
    """A model with random weights drawn from ``seed``: a ``Transformer``
    for ``dense``, a ``RecurrentLM`` for ``ssm`` and ``hybrid``; any other
    ``arch_type`` raises NotImplementedError."""
    if is_recurrent(cfg):
        return RecurrentLM(cfg, seed=seed, dtype=dtype, device=device)
    return Transformer(cfg, seed=seed, dtype=dtype, device=device)


def forward(model: Model, batch: Dict[str, torch.Tensor], *,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of either family: ``batch["tokens"]`` (B, S)
    -> (logits (B, S, V), aux loss () f32; 0 for the ported families)."""
    return model.forward(batch["tokens"], remat=remat)


def init_paged_cache(model: Model, batch: int, num_pages: int,
                     page_size: int, max_pages: int) -> Cache:
    """A zero block-paged KV cache for ``model`` (its type and device);
    ``extend_step`` reads and appends through its page table.  Attention
    models only: a recurrent model keeps O(1) state per slot."""
    if is_recurrent(model.cfg):
        raise ValueError(
            f"paged KV caching needs an attention cache; arch_type="
            f"{model.cfg.arch_type!r} keeps O(1) recurrent state per slot "
            "(nothing to page).  Recurrent/hybrid models serve as "
            "*drafters* via serve.drafter — their dense state lives "
            "outside the paged pool (init_serve_cache); as a paged "
            "*target* they are unsupported")
    return model.init_paged_cache(batch, num_pages, page_size, max_pages)
