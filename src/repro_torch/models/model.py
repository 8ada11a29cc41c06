"""Model API of the port — the counterpart of ``repro.models.model``,
dispatching on ``cfg.arch_type``: the attention families (``dense``,
``moe``, ``vlm``, ``audio``) and the recurrent ``ssm`` / ``hybrid``.

    model = init_params(cfg, seed=0, dtype=torch.bfloat16)   # on cuda
    logits, aux = forward(model, {"tokens": tokens})         # training
    logits, cache = model.prefill(tokens, max_seq)
    logits, cache = model.prefill(tokens, max_seq, extras)   # vlm / audio
    logits, cache = model.decode_step(token, cache)
    logits, cache = model.extend_step(tokens, cache)
    cache = init_paged_cache(model, batch, num_pages, page_size, max_pages)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import RecurrentLM
from repro_torch.models.transformer import ATTN_ARCHS, Cache, Transformer

Model = Union[Transformer, RecurrentLM]
RECURRENT_ARCHS = ("ssm", "hybrid")


def is_recurrent(cfg: ModelConfig) -> bool:
    return cfg.arch_type in RECURRENT_ARCHS


def init_params(cfg: ModelConfig, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Model:
    """A model with random weights drawn from ``seed``: a ``Transformer``
    for the attention families, a ``RecurrentLM`` for ``ssm`` and
    ``hybrid``; any other ``arch_type`` raises ValueError."""
    if is_recurrent(cfg):
        return RecurrentLM(cfg, seed=seed, dtype=dtype, device=device)
    if cfg.arch_type in ATTN_ARCHS:
        return Transformer(cfg, seed=seed, dtype=dtype, device=device)
    raise ValueError(f"unknown arch_type {cfg.arch_type}")


def forward(model: Model, batch: Dict[str, torch.Tensor], *,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward of any family: ``batch["tokens"]`` (B, S), and
    "image_emb" / "audio_emb" for a VLM / audio model -> (logits (B, S,
    V), aux loss () f32: the MoE load-balance loss, else 0)."""
    if is_recurrent(model.cfg):
        return model.forward(batch["tokens"], remat=remat)
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    return model.forward(batch["tokens"], remat=remat, extras=extras)


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


def example_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                  dtype: torch.dtype = torch.float32, device="cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Random inputs from ``seed``: "tokens" (batch, seq) in [0, vocab),
    and the stub frontends' N(0, 1) embeddings, "audio_emb" (batch,
    n_audio_frames, d) or "image_emb" (batch, n_image_tokens, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, seq)), dtype=torch.int64,
        device=device)}
    frames = {"audio": ("audio_emb", cfg.n_audio_frames),
              "vlm": ("image_emb", cfg.n_image_tokens)}.get(cfg.arch_type)
    if frames is not None:
        name, n = frames
        gen = torch.Generator(device=device).manual_seed(seed)
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=device).to(dtype)
    return out


def extras_of(batch: Optional[Dict[str, torch.Tensor]]):
    """The modality inputs of a batch (everything but "tokens"), or None
    when it has none."""
    extras = {k: v for k, v in (batch or {}).items() if k != "tokens"}
    return extras or None
