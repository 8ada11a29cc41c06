"""Carry a JAX params tree of the reference into the port's modules.

The tree is the reference's ``init_params`` output (or a checkpoint of
it) with every leaf turned into a numpy array, e.g.
``jax.tree.map(np.asarray, params)``.  Leaves keep their einsum layouts
(``repro/models/transformer.py`` and ``layers.py``): ``embed`` (V, d),
``head`` (d, V), ``ln_out`` (d,), and layer-stacked ``blocks`` with
``ln_attn``/``ln_ffn`` (L, d), ``attn.{wq,wk,wv}`` (L, d, H, hd),
``attn.wo`` (L, H, hd, d) and ``ffn.{w_in,w_gate}`` (L, d, ff),
``ffn.w_out`` (L, ff, d).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def _flat_blocks(blocks: Mapping[str, Any]):
    """blocks.{ln_attn, ln_ffn, attn.*, ffn.*} -> {leaf name: array}."""
    out = {"ln_attn": blocks["ln_attn"], "ln_ffn": blocks["ln_ffn"]}
    for group in ("attn", "ffn"):
        out.update(blocks[group])
    return out


def from_jax_tree(tree: Mapping[str, Any], cfg: ModelConfig, *,
                  dtype: torch.dtype = torch.float32,
                  device="cuda") -> Transformer:
    """A ``Transformer`` holding the tree's weights (cast to ``dtype``)."""
    model = Transformer(cfg, dtype=dtype, device=device)
    if cfg.tie_embeddings or "head" not in tree:
        raise NotImplementedError("tied embeddings are not ported")
    leaves = {"embed": tree["embed"], "head": tree["head"],
              "ln_out": tree["ln_out"]}
    leaves.update({f"blocks.{k}": v
                   for k, v in _flat_blocks(tree["blocks"]).items()})
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(f"tree leaves {sorted(leaves)} do not match the "
                         f"model's {sorted(params)}")
    for name, arr in leaves.items():
        arr = np.array(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(params[name].shape)}")
        params[name].data.copy_(torch.from_numpy(arr))
    return model
