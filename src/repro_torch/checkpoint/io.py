"""Checkpoints as ``.npz`` files in the reference's layout
(``repro.checkpoint.io``): one array per leaf of the reference's params
tree, keyed by its path joined with "/" (``blocks/attn/wq``), bfloat16
stored as float32.  A checkpoint written by either package loads in the
other."""
from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
from torch import nn

from repro_torch import convert


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    flat = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            flat.update(_flatten(leaf, f"{prefix}{key}/"))
        else:
            arr = np.asarray(leaf)
            if arr.dtype.name == "bfloat16":    # npz cannot store it
                arr = arr.astype(np.float32)
            flat[f"{prefix}{key}"] = arr
    return flat


def _read(data, like: Mapping[str, Any], prefix: str = "") -> dict:
    out = {}
    for key, leaf in like.items():
        if isinstance(leaf, Mapping):
            out[key] = _read(data, leaf, f"{prefix}{key}/")
            continue
        arr = data[f"{prefix}{key}"]
        if arr.shape != np.shape(leaf):
            raise ValueError(f"shape mismatch at {prefix}{key}: "
                             f"{arr.shape} vs {np.shape(leaf)}")
        out[key] = arr.astype(np.asarray(leaf).dtype)
    return out


def save(path: str, tree) -> None:
    """Write a model's weights (``convert.to_jax_tree``) or a params tree
    (nested mappings of arrays) to ``path``."""
    if isinstance(tree, nn.Module):
        tree = convert.to_jax_tree(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load(path: str, like):
    """Read ``path`` into the structure of ``like``: a model gets the
    weights in place and is returned; a params tree gives a new tree of
    numpy arrays in its leaves' types.  A leaf whose shape differs from
    ``like``'s raises ValueError, a missing one KeyError."""
    with np.load(path) as data:
        if isinstance(like, nn.Module):
            return convert.assign(like, _read(data,
                                              convert.to_jax_tree(like)))
        return _read(data, like)
