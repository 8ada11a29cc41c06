"""Carry a JAX params tree of the reference into the port's modules.

The tree is the reference's ``init_params`` output (or a checkpoint of
it) with every leaf turned into a numpy array, e.g.
``jax.tree.map(np.asarray, params)``.  Leaves keep their einsum layouts
and names.  Dense (``repro/models/transformer.py`` and ``layers.py``):
``embed`` (V, d), ``head`` (d, V), ``ln_out`` (d,), and layer-stacked
``blocks`` with ``ln_attn``/``ln_ffn`` (L, d), ``attn.{wq,wk,wv}`` (L, d,
H, hd), ``attn.wo`` (L, H, hd, d) and ``ffn.{w_in,w_gate}`` (L, d, ff),
``ffn.w_out`` (L, ff, d).  MoE blocks hold ``moe.{router, w_in, w_gate,
w_out, shared_in, shared_gate, shared_out}`` in place of ``ffn``; audio
decoder blocks add ``ln_cross`` and ``cross.{wq,wk,wv,wo}``, beside
``enc_blocks`` and ``audio_proj``; a VLM has ``blocks`` of (n_groups, g,
...), ``cross_blocks`` (n_groups, ...) and ``img_proj``.  In the port a
group's ``attn`` and ``ffn`` leaves sit flat (``blocks.wq``), every other
sub-group keeps its name (``blocks.moe.w_in``, ``cross_blocks.cross.wq``),
and a VLM's self blocks are flat over n_groups · g.  Recurrent
(``repro/models/ssm.py``): the same
``embed``/``head``/``ln_out``, flat layer-stacked ``blocks.*`` (RWKV6 or
Mamba2 leaves) and, for the hybrid, ``shared`` with ``ln_attn`` (n_sites,
d), ``ln_ffn``, ``attn.*`` and the gelu ``ffn.{w_in, w_out}``.

``to_jax_tree`` goes the other way: a model's weights (or, through
``as_tree``, any {parameter name: tensor} such as its gradients) as such
a tree of float32 numpy arrays, the layout ``checkpoint.io`` writes.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, init_params


def _flat(group: Mapping[str, Any]):
    """{ln_*, attn: {...}, ffn: {...}, moe: {...}, ...} -> {parameter
    name within the group: array}: the ``attn`` / ``ffn`` leaves flat,
    any other sub-group's as "sub.leaf"."""
    out = {}
    for name, leaf in group.items():
        if isinstance(leaf, Mapping):
            out.update({(k if name in ("attn", "ffn") else f"{name}.{k}"): v
                        for k, v in leaf.items()})
        else:
            out[name] = leaf
    return out


# the leaves a transformer block (or the hybrid's shared block) nests
# under "attn" and "ffn"; no recurrent block has a leaf of these names
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
FFN_LEAVES = ("w_in", "w_gate", "w_out")


def _nest(group: Mapping[str, Any]):
    """The inverse of ``_flat``: {parameter name: array} -> {ln_*, attn:
    {...}, ffn: {...}, sub: {...}, ...}."""
    out = {}
    for name, leaf in group.items():
        sub, _, rest = name.partition(".")
        if rest:
            out.setdefault(sub, {})[rest] = leaf
            continue
        sub = ("attn" if name in ATTN_LEAVES else
               "ffn" if name in FFN_LEAVES else None)
        if sub is None:
            out[name] = leaf
        else:
            out.setdefault(sub, {})[name] = leaf
    return out


def ref_path(name: str) -> str:
    """The reference's tree path of a port parameter, as ``as_tree``
    nests it: "blocks.wq" -> "blocks/attn/wq", "blocks.moe.w_in" ->
    "blocks/moe/w_in", "embed" -> "embed"."""
    top, _, leaf = name.partition(".")
    path, node = [top], _nest({leaf: None}) if leaf else None
    while isinstance(node, dict):
        key = next(iter(node))
        path.append(key)
        node = node[key]
    return "/".join(path)


def _vlm_groups(tree: dict, cfg: ModelConfig, to_ref: bool) -> dict:
    """A VLM's ``blocks`` between the reference's (n_groups, g, ...) and
    the port's flat (n_groups · g, ...) leaves."""
    if cfg.arch_type != "vlm":
        return tree
    g = cfg.cross_attn_every

    def walk(x):
        if isinstance(x, Mapping):
            return {k: walk(v) for k, v in x.items()}
        x = np.asarray(x)
        return (x.reshape((x.shape[0] // g, g) + x.shape[1:]) if to_ref
                else x.reshape((-1,) + x.shape[2:]))
    return dict(tree, blocks=walk(tree["blocks"]))


def as_tree(named: Mapping[str, torch.Tensor]) -> dict:
    """{parameter name: tensor} (``named_parameters()``, or a tensor per
    parameter such as its gradient) -> the reference's params tree, each
    leaf a float32 numpy array."""
    tree, groups = {}, {}
    for name, t in named.items():
        arr = t.detach().float().cpu().numpy()
        top, _, leaf = name.partition(".")
        if leaf:
            groups.setdefault(top, {})[leaf] = arr
        else:
            tree[top] = arr
    tree.update({top: _nest(g) for top, g in groups.items()})
    return tree


def to_jax_tree(model: Model) -> dict:
    """The model's weights as the reference's params tree of float32
    numpy arrays: the inverse of ``from_jax_tree``."""
    return _vlm_groups(as_tree(dict(model.named_parameters())), model.cfg,
                       to_ref=True)


def from_jax_tree(tree: Mapping[str, Any], cfg: ModelConfig, *,
                  dtype: torch.dtype = torch.float32,
                  device="cuda") -> Model:
    """A ``Transformer`` or ``RecurrentLM`` holding the tree's weights
    (cast to ``dtype``)."""
    return assign(init_params(cfg, dtype=dtype, device=device), tree)


def assign(model: Model, tree: Mapping[str, Any]) -> Model:
    """Copy the tree's weights into ``model``'s parameters (in place,
    cast to their type); the tree must hold exactly the model's leaves,
    each of its shape, or this raises ValueError."""
    cfg = model.cfg
    if cfg.tie_embeddings or "head" not in tree:
        raise NotImplementedError("tied embeddings are not ported")
    tree = _vlm_groups(tree, cfg, to_ref=False)
    leaves = {}
    for top, sub in tree.items():
        if isinstance(sub, Mapping):
            leaves.update({f"{top}.{k}": v for k, v in _flat(sub).items()})
        else:
            leaves[top] = sub
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(f"tree leaves {sorted(leaves)} do not match the "
                         f"model's {sorted(params)}")
    for name, arr in leaves.items():
        arr = np.array(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(params[name].shape)}")
        with torch.no_grad():
            params[name].copy_(torch.from_numpy(arr))
    return model
