"""Name-based sharding rules over a mesh — the port of
``repro.sharding.rules``.

The mesh axes are ("data", "model") for a single pod and ("pod", "data",
"model") for the multi-pod configuration.  Policy, as in the reference:

- **Tensor parallel ("model")**: attention heads, FFN hidden dim, MoE
  experts, vocab (embed rows / head cols), SSM inner channels.
- **FSDP ("data")**: the d_model dim of every weight matrix is also
  sharded over "data" (a ZeRO-3 analogue); ``sharding.spmd`` gathers a
  layer's slice over it just before use.
- **Batch ("pod", "data")**: the leading batch dim of activations, state
  and output buffers.

Every rule is a *candidate list* per dim; the first candidate whose
axis-size product divides the dim, and whose axes no earlier dim of the
same tensor took, wins.  Anything unmatched replicates.

A spec is a plain tuple, one entry per dim (trailing ``None`` trimmed, as
the reference's ``PartitionSpec``): ``None``, an axis name, or a tuple of
names.  The functions take any mesh that exposes ``mesh_dim_names`` and
``shape`` (the sizes, in that order): a ``torch.distributed``
``DeviceMesh``, or a shape-only ``AbstractMesh`` such as the production
16x16 one.  A model's parameters are named by the reference's tree path
(``convert.ref_path``: ``blocks.wq`` is ``blocks/attn/wq``), so the
reference's regexes apply unchanged; ``param_specs`` reads names and
shapes only, so a model built on the ``meta`` device gets its specs at
full size without memory.

The reference's ``constrain_dims`` / ``constrain_batch`` are hints to
XLA's partitioner; the port's explicit layout (``sharding.spmd``) puts
every tensor where it belongs itself, so they have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.convert import ref_path

Spec = Tuple[Any, ...]

# Candidate axis-groups, in priority order, per *logical* role.
TP = ("model",)          # tensor-parallel group
FSDP = ("fsdp",)         # placeholder resolved per mesh (data)
DP = ("dp",)             # batch data-parallel group (pod + data)

AxisCandidates = Sequence[Sequence[str]]

# path-suffix regex -> right-aligned per-dim candidate lists (a copy of
# the reference's table)
_PARAM_RULES: List[Tuple[str, List[Optional[AxisCandidates]]]] = [
    # --- attention ---
    (r"(attn|cross)/wq$",        [[FSDP], [TP], None]),       # (d, H, hd)
    (r"(attn|cross)/w[kv]$",     [[FSDP], [TP], None]),       # (d, Hkv, hd)
    (r"(attn|cross)/wo$",        [[TP], None, [FSDP]]),       # (H, hd, d)
    # --- dense FFN ---
    (r"ffn/w_(in|gate)$",        [[FSDP], [TP]]),             # (d, ff)
    (r"ffn/w_out$",              [[TP], [FSDP]]),             # (ff, d)
    # --- MoE ---
    (r"moe/router$",             [[FSDP], None]),             # (d, E)
    (r"moe/w_(in|gate)$",        [[TP], [FSDP], None]),       # (E, d, de)
    (r"moe/w_out$",              [[TP], None, [FSDP]]),       # (E, de, d)
    (r"moe/w_shared_(in|gate)$", [[FSDP], [TP]]),
    (r"moe/w_shared_out$",       [[TP], [FSDP]]),
    # --- embeddings / unembedding ---
    (r"(^|/)embed$",             [[TP], [FSDP]]),             # (V, d)
    (r"(^|/)head$",              [[FSDP], [TP]]),             # (d, V)
    (r"(img|audio)_proj$",       [[FSDP], [TP]]),             # (d, d)
    # --- RWKV6 ---
    (r"w_(r|k|v|g|o|cr)$",       [[FSDP], [TP]]),             # (d, d)
    (r"w_ck$",                   [[FSDP], [TP]]),             # (d, ff)
    (r"w_cv$",                   [[TP], [FSDP]]),             # (ff, d)
    (r"lora_a$",                 [[FSDP], None]),
    (r"lora_b$",                 [None, [FSDP]]),
    (r"(^|/)u$",                 [[TP], None]),               # (H, hd)
    (r"(^|/)mu$",                [None, None]),               # (5, d)
    # --- Mamba2 ---
    (r"in_proj$",                [[FSDP], [TP]]),             # (d, d_in_all)
    (r"out_proj$",               [[TP], [FSDP]]),             # (d_inner, d)
    (r"conv_w$",                 [None, [TP]]),               # (width, ch)
    (r"conv_b$",                 [[TP]]),
    (r"(a_log|dt_bias|d_skip)$", [[TP]]),                     # (n_heads,)
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh by its axis names and sizes alone (``DeviceMesh``'s
    ``mesh_dim_names`` / ``shape``), for specs at shapes no process group
    holds: ``AbstractMesh(("data", "model"), (16, 16))``."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _resolve_group(group: Sequence[str], sizes: Mapping[str, int]
                   ) -> Optional[Tuple[str, ...]]:
    """Map logical groups (fsdp / dp) onto concrete mesh axes."""
    out: List[str] = []
    for a in group:
        if a == "fsdp":
            out.extend(ax for ax in ("data",) if ax in sizes)
        elif a == "dp":
            out.extend(ax for ax in ("pod", "data") if ax in sizes)
        elif a in sizes:
            out.append(a)
        else:
            return None
    return tuple(out) if out else None


def _axes_size(axes: Sequence[str], sizes: Mapping[str, int]) -> int:
    return math.prod(sizes[a] for a in axes)


def spec_for_shape(shape: Tuple[int, ...],
                   dim_rules: List[Optional[AxisCandidates]], mesh,
                   priority: Optional[Sequence[int]] = None) -> Spec:
    """Right-align ``dim_rules`` against ``shape``; leading dims replicate.
    ``priority`` (smaller first) lets e.g. a kv-heads dim claim "model"
    before a fallback sequence dim does."""
    sizes = axis_sizes(mesh)
    n_lead = len(shape) - len(dim_rules)
    if n_lead < 0:
        raise ValueError(f"{len(dim_rules)} dim rules for shape {shape}")
    entries: List[Any] = [None] * len(shape)
    used: set = set()
    order = range(len(dim_rules))
    if priority is not None:
        order = sorted(order, key=lambda i: priority[i])
    for i in order:
        dim, cands = shape[n_lead + i], dim_rules[i]
        for group in (cands or []):
            axes = _resolve_group(group, sizes)
            if axes is None or any(a in used for a in axes):
                continue
            if dim % _axes_size(axes, sizes) == 0:
                entries[n_lead + i] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_of(path: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of one parameter at the reference's tree ``path``."""
    for pat, dims in _PARAM_RULES:
        if re.search(pat, path) and len(dims) <= len(shape):
            return spec_for_shape(tuple(shape), dims, mesh)
    return ()


def param_specs(model: torch.nn.Module, mesh) -> Dict[str, Spec]:
    """{parameter name: spec} of a port model (any device, ``meta``
    included: names and shapes only)."""
    return {name: spec_of(ref_path(name), tuple(p.shape), mesh)
            for name, p in model.named_parameters()}


def opt_state_specs(model: torch.nn.Module, mesh) -> Dict[str, Any]:
    """AdamW state {m, v, step}: m and v mirror the parameters' specs."""
    ps = param_specs(model, mesh)
    return {"m": ps, "v": ps, "step": ()}


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Optional[Tuple[str, ...]]:
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return axes if axes else None


def dp_axes(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """The dp axes usable for ``global_batch``: drops "pod" first, then
    "data", until the batch divides.  None when nothing fits."""
    sizes = axis_sizes(mesh)
    axes = list(batch_axes(mesh) or ())
    while axes and global_batch % _axes_size(axes, sizes) != 0:
        axes.pop(0)
    return tuple(axes) if axes else None


def _dp_bspec(mesh, global_batch: int):
    axes = dp_axes(mesh, global_batch)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def _ndim(leaf) -> int:
    return len(leaf.shape if hasattr(leaf, "shape") else leaf)


def batch_spec(batch: Mapping[str, Any], mesh, *,
               global_batch: int) -> Dict[str, Spec]:
    """Shard the leading batch dim of every input (a tensor or a shape)
    over the dp axes, dropping axes until the batch divides."""
    bspec = _dp_bspec(mesh, global_batch)
    return {k: (bspec,) + (None,) * (_ndim(v) - 1) for k, v in batch.items()}


def logits_spec(mesh, *, global_batch: int, ndim: int = 3,
                vocab: Optional[int] = None) -> Spec:
    sizes = axis_sizes(mesh)
    bspec = _dp_bspec(mesh, global_batch)
    tp = "model" if "model" in sizes else None
    if tp and vocab is not None and vocab % sizes[tp] != 0:
        tp = None   # an odd vocab (whisper's 51865) cannot split
    return (bspec,) + (None,) * (ndim - 2) + (tp,)


# Cache entries, by key name -> (right-aligned dim rules, priority).
#   attention caches (..., B, S, Hkv, hd): batch over dp, heads over model,
#   with S-over-model as the fallback when kv-heads don't divide (heads
#   claim first through the priority vector).
_KV = ([[DP], [TP], [TP], None], [0, 2, 1, 3])
# block-paged pools (..., num_pages, page_size, Hkv, hd): pages are a
# shared arena, replicated over dp; only kv-heads split, over "model".  The
# page tables replicate per data shard.
_PAGED_KV = ([None, None, [TP], None], None)
_CACHE_RULES: Dict[str, Tuple[List[Optional[AxisCandidates]],
                              Optional[List[int]]]] = {
    "k":   _KV,
    "v":   _KV,
    "xk":  _KV,
    "xv":  _KV,
    "ck":  _KV,
    "cv":  _KV,
    # ssm / rwkv states: (..., B, heads, hd, state)
    "wkv": ([[DP], [TP], None, None], None),
    "ssm": ([[DP], [TP], None, None], None),
    "conv": ([[DP], None, [TP]], None),
    "att_shift": ([[DP], None], None),
    "ffn_shift": ([[DP], None], None),
    "pos": ([], None),
    "page_table": ([], None),
}


def cache_specs(cache: Mapping[str, Any], mesh, *,
                global_batch: int) -> Dict[str, Spec]:
    """{cache entry: spec} of a model cache (tensors or shapes); a cache
    with a ``page_table`` is block-paged, and its k/v are the shared
    pool."""
    dp = list(dp_axes(mesh, global_batch) or ())
    paged = "page_table" in cache

    def resolve(name, shape):
        rule = _PAGED_KV if (paged and name in ("k", "v")) \
            else _CACHE_RULES.get(name)
        if rule is None or not shape:
            return ()
        dims, prio = rule
        subst: List[Optional[AxisCandidates]] = []
        for d in dims:
            if d is None:
                subst.append(None)
                continue
            groups = []
            for g in d:
                if g == DP:
                    if dp:
                        groups.append(tuple(dp))
                else:
                    groups.append(g)
            subst.append(groups or None)
        if len(subst) > len(shape):
            subst = subst[-len(shape):]
            prio = prio[-len(shape):] if prio else None
        return spec_for_shape(tuple(shape), subst, mesh, prio)

    return {k: resolve(k, tuple(v.shape if hasattr(v, "shape") else v))
            for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Speculative-engine state (serve/engine.py)
# ---------------------------------------------------------------------------

_ENGINE_SCALAR_KEYS = ("step_idx",)


def engine_state_specs(state: Mapping[str, Any], mesh, *,
                       global_batch: int) -> Dict[str, Any]:
    """Specs of the engine state dict: the model caches through the cache
    rules, every other batch-leading entry over the dp axes, scalar step
    state replicated."""
    out: Dict[str, Any] = {}
    for k, v in state.items():
        if k in ("t_cache", "d_cache"):
            out[k] = cache_specs(v, mesh, global_batch=global_batch)
        elif k in _ENGINE_SCALAR_KEYS or not tuple(getattr(v, "shape", ())):
            out[k] = ()
        else:
            out[k] = batch_spec({k: v}, mesh, global_batch=global_batch)[k]
    return out


def batch_leading_specs(tree: Mapping[str, Any], mesh, *,
                        global_batch: int) -> Dict[str, Spec]:
    """Specs of per-sequence buffers: the leading dim over dp when it
    divides, scalars (0-d leaves, plain numbers) replicated."""
    return {k: (() if not tuple(getattr(v, "shape", ())) else
                batch_spec({k: v}, mesh, global_batch=global_batch)[k])
            for k, v in tree.items()}
