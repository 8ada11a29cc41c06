"""Explicit SPMD over ``torch.distributed``: the collectives that the
reference's partitioner derives from ``rules``' specs, called by each
rank on its own shards.

- ``Layout(mesh)``: the mesh as this rank sees it (its coordinate and
  process group on each axis) and the data-parallel split of a batch:
  ``rows(B)`` are this rank's rows of a batch of B, split over
  ``dp_axes(mesh, B)`` (a batch that does not divide replicates).
- ``shard_params(model, mesh)``: each rank keeps its slice of every
  parameter by its spec and frees the rest; the model then computes on
  the local slice of every "model"-sharded dim and gathers each layer's
  other sharded dims (the FSDP "data" dims) just before use
  (``Shards.full``).  The collectives of the layout are ``Shards``'
  methods: the all-reduce over "model" after a row-parallel product
  (``reduce``), the vocab-parallel embedding (``embed``) and the
  all-gather of vocab-sharded logits (``logits``).
- The dp gathers of the engine: ``Layout.all_true`` (one all-reduce of a
  flag), ``Layout.gather_rows`` (per-row host arrays gathered to every
  rank).

A sharded model is for serving (under ``torch.no_grad``): the
collectives are not recorded by autograd.  Collectives over an axis of
size 1 are skipped, so a 1x1 mesh computes exactly what no mesh does.
Every rank calls the same model functions in the same order: a rank
with no row in a call still makes it on a zero-row batch, so that its
gathers meet its peers'.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.sharding.rules import Spec, axis_sizes, dp_axes, param_specs

ROADMAP = "ROADMAP §1, \"Multi-device and TPU tooling\": "
TP_FAMILIES = ("dense",)      # the families that shard over "model"


class Layout:
    """A mesh (``DeviceMesh``) as this rank sees it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes: Dict[str, int] = axis_sizes(mesh)
        self.coord = {a: mesh.get_local_rank(a) for a in self.sizes}
        self.groups = {a: mesh.get_group(a) for a in self.sizes}
        # NCCL reduces CUDA tensors only; gloo takes CPU (and CUDA) ones
        self.flag_device = "cuda" if dist.get_backend() == "nccl" else "cpu"

    def __repr__(self) -> str:
        axes = "x".join(f"{a}={n}" for a, n in self.sizes.items())
        return f"mesh({axes})"

    # -- data parallel -----------------------------------------------------

    def dp(self, global_batch: int) -> Tuple[str, ...]:
        """The dp axes a batch of ``global_batch`` splits over (() when
        it replicates)."""
        return dp_axes(self.mesh, global_batch) or ()

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a batch of ``global_batch``: one block of
        B / dp rows, blocks in the row-major order of the dp axes."""
        axes = self.dp(global_batch)
        n = math.prod(self.sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coord[a]
        per = global_batch // n
        return slice(idx * per, (idx + 1) * per)

    def host_max(self, value: int, axes: Sequence[str]) -> int:
        """The max of a host integer over ``axes`` (one all-reduce an
        axis of more than one rank)."""
        axes = [a for a in axes if self.sizes[a] > 1]
        if not axes:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.flag_device)
        for a in axes:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.groups[a])
        return int(t.item())

    def all_true(self, flag: bool, axes: Sequence[str]) -> bool:
        """Whether ``flag`` holds on every rank over ``axes`` (the loop's
        done test)."""
        return self.host_max(int(not flag), axes) == 0

    def gather_rows(self, arrays: Mapping[str, Any], axes: Sequence[str]
                    ) -> Dict[str, Any]:
        """Gather per-row host data over the dp ``axes`` to every rank: each
        numpy array of ``arrays`` is this rank's rows (axis 0) and comes
        back as the whole batch's, in row order; each dict (keyed by
        slot) comes back as the union of the ranks'; any other value is
        the first block's.  One ``all_gather_object`` an axis, the
        innermost first."""
        out = dict(arrays)
        for a in reversed(axes):
            if self.sizes[a] == 1:
                continue
            parts: list = [None] * self.sizes[a]
            dist.all_gather_object(parts, out, group=self.groups[a])
            out = {k: (np.concatenate([p[k] for p in parts])
                       if isinstance(v, np.ndarray) else
                       {i: x for p in parts for i, x in p[k].items()}
                       if isinstance(v, dict) else parts[0][k])
                   for k, v in out.items()}
        return out

    # -- collectives on tensors --------------------------------------------

    def all_gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """Concatenate ``axis``' blocks of t along ``dim``."""
        n = self.sizes[axis]
        if n == 1:
            return t
        if not t.numel():    # a zero-row call: every peer's block is empty
            shape = list(t.shape)
            shape[dim] *= n
            return t.new_empty(shape)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.groups[axis])
        return torch.cat(parts, dim)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over ``axis`` (in place)."""
        if self.sizes[axis] > 1 and t.numel():
            dist.all_reduce(t, group=self.groups[axis])
        return t


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _padded(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


class Shards:
    """A model's parameters as this rank holds them: each parameter's
    spec, and the collectives a layer makes on them."""

    def __init__(self, layout: Layout, specs: Dict[str, Spec],
                 ndims: Dict[str, int]):
        self.layout = layout
        self.specs = {n: _padded(s, ndims[n]) for n, s in specs.items()}
        self.tp = layout.sizes.get("model", 1)
        self.tp_rank = layout.coord.get("model", 0)
        # some parameter is sharded over another axis than "model": every
        # model call gathers over it, so its peers must make the call too
        self.fsdp = any(a != "model" and layout.sizes[a] > 1
                        for spec in self.specs.values() for e in spec
                        for a in _axes(e))

    def _split(self, name: str, dim: int) -> bool:
        """Dim ``dim`` of parameter ``name`` is sharded over a "model" of
        more than one rank."""
        return self.tp > 1 and "model" in _axes(self.specs[name][dim])

    def local(self, name: str, dim: int, n: int) -> int:
        """The local extent of a dim of ``n`` that a layer computes on."""
        return n // self.tp if self._split(name, dim) else n

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """t (parameter ``name``, or a slice of it over leading dims) with
        every dim sharded over an axis other than "model" gathered."""
        spec = self.specs[name][len(self.specs[name]) - t.dim():]
        for dim, entry in enumerate(spec):
            for a in reversed(_axes(entry)):
                if a != "model":
                    t = self.layout.all_gather(t, dim, a)
        return t

    def reduce(self, name: str, dim: int, y: torch.Tensor) -> torch.Tensor:
        """The all-reduce over "model" after a row-parallel product that
        contracts dim ``dim`` (counted from the end) of parameter
        ``name``: ``wo``'s heads (-3), ``w_out``'s ff (-2)."""
        if self._split(name, dim):
            return self.layout.all_reduce(y.contiguous(), "model")
        return y

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows ``tokens`` of the embedding ``table`` (its vocab rows this
        rank's block when they are split): a masked lookup, then the sum
        over "model" (one row is non-zero: exact)."""
        if not self._split("embed", 0):
            return table[tokens]
        n = table.shape[0]
        local = tokens - self.tp_rank * n
        hit = (local >= 0) & (local < n)
        x = table[torch.clamp(local, 0, n - 1)]
        x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
        return self.layout.all_reduce(x, "model")

    def logits(self, y: torch.Tensor) -> torch.Tensor:
        """Logits over this rank's vocab block gathered to the full vocab
        (the samplers and the verification tail take whole rows)."""
        if not self._split("head", 1):
            return y
        return self.layout.all_gather(y, y.dim() - 1, "model")


def _refuse(cfg, layout: Layout) -> None:
    """The sharded shapes the port does not run, each naming its ROADMAP
    item; the local head counts must stay inside what the paged kernel
    (``ops.paged_attention``) takes."""
    tp = layout.sizes.get("model", 1)
    if tp == 1:
        return
    if cfg.arch_type not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}) on {layout}: {ROADMAP}\"model\" "
            "> 1 for MoE (expert-parallel), VLM, audio and the recurrent "
            "families is not ported")
    if cfg.n_kv_heads % tp:
        raise NotImplementedError(
            f"{cfg.name} on {layout}: {cfg.n_kv_heads} kv heads do not split "
            f"{tp} ways; {ROADMAP}the reference's fallback (the cache's "
            "sequence over \"model\", scores sequence-sharded) is not ported")
    hd = cfg.resolved_head_dim
    if not ops.paged_heads_error(cfg.n_heads, cfg.n_kv_heads, hd):
        error = ops.paged_heads_error(cfg.n_heads // tp,
                                      cfg.n_kv_heads // tp, hd)
        if error:
            raise ValueError(f"{cfg.name} on {layout}: this rank's heads "
                             f"leave the paged kernel's shapes: {error}")


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Keep this rank's slice of every parameter of ``model`` by its spec
    (``rules.param_specs``) and free the rest, in place; the model's
    layers then run the layout's collectives (``model.spmd``).  A model
    already sharded over this mesh is returned as it is."""
    layout = Layout(mesh)
    if model.spmd is not None:
        if model.spmd.layout.mesh is not mesh:
            raise ValueError(f"{model.cfg.name} is already sharded over "
                             f"{model.spmd.layout}")
        return model
    _refuse(model.cfg, layout)
    specs = param_specs(model, mesh)
    with torch.no_grad():
        for name, p in model.named_parameters():
            local = p.data
            for dim, entry in enumerate(_padded(specs[name], p.dim())):
                for a in _axes(entry):
                    n = layout.sizes[a]
                    size = local.shape[dim] // n
                    local = local.narrow(dim, layout.coord[a] * size, size)
            if local.shape != p.shape:
                p.data = local.clone()
    model.spmd = Shards(layout, specs,
                        {n: p.dim() for n, p in model.named_parameters()})
    return model


def refuse_moe_dp(models: Sequence[torch.nn.Module], layout: Layout,
                  global_batch: int) -> None:
    """A MoE model splits no batch: its capacity is global over the
    batch's tokens (``models.moe``), so a local batch would drop other
    assignments than the whole batch does."""
    if not layout.dp(global_batch):
        return
    for m in models:
        if m.cfg.moe is not None:
            raise NotImplementedError(
                f"{m.cfg.name} on {layout} splits a batch of {global_batch} "
                f"over dp: {ROADMAP}MoE under dp with the reference's "
                "global capacity is not ported")


def needs_peers(*models: torch.nn.Module) -> bool:
    """Whether a model call on this rank must be met by its dp peers
    (``Shards.fsdp``)."""
    return any(m.spmd is not None and m.spmd.fsdp for m in models)
