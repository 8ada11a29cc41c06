"""Mixture-of-Experts FFN — the port of ``repro.models.moe``: top-k
routing with the reference's sort-based, capacity-bounded dispatch.

Assignments are ordered by a stable sort on their expert id, ranked within
their expert, and written into an (E·C + 1, d) buffer whose last row takes
the assignments past an expert's capacity C; the experts run as batched
products over the (E, C, d) buffer (``torch.einsum``, as the reference's
are jnp outside any Pallas kernel), and the always-on shared expert
(Kimi / DeepSeek) adds a dense FFN.  Serving's extend is dropless (C holds
every assignment); prefill and training use the capacity bound.

The combine does not scatter-add (on CUDA ``index_add_`` adds in an
unspecified order): each token's K contributions are gathered back
through the inverse of the sort and summed over k = 0 .. K-1 in order, so
the same inputs give the same bits run after run.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import activation


def moe_shapes(d_model: int, moe_cfg, act: str) -> Dict[str, tuple]:
    """Leaf name -> shape of one layer's MoE FFN, the reference's
    ``init_moe`` layout: router (d, E), experts (E, d, de) / (E, de, d),
    the shared expert (d, ds) / (ds, d).  ``Transformer`` draws them, the
    expert stacks one expert at a time."""
    m = moe_cfg
    shapes = {"router": (d_model, m.n_experts),
              "w_in": (m.n_experts, d_model, m.d_expert),
              "w_out": (m.n_experts, m.d_expert, d_model)}
    if act == "silu":
        shapes["w_gate"] = (m.n_experts, d_model, m.d_expert)
    if m.d_shared:
        shapes.update(shared_in=(d_model, m.d_shared),
                      shared_gate=(d_model, m.d_shared),
                      shared_out=(m.d_shared, d_model))
    return shapes


def capacity(n_tokens: int, moe_cfg) -> int:
    """The reference's expert capacity: T·K·factor / E + 1, rounded up to
    a multiple of 128 above 128, clamped to [8, T·K]."""
    c = int(n_tokens * moe_cfg.top_k * moe_cfg.capacity_factor
            / moe_cfg.n_experts) + 1
    if c > 128:
        c = -(-c // 128) * 128
    return min(max(c, 8), n_tokens * moe_cfg.top_k)


def route(x2, router, top_k: int):
    """Router probabilities (T, E) f32 and the top-k (gate, expert id)
    (T, K) of tokens x2 (T, d), gates renormalised to sum 1."""
    probs = torch.softmax(torch.einsum("td,de->te", x2, router).float(), -1)
    gate, eids = torch.topk(probs, top_k, dim=-1)
    return probs, gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9), \
        eids


def apply_moe(params: Dict[str, torch.Tensor], moe_cfg, x, act: str, *,
              dropless: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (..., d) -> (y of x's shape, {"lb_loss", "dropped_frac"}).
    ``dropless`` sizes the buffer for every assignment (serving's extend);
    otherwise the capacity bound drops the assignments past it.  (The
    reference's ``shard`` constraints act only on a mesh: a config with
    ``moe_shard_constraints`` is refused where the model is built.)"""
    m = moe_cfg
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    T, E, K = xf.shape[0], m.n_experts, m.top_k
    dev = xf.device
    f = activation(act)
    probs, gate, eids = route(xf, params["router"], K)

    # sort-based dispatch
    A = T * K
    flat_eid = eids.reshape(A)
    flat_gate = gate.reshape(A).to(xf.dtype)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    _, order = torch.sort(flat_eid, stable=True)
    sorted_eid = flat_eid[order]
    starts = torch.searchsorted(sorted_eid, torch.arange(E, device=dev),
                                side="left")
    rank = torch.arange(A, device=dev) - starts[sorted_eid]
    C = min(T, A) if dropless else capacity(T, m)
    keep = rank < C
    dest = torch.where(keep, sorted_eid * C + rank, E * C)
    buf = xf.new_zeros((E * C + 1, d))
    buf[dest] = xf[flat_tok[order]]
    h = buf[:E * C].reshape(E, C, d)

    # the experts
    hin = torch.einsum("ecd,edf->ecf", h, params["w_in"])
    if "w_gate" in params:
        hin = f(torch.einsum("ecd,edf->ecf", h, params["w_gate"])) * hin
    else:
        hin = f(hin)
    out = torch.einsum("ecf,efd->ecd", hin, params["w_out"])

    # the combine: each assignment's weighted output back in (token, k)
    # order through the inverse of the sort, summed over k in order
    out_flat = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))])
    contrib = out_flat[dest] * (flat_gate[order]
                                * keep.to(out.dtype))[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(A, device=dev)
    per_tok = contrib[inv].reshape(T, K, d)
    y = per_tok[:, 0]
    for k in range(1, K):
        y = y + per_tok[:, k]

    # the shared expert (always on)
    if "shared_in" in params:
        sh = torch.einsum("td,df->tf", xf, params["shared_in"])
        sh = f(torch.einsum("td,df->tf", xf, params["shared_gate"])) * sh
        y = y + torch.einsum("tf,fd->td", sh, params["shared_out"])

    # Switch-style load-balance terms
    me = probs.mean(0)
    ce = torch.bincount(flat_eid, minlength=E).float() / A
    aux = {"lb_loss": E * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y.reshape(x.shape), aux
