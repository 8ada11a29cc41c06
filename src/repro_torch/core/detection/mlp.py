"""A small MLP and an Adam fit for the detection heads (Bayes-MLP and the
ψ logistic model) — the port of ``repro.core.detection.mlp`` in torch.

Parameters are a list of ``{"w", "b"}`` layers (the MLP) or a dict of
tensors (the ψ model), leaves with ``requires_grad``.  ``fit`` runs
``torch.optim.Adam`` (the reference's update: bias-corrected moments,
eps outside the square root) full-batch or on minibatches drawn from a
seeded ``torch.Generator``; it is held to the reference by the AUCs of
what it trains, not bitwise (another generator, another order of sums).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def init_mlp(sizes: Sequence[int], *, seed: int = 0, device="cuda"):
    """Layers of N(0, 1/fan_in) weights and zero biases."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=g) / math.sqrt(a)
        params.append({"w": w.to(device).requires_grad_(),
                       "b": torch.zeros(b, device=device,
                                        requires_grad=True)})
    return params


def apply_mlp(params, x):
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def _leaves(params):
    if isinstance(params, dict):
        return list(params.values())
    return [t for layer in params for t in layer.values()]


def fit(loss_fn: Callable, params, data, *, steps=300, lr=1e-2, batch=None,
        seed=0):
    """Adam fit of ``loss_fn(params, data)`` over ``steps`` full-batch (or
    ``batch``-row minibatch) steps; returns (params, the last loss)."""
    opt = torch.optim.Adam(_leaves(params), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    first = next(iter(data.values()))
    n, dev = first.shape[0], first.device
    g = torch.Generator(device=dev).manual_seed(seed)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        if batch is None:
            d = data
        else:
            idx = torch.randint(0, n, (batch,), generator=g, device=dev)
            d = {k: v[idx] for k, v in data.items()}
        opt.zero_grad()
        loss = loss_fn(params, d)
        loss.backward()
        opt.step()
    return params, float(loss.detach())
