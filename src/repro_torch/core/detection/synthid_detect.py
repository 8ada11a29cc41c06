"""SynthID Bayesian detectors under speculative sampling (Sec. 4.2, App. E)
— the port of ``repro.core.detection.synthid_detect`` in torch.

Watermarked g-value likelihood per tournament layer l:

    f1(g_l | g_<l) = 1/2 + (2·g_l − 1)·(1/4)·P(ψ_l = 2 | g_<l)

with P(ψ_l = 2 | ·) a logistic model (β_l + Σ_{j<l} δ_{l,j} g_j);
unwatermarked g-values are Bernoulli(1/2).  Per-token LLR given the
draft-selection probability q_t:

    llr_t = log[ q_t·R(y^D) + (1−q_t)·R(y^T) ],   R(y) = Π_l f1(g_l)/(1/2)

Selectors: Bayes-Prior (q_t ≡ p), Bayes-MLP (q_t = 1[u_t ≤ τ_t], τ_t an
MLP of (g^D, g^T) trained with σ(α(τ_t − u_t)) against the true source),
Oracle (q_t = 1[src_t = draft]).  The ψ fit, the MLP and the scores run
on ``device``; records stay numpy.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.detection.mlp import apply_mlp, fit, init_mlp
from repro_torch.core.detection.records import SeqRecord

ALPHA = 20.0


def init_psi(m: int, device="cuda"):
    return {"beta": torch.zeros(m, device=device, requires_grad=True),
            "delta": torch.zeros((m, m), device=device, requires_grad=True)}


def psi_prob(psi_params, g):
    """P(ψ_l = 2 | g_<l) of each layer; g (..., m) in {0, 1}."""
    m = g.shape[-1]
    tri = torch.tril(torch.ones((m, m), device=g.device), diagonal=-1)
    ctx = torch.einsum("...j,lj->...l", g, psi_params["delta"] * tri)
    return torch.sigmoid(psi_params["beta"] + ctx)


def log_f1(psi_params, g):
    """Σ_l log f1(g_l | g_<l); g (..., m)."""
    f1 = 0.5 + (2.0 * g - 1.0) * 0.25 * psi_prob(psi_params, g)
    return torch.log(torch.clamp_min(f1, 1e-9)).sum(-1)


def fit_psi(y_wm: np.ndarray, m: int, steps: int = 400, lr: float = 5e-2,
            device="cuda"):
    """Maximum-likelihood ψ model on watermarked (true-source) g-values
    (n, m)."""
    data = {"g": torch.as_tensor(np.asarray(y_wm), dtype=torch.float32,
                                 device=device)}

    def loss(params, d):
        return -log_f1(params, d["g"]).mean()

    params, _ = fit(loss, init_psi(m, device), data, steps=steps, lr=lr)
    return {k: v.detach() for k, v in params.items()}


def log_ratio(psi_params, g):
    """log R(y) = Σ_l [log f1 − log(1/2)]."""
    return log_f1(psi_params, g) - g.shape[-1] * math.log(0.5)


def _seq_score(psi_params, yd, yt, q) -> float:
    """Σ_t log[q_t·R(y^D_t) + (1−q_t)·R(y^T_t)]."""
    q = torch.clamp(q, 1e-6, 1 - 1e-6)
    per_tok = torch.logaddexp(torch.log(q) + log_ratio(psi_params, yd),
                              torch.log1p(-q) + log_ratio(psi_params, yt))
    return float(per_tok.sum())


def _stats(psi_params, r: SeqRecord):
    dev = psi_params["beta"].device
    return (torch.as_tensor(r.y_draft, dtype=torch.float32, device=dev),
            torch.as_tensor(r.y_target, dtype=torch.float32, device=dev))


def scores_prior(psi_params, records: Sequence[SeqRecord], p: float,
                 n_tokens: int) -> np.ndarray:
    out = []
    for r in records:
        r = r.truncate(n_tokens).dedupe()
        yd, yt = _stats(psi_params, r)
        out.append(_seq_score(psi_params, yd, yt,
                              torch.full((len(r.tokens),), float(p),
                                         device=yd.device)))
    return np.asarray(out)


def scores_oracle(psi_params, records: Sequence[SeqRecord],
                  n_tokens: int) -> np.ndarray:
    out = []
    for r in records:
        r = r.truncate(n_tokens).dedupe()
        yd, yt = _stats(psi_params, r)
        q = torch.as_tensor((r.src == 1).astype(np.float32), device=yd.device)
        out.append(_seq_score(psi_params, yd, yt, q))
    return np.asarray(out)


def fit_selector_mlp(records_wm: Sequence[SeqRecord], m: int, *,
                     hidden: int = 64, steps: int = 600, lr: float = 3e-3,
                     seed: int = 0, device="cuda"):
    """Train τ_t = MLP([g^D, g^T]) with BCE on σ(α(τ − u)) against the
    true source; returns (params, the last loss)."""
    def cat(parts, dtype=np.float32):
        return torch.as_tensor(np.concatenate(parts).astype(dtype),
                               device=device)

    data = {
        "x": cat([np.concatenate([r.y_draft, r.y_target], axis=-1)
                  for r in records_wm]),
        "u": cat([r.u for r in records_wm]),
        "y": cat([(r.src == 1) for r in records_wm]),
    }
    params = init_mlp([2 * m, hidden, hidden, 1], seed=seed, device=device)

    def loss(p, d):
        tau = torch.sigmoid(apply_mlp(p, d["x"])[..., 0])
        pred = torch.clamp(torch.sigmoid(ALPHA * (tau - d["u"])), 1e-6,
                           1 - 1e-6)
        return -(d["y"] * torch.log(pred)
                 + (1 - d["y"]) * torch.log(1 - pred)).mean()

    params, final_loss = fit(loss, params, data, steps=steps, lr=lr,
                             batch=min(4096, data["x"].shape[0]), seed=seed)
    return [{k: v.detach() for k, v in layer.items()} for layer in params], \
        final_loss


def scores_mlp(psi_params, mlp_params, records: Sequence[SeqRecord],
               n_tokens: int) -> np.ndarray:
    out = []
    for r in records:
        r = r.truncate(n_tokens).dedupe()
        yd, yt = _stats(psi_params, r)
        tau = torch.sigmoid(apply_mlp(mlp_params,
                                      torch.cat([yd, yt], -1))[..., 0])
        u = torch.as_tensor(r.u, dtype=torch.float32, device=yd.device)
        out.append(_seq_score(psi_params, yd, yt, (u <= tau).float()))
    return np.asarray(out)
