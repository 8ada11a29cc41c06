"""Gumbel-max watermark detectors under speculative sampling (Sec. 4.2) —
a copy of ``repro.core.detection.gumbel_detect`` (numpy only), except
that the selectors broadcast a token's choice over (n, m) g-bit
statistics, where the reference's raise (``multikey.record_score`` scores
SynthID texts through them).

The classic Aaronson score for a token sequence is  Σ_t −log(1 − y_t),
where y_t = U_{w_t}.  Under H0 the y_t are U(0,1) so the score is
Gamma(n, 1); under H1 they concentrate near 1.  With speculative sampling
each position carries TWO candidate statistics (draft y^D_t, target y^T_t)
and a selector is needed:

- **Ars-τ   (ours)**: y_t = y^D if u_t < τ else y^T     (Eq. 11), with τ
  grid-searched on a train split for the best TPR@FPR.
- **Ars-Prior**:      y_t = y^D w.p. p else y^T         (Eq. 12), p = the
  observed acceptance rate.
- **Oracle**:         always the true-source statistic (upper bound).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.detection.records import SeqRecord, tpr_at_fpr


def ars_score(y: np.ndarray) -> float:
    """Normalized Aaronson score: z = (Σ −log(1−y_t) − n)/√n.

    Under H0 the sum is Gamma(n,1); the z-normalization makes scores
    comparable across sequences whose deduped lengths differ."""
    y = np.clip(y, 1e-9, 1.0 - 1e-9)
    n = max(len(y), 1)
    return float((np.sum(-np.log(1.0 - y)) - n) / np.sqrt(n))


def _per_token(mask: np.ndarray, y: np.ndarray) -> np.ndarray:
    """A (n,) token mask shaped to broadcast over (n,) or (n, m) stats."""
    return mask.reshape(mask.shape + (1,) * (y.ndim - mask.ndim))


def select_tau(rec: SeqRecord, tau: float) -> np.ndarray:
    return np.where(_per_token(rec.u < tau, rec.y_draft), rec.y_draft,
                    rec.y_target)


def select_prior(rec: SeqRecord, p: float, rng: np.random.Generator):
    pick_draft = rng.uniform(size=rec.u.shape) < p
    return np.where(_per_token(pick_draft, rec.y_draft), rec.y_draft,
                    rec.y_target)


def select_oracle(rec: SeqRecord) -> np.ndarray:
    return np.where(_per_token(rec.src == 1, rec.y_draft), rec.y_draft,
                    rec.y_target)


def scores_tau(records: Sequence[SeqRecord], tau: float, n_tokens: int):
    return np.array([ars_score(select_tau(r.truncate(n_tokens).dedupe(),
                                         tau)) for r in records])


def scores_prior(records: Sequence[SeqRecord], p: float, n_tokens: int,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    return np.array([ars_score(select_prior(r.truncate(n_tokens).dedupe(),
                                           p, rng)) for r in records])


def scores_oracle(records: Sequence[SeqRecord], n_tokens: int):
    return np.array([ars_score(select_oracle(
        r.truncate(n_tokens).dedupe())) for r in records])


def calibrate_tau(train_wm: Sequence[SeqRecord],
                  train_null: Sequence[SeqRecord], n_tokens: int,
                  fpr: float = 0.01, grid: int = 100) -> float:
    """Paper App. F.1: grid-search 100 evenly spaced τ ∈ [0,1], pick the one
    maximizing TPR at the desired FPR on the train split."""
    best_tau, best_tpr = 0.5, -1.0
    for tau in np.linspace(0.0, 1.0, grid):
        s_wm = scores_tau(train_wm, tau, n_tokens)
        s_null = scores_tau(train_null, tau, n_tokens)
        t = tpr_at_fpr(s_wm, s_null, fpr)
        if t > best_tpr:
            best_tpr, best_tau = t, float(tau)
    return best_tau


def estimate_acceptance_prior(records: Sequence[SeqRecord]) -> float:
    """p for Ars-Prior: observed fraction of tokens that came from the
    draft (as estimated from acceptance rates, Dathathri et al.)."""
    fr = [r.accept_ratio for r in records]
    return float(np.mean(fr)) if fr else 0.5
