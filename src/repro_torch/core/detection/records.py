"""Detection data model — a copy of ``repro.core.detection.records``
(numpy only).

A generation run under (watermarked) speculative sampling yields, per token:

    y^D — the detection statistic under the DRAFT stream ζ^D
    y^T — the statistic under the TARGET stream ζ^T
    u   — the acceptance coin u_t = G(ζ^R_t)  (Alg. 1 only; recoverable)
    src — ground-truth source (1 = accepted draft token, 0 = target/
          residual/bonus — matching ``StepOutput.from_draft``), available
          only to the Oracle detector and for MLP training.

Gumbel statistics are scalars (the recovered U value); SynthID statistics
are m-vectors of g-bits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# numpy 2 renamed trapz; older numpy has only the old name
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclasses.dataclass
class SeqRecord:
    """Per-sequence detection record (numpy, host-side)."""
    tokens: np.ndarray          # (N,) int32
    y_draft: np.ndarray         # (N,) or (N, m)
    y_target: np.ndarray        # (N,) or (N, m)
    u: np.ndarray               # (N,) acceptance coins (recovered)
    src: np.ndarray             # (N,) int8 ground truth (oracle only)
    watermarked: bool
    accept_ratio: float = 0.0   # empirical draft fraction (for Prior rules)
    ctx: Optional[np.ndarray] = None   # (N,) uint32 context hashes

    def truncate(self, n: int) -> "SeqRecord":
        return SeqRecord(self.tokens[:n], self.y_draft[:n],
                         self.y_target[:n], self.u[:n], self.src[:n],
                         self.watermarked, self.accept_ratio,
                         None if self.ctx is None else self.ctx[:n])

    def dedupe(self) -> "SeqRecord":
        """Keep only the FIRST occurrence of each context hash.

        Repeated contexts reuse the same pseudorandom ζ: at generation
        time the engine skips watermarking them (repeated-context
        masking); at detection time they must be dropped for the same
        reason — under H0 they repeat identical statistics, breaking the
        i.i.d. null and inflating/deflating scores on repetitive text."""
        if self.ctx is None:
            return self
        _, first = np.unique(self.ctx, return_index=True)
        keep = np.zeros(len(self.ctx), bool)
        keep[first] = True
        return SeqRecord(self.tokens[keep], self.y_draft[keep],
                         self.y_target[keep], self.u[keep], self.src[keep],
                         self.watermarked, self.accept_ratio,
                         self.ctx[keep])


def tpr_at_fpr(scores_wm: np.ndarray, scores_null: np.ndarray,
               fpr: float = 0.01) -> float:
    """TPR at a fixed FPR: threshold = (1-fpr)-quantile of the null scores."""
    thr = np.quantile(scores_null, 1.0 - fpr)
    return float(np.mean(scores_wm > thr))


def roc_curve(scores_wm: np.ndarray, scores_null: np.ndarray, n: int = 200):
    thrs = np.quantile(np.concatenate([scores_wm, scores_null]),
                       np.linspace(0, 1, n))
    fpr = [(scores_null > t).mean() for t in thrs]
    tpr = [(scores_wm > t).mean() for t in thrs]
    return np.asarray(fpr), np.asarray(tpr)


def auc(scores_wm: np.ndarray, scores_null: np.ndarray) -> float:
    f, t = roc_curve(scores_wm, scores_null, n=500)
    order = np.argsort(f)
    return float(_trapezoid(t[order], f[order]))
