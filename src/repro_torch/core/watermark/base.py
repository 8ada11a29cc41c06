"""Watermark decoder interface and registry — the port of
``repro.core.watermark.base``.

A ``Decoder`` declares how the serving engine drives a scheme: the PRF
streams of its draft and target draws, the width of its per-token
detection statistic, ``token_stat`` to recover that statistic from a
seed, its fused verification tail (``FusedTail``) and ``draft_sampler``,
the batched sampler every token of the serving path goes through.

``draft_sampler(probs, keys, ctx_hashes, seen, *, wm_stream,
plain_stream)`` samples (B, V) rows under per-row key words and context
hashes: unseen rows with the scheme's watermark under ``wm_stream`` (a
finite-m SynthID draw also uses the race stream ``STREAM_PLAIN +
wm_stream``), ``seen`` rows (repeated or strength-gated contexts) with a
plain Gumbel race on the raw row under ``plain_stream``.  It runs on the
``kernels.ops`` wrappers, so on the card every token comes from a kernel.

``modified_dist(probs (V,), key, ctx_hashes (n,), stream) -> (n, V)`` is
P_ζ of one row under n contexts (the Monte-Carlo view of the strength
and trade-off measures, batched over contexts), and ``recover_stats
(tokens, key, ctx_hashes, stream, vocab)`` recovers y_t at detection
time: (...,) when ``flat_stat`` (gumbel's U), else (..., stat_dim).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import prf
from repro_torch.kernels import ops

EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class FusedTail:
    """The scheme's branch of the fused verification tail.

    kind="race":       one Gumbel race over the residual / bonus row;
    kind="tournament": m SynthID rounds over the normalised row, then a
                       race (finite m) or argmax (degenerate, m->inf)."""
    kind: str
    m: int = 0
    stat_dim: int = 1
    degenerate: bool = False


def one_hot(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """(n,) tokens -> (n, vocab) f32 point masses (the modified
    distribution of a degenerate scheme)."""
    out = torch.zeros(tokens.shape + (vocab,), dtype=torch.float32,
                      device=tokens.device)
    return out.scatter_(-1, tokens[..., None], 1.0)


def race_argmax(probs: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Categorical sample of each (B, V) row as a counter-PRF Gumbel race
    (scale-invariant, so rows need no normalisation) -> (B,) tokens."""
    return ops.gumbel_argmax(probs, seeds)[0]


def race_draft_sampler(probs, keys, ctx_hashes, seen, *, wm_stream: int,
                       plain_stream: int) -> torch.Tensor:
    """Race-family sampling: the watermarked draw and the seen fallback
    are both races over the same row, so the seed is selected first."""
    seeds = torch.where(seen, prf.wm_seed(keys, ctx_hashes, plain_stream),
                        prf.wm_seed(keys, ctx_hashes, wm_stream))
    return race_argmax(probs, seeds)


@dataclasses.dataclass(frozen=True)
class Decoder:
    name: str
    # (probs (V,), key, ctx_hash, stream) -> (token, y_stat): one row, the
    # reference semantics the batched draft_sampler reproduces
    sample: Callable
    stat_dim: int = 1
    degenerate: bool = False
    draft_stream: int = prf.STREAM_DRAFT
    target_stream: int = prf.STREAM_TARGET
    # (seeds (...,), tokens (...,), vocab) -> (..., stat_dim) f32
    token_stat: Optional[Callable] = None
    fused_tail: Optional[FusedTail] = None
    draft_sampler: Optional[Callable] = None
    # (probs (V,), key, ctx_hashes (n,), stream) -> P_zeta (n, V)
    modified_dist: Optional[Callable] = None
    # (tokens (...,), key, ctx_hashes (...,), stream, vocab) -> y stats
    recover_stats: Optional[Callable] = None
    flat_stat: bool = True


_REGISTRY: Dict[str, Callable[..., Decoder]] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_decoder(name: str, **kw) -> Decoder:
    if name not in _REGISTRY:
        raise KeyError(f"unknown decoder {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
