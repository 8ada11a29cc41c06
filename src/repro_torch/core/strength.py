"""Watermark strength (Def. 3.1) and its theory (Thms 3.1–3.3) — the port
of ``repro.core.strength``.

    WS(P_ζ) = E_ζ[ KL(P_ζ ‖ P) ] = Ent(P) − E_ζ[ Ent(P_ζ) ]   (unbiased S)

Every estimator is Monte Carlo over n pseudorandom contexts ζ = 0..n−1,
batched: ``dist_fn`` is a decoder's ``modified_dist(probs (V,), key,
ctx_hashes (n,), stream) -> (n, V)``, which runs the scheme's sampling
kernel over the n rows on the card.  Everything runs on ``probs``'s
device.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prf


def entropy(p, dim=-1):
    p = torch.clamp_min(p, 0.0)
    return -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim)


def kl(p, q, dim=-1):
    p = torch.clamp_min(p, 0.0)
    ratio = (torch.log(torch.clamp_min(p, 1e-30))
             - torch.log(torch.clamp_min(q, 1e-30)))
    return torch.where(p > 0, p * ratio, 0.0).sum(dim)


def tv(p, q, dim=-1):
    return 0.5 * (p - q).abs().sum(dim)


def mc_modified_dists(dist_fn: Callable, probs, key, n_seeds: int,
                      stream=prf.STREAM_DRAFT):
    """P_ζ of ``probs`` (V,) for contexts 0..n_seeds−1: (n_seeds, V)."""
    ctxs = torch.arange(n_seeds, device=probs.device)
    return dist_fn(probs, key, ctxs, stream)


def watermark_strength(dist_fn: Callable, probs, key, n_seeds: int = 4096,
                       stream=prf.STREAM_DRAFT):
    """MC estimate of WS = E_ζ[KL(P_ζ ‖ P)]."""
    pz = mc_modified_dists(dist_fn, probs, key, n_seeds, stream)
    return kl(pz, probs[None, :]).mean()


def strength_via_entropy(dist_fn: Callable, probs, key, n_seeds: int = 4096,
                         stream=prf.STREAM_DRAFT):
    """Thm 3.2 identity: WS = Ent(P) − E_ζ Ent(P_ζ) (needs unbiasedness)."""
    pz = mc_modified_dists(dist_fn, probs, key, n_seeds, stream)
    return entropy(probs) - entropy(pz).mean()


def check_unbiased(dist_fn: Callable, probs, key, n_seeds: int = 8192,
                   stream=prf.STREAM_DRAFT):
    """max_w |E_ζ[P_ζ](w) − P(w)| (shrinks as 1/sqrt(n))."""
    pz = mc_modified_dists(dist_fn, probs, key, n_seeds, stream)
    return (pz.mean(0) - probs).abs().max()


def llr_pvalue_decay(dist_fn: Callable, probs, key, n_tokens: int,
                     n_seeds_null: int = 2048,
                     generator: Optional[torch.Generator] = None):
    """The empirical −(1/n)·log(pval) of the likelihood-ratio test (Thm
    3.1): one token per position drawn from P_ζ (contexts 77777 + t), Λ_n =
    Σ log(P_ζ(w_t)/P(w_t)), and the Chernoff bound pval ≤ exp(−Λ_n), so
    the result tends to WS.  The categorical draws come from
    ``generator`` (default: seed 123 on ``probs``'s device); a degenerate
    scheme's draws do not depend on it."""
    del n_seeds_null
    if generator is None:
        generator = torch.Generator(device=probs.device).manual_seed(123)
    ctxs = torch.arange(n_tokens, device=probs.device) + 77777
    pz = dist_fn(probs, key, ctxs, prf.STREAM_DRAFT)
    tok = torch.multinomial(torch.clamp_min(pz, 1e-30), 1,
                            generator=generator)[:, 0]
    rows = torch.arange(n_tokens, device=probs.device)
    z = (torch.log(torch.clamp_min(pz[rows, tok], 1e-30))
         - torch.log(torch.clamp_min(probs[tok], 1e-30)))
    return z.sum() / n_tokens
