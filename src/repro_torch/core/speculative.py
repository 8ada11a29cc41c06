"""Speculative sampling operators (Sec. 2) and the token-level Alg. 1
verify — the port of ``repro.core.speculative``.

Distribution level (the trade-off numerics):

- ``residual_dist``        (P − Q)_+ normalised
- ``acceptance_rate``      Σ_w min(P_w, Q_w) = 1 − TV(Q, P)
- ``apply_spec_kernel``    A_spec(Q, P) ∘ Q_ζ (Eq. 5, Hu's composition)
- ``apply_google_kernel``  A_ξ(Q, P) ∘ Q_ζ with a watermarked residual
                           (App. C.2)
- ``alg1_output_dist``     P'_ζ of Alg. 1 (Eq. 15)

Token level: ``verify_tokens`` accepts a prefix of K drafts against coins
u, from ``standard_acceptance_coins`` (a ``torch.Generator``) or
``pseudorandom_acceptance_coins`` (u = G(ζ^R), recoverable).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prf

EPS = 1e-30


def residual_dist(p, q):
    """(P − Q)_+ normalised; where P == Q, P itself (never sampled)."""
    r = torch.clamp_min(p - q, 0.0)
    z = r.sum(-1, keepdim=True)
    return torch.where(z > EPS, r / torch.clamp_min(z, EPS), p)


def acceptance_rate(q, p, dim=-1):
    return torch.minimum(p, q).sum(dim)


def accept_prob(p, q):
    return torch.clamp_max(p / torch.clamp_min(q, EPS), 1.0)


def apply_spec_kernel(qz, p, q):
    """A_spec(Q, P) ∘ Q_ζ: qz the watermarked draft dist (..., V); p, q
    the unwatermarked target and draft."""
    a = accept_prob(p, q)
    rej_mass = (qz * (1.0 - a)).sum(-1, keepdim=True)
    return qz * a + residual_dist(p, q) * rej_mass


def apply_google_kernel(qz, p, q, resid_z):
    """A_ξ(Q, P) ∘ Q_ζ with a watermarked residual distribution
    resid_z = S((P − Q)_+, ξ) (Google's class)."""
    a = accept_prob(p, q)
    rej_mass = (qz * (1.0 - a)).sum(-1, keepdim=True)
    return qz * a + resid_z * rej_mass


def alg1_output_dist(qz, p, q, resid_z, u):
    """Eq. (15): P'_ζ(w) with the pseudorandom acceptance coin u."""
    acc_ind = (u < accept_prob(p, q)).to(qz.dtype)
    acc_mass = (qz * acc_ind).sum(-1, keepdim=True)
    return qz * acc_ind + (1.0 - acc_mass) * resid_z


class VerifyResult(NamedTuple):
    accepted: torch.Tensor      # (B, K) bool prefix acceptance
    n_accepted: torch.Tensor    # (B,) int64
    out_tokens: torch.Tensor    # (B, K+1) emitted tokens, zero-padded
    out_len: torch.Tensor       # (B,) emitted tokens, n_accepted + 1
    from_draft: torch.Tensor    # (B, K+1) bool token source
    u: torch.Tensor             # (B, K) the coins used


def verify_tokens(draft_tokens, p_probs, q_probs, u, resid_tokens,
                  bonus_tokens) -> VerifyResult:
    """Accept/reject K drafts per row: slot s is kept iff every earlier
    slot was and u_s < min(1, p_s/q_s).  draft_tokens (B, K); p_probs,
    q_probs (B, K) the target / draft probability of each draft; u (B, K)
    coins; resid_tokens (B, K) the residual token of each slot;
    bonus_tokens (B,) the token when all K are kept."""
    ok = u < torch.clamp_max(p_probs / torch.clamp_min(q_probs, EPS), 1.0)
    prefix = torch.cumprod(ok.to(torch.int64), dim=-1).bool()
    n_acc = prefix.sum(-1)
    B, K = draft_tokens.shape
    rows = torch.arange(B, device=draft_tokens.device)
    extra = torch.where(n_acc == K, bonus_tokens,
                        resid_tokens[rows, torch.clamp_max(n_acc, K - 1)])
    out = torch.zeros((B, K + 1), dtype=draft_tokens.dtype,
                      device=draft_tokens.device)
    out[:, :K] = torch.where(prefix, draft_tokens, 0)
    out[rows, n_acc] = extra.to(out.dtype)
    idx = torch.arange(K + 1, device=draft_tokens.device)
    return VerifyResult(accepted=prefix, n_accepted=n_acc, out_tokens=out,
                        out_len=n_acc + 1,
                        from_draft=idx[None, :] < n_acc[:, None], u=u)


def standard_acceptance_coins(generator: torch.Generator,
                              shape) -> torch.Tensor:
    """Fresh (not recoverable) uniforms on the generator's device:
    standard speculative sampling."""
    return torch.rand(shape, generator=generator, device=generator.device)


def pseudorandom_acceptance_coins(key, ctx_hashes) -> torch.Tensor:
    """Alg. 1 line 8: u = G(ζ^R) of each context hash (B, K)."""
    return prf.accept_uniform(key, ctx_hashes)
