"""Gumbel-max watermark (Aaronson 2023), Eq. (2) of the paper — the port
of ``repro.core.watermark.gumbel``.  The decoder selects
argmax_w log(U_w)/P_w with PRF uniforms U; y_t = U_{w_t}."""
from __future__ import annotations

import torch

from repro_torch.core import prf
from repro_torch.core.watermark.base import (EPS, Decoder, FusedTail,
                                             race_draft_sampler, register)


def sample(probs, key, ctx_hash, stream=prf.STREAM_DRAFT):
    """One (V,) row -> (token, U[token])."""
    u = prf.gumbel_uniforms(key, ctx_hash, stream, probs.shape[-1])
    p = torch.clamp_min(probs, 0.0)
    score = torch.where(p > 0, torch.log(u) / torch.clamp_min(p, EPS),
                        -torch.inf)
    tok = torch.argmax(score, dim=-1)
    return tok, u[tok]


def token_stat(seeds, tokens, vocab):
    """y = U_{w} of each token from its per-context seed: (..., 1) f32."""
    del vocab
    return prf.kernel_uniform(seeds, tokens)[..., None]


@register("gumbel")
def make(**kw) -> Decoder:
    return Decoder(name="gumbel", sample=sample, stat_dim=1,
                   degenerate=True, token_stat=token_stat,
                   fused_tail=FusedTail(kind="race", stat_dim=1,
                                        degenerate=True),
                   draft_sampler=race_draft_sampler)
