"""SynthID watermark (Dathathri et al., 2024), Eqs. (3)-(4) of the paper —
the port of ``repro.core.watermark.synthid``.

m tournament rounds T_g(P)(w) = P_w·(1 + g_w − Σ_{g=1} P) with PRF g-bits
on counter w + V·l.  Finite m draws from the result with one more PRF
race (stream ``STREAM_PLAIN + stream``); the degenerate m->inf scheme
("synthid-inf") takes its argmax.  y_t is the token's m g-bits.  The
reference reduces at the 128-lane padded extent; the port reduces over V
exactly (the pad lanes add zeros), so only the order of a sum differs.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import prf
from repro_torch.core.watermark.base import (EPS, Decoder, FusedTail,
                                             race_argmax, register)
from repro_torch.kernels import ops, ref


def token_stat(seeds, tokens, vocab, *, m=30):
    """y = the m g-bits of each token: (..., m) f32."""
    layers = torch.arange(m, device=tokens.device)
    return prf.kernel_gbit(seeds[..., None], tokens[..., None] + vocab * layers)


def _normalise(probs):
    return probs / torch.clamp_min(probs.sum(-1, keepdim=True), EPS)


def sample(probs, key, ctx_hash, stream=prf.STREAM_DRAFT, *, m=30,
           degenerate=False):
    """One (V,) row -> (token, y (m,)), in plain torch."""
    V = probs.shape[-1]
    g_seed = prf.wm_seed(key, ctx_hash, stream)
    pz = ref.tournament_rounds(_normalise(probs.float())[None],
                               g_seed[None], m)
    if degenerate:
        tok = torch.argmax(pz[0])
    else:
        draw = prf.wm_seed(key, ctx_hash, prf.STREAM_PLAIN + stream)
        tok = ref.gumbel_argmax_ref(pz, draw[None])[0][0]
    return tok, token_stat(g_seed, tok, V, m=m)


def draft_sampler(probs, keys, ctx_hashes, seen, *, wm_stream: int,
                  plain_stream: int, m: int, degenerate: bool):
    """Batched SynthID sampling through the kernels: the keyed tournament
    of the normalised rows, then the draw race (or the tournament's argmax
    when degenerate); ``seen`` rows race the raw row with the plain
    seed."""
    pz, arg = ops.tournament_keyed(_normalise(probs), keys, ctx_hashes,
                                   stream=wm_stream, m=m)
    plain = prf.wm_seed(keys, ctx_hashes, plain_stream)
    if degenerate:
        return torch.where(seen, race_argmax(probs, plain), arg)
    draw = prf.wm_seed(keys, ctx_hashes, prf.STREAM_PLAIN + wm_stream)
    return race_argmax(torch.where(seen[:, None], probs, pz),
                       torch.where(seen, plain, draw))


def _make(m: int, degenerate: bool, name: str) -> Decoder:
    return Decoder(
        name=name,
        sample=partial(sample, m=m, degenerate=degenerate),
        stat_dim=m, degenerate=degenerate,
        token_stat=partial(token_stat, m=m),
        fused_tail=FusedTail(kind="tournament", m=m, stat_dim=m,
                             degenerate=degenerate),
        draft_sampler=partial(draft_sampler, m=m, degenerate=degenerate))


@register("synthid")
def make(m: int = 30, **kw) -> Decoder:
    return _make(m, False, f"synthid-m{m}")


@register("synthid-inf")
def make_inf(m: int = 30, **kw) -> Decoder:
    """m->inf limit (paper App. C.1): m rounds, then the argmax token."""
    return _make(m, True, "synthid-inf")
