"""Where two runs of ``generate`` that should agree part ways, and why.

Two runs of the same request on other hardware or in another framework
(the reference on the CPU, the port on the CPU, the port on the card)
compute their probabilities with float sums in other orders.  Their
tokens may then part only at a decision that was a near-tie: a Gumbel
race (or a tournament argmax) whose best two scores differ by less than
the rounding, or an acceptance coin that fell next to min(1, p/q).
``first_divergence`` finds the first position where two results differ,
and ``decision_margin`` recomputes, in plain PyTorch, the relative margin
of every decision that could have produced the token at that position.
A test accepts a divergence only when that margin is under its
tolerance, and counts it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import prf
from repro_torch.kernels import ref
from repro_torch.serve.engine import SpecConfig, make_decoder


def first_divergence(a, b, row: int) -> Optional[int]:
    """First position of ``row`` at which two GenerationResults differ in
    token, provenance or masked flag (None when they agree)."""
    n = int(min(a.lengths[row], b.lengths[row]))
    diff = ((a.tokens[row, :n] != b.tokens[row, :n])
            | (a.from_draft[row, :n] != b.from_draft[row, :n])
            | (a.masked[row, :n] != b.masked[row, :n]))
    if diff.any():
        return int(np.argmax(diff))
    return None if a.lengths[row] == b.lengths[row] else n


def _sampler_scores(dec, probs, key, ctx, seen: bool, wm_stream: int,
                    plain_stream: int):
    """Scores (1, V) whose argmax is the sampler's token for one row."""
    probs = probs[None]
    if seen or dec.fused_tail.kind == "race":
        stream = plain_stream if seen else wm_stream
        return ref.race_scores(probs, prf.wm_seed(key, ctx, stream)[None])[0]
    tail = dec.fused_tail
    pn = probs / torch.clamp_min(probs.sum(-1, keepdim=True), ref.EPS)
    pz = ref.tournament_rounds(pn, prf.wm_seed(key, ctx, wm_stream)[None],
                               tail.m)
    if tail.degenerate:
        return pz
    draw = prf.wm_seed(key, ctx, prf.STREAM_PLAIN + wm_stream)
    return ref.race_scores(pz, draw[None])[0]


@torch.no_grad()
def decision_margin(t_model, d_model, scfg: SpecConfig, prompt, res,
                    row: int, j: int) -> float:
    """Smallest relative margin among the decisions that produce token j
    of ``row`` in result ``res`` (pseudorandom acceptance), recomputed on
    the models' device from the common prefix prompt + tokens[:j]."""
    dec = make_decoder(scfg)
    dev = t_model.embed.device
    prefix = torch.as_tensor(
        np.concatenate([np.asarray(prompt), res.tokens[row, :j]]),
        dtype=torch.int64, device=dev)[None]
    key = torch.tensor(int(res.keys[row]), device=dev)
    ctx = torch.tensor(int(res.ctx_hashes[row, j]), device=dev)
    seen = bool(res.masked[row, j])
    temp = scfg.temperature

    def dist(model):
        logits, _ = model.prefill(prefix, prefix.shape[1])
        return torch.softmax(logits[0, -1].float() / temp, -1)

    p = dist(t_model)
    if j == 0:
        return float(ref.margin(_sampler_scores(
            dec, p, key, ctx, seen, dec.target_stream,
            prf.STREAM_PLAIN + 3))[0])
    q = dist(d_model)
    draft_scores = _sampler_scores(dec, q, key, ctx, seen, dec.draft_stream,
                                   prf.STREAM_PLAIN + 1)
    d = int(torch.argmax(draft_scores[0]))
    a = min(1.0, float(p[d]) / max(float(q[d]), ref.EPS))
    u = float(prf.accept_uniform(key, ctx))
    margins = [float(ref.margin(draft_scores)[0]), abs(u - a) / max(a, 1e-30)]
    for probs, plain in ((torch.clamp_min(p - q, 0.0), 2), (p, 3)):
        margins.append(float(ref.margin(_sampler_scores(
            dec, probs, key, ctx, seen, dec.target_stream,
            prf.STREAM_PLAIN + plain))[0]))
    # an all-zero row (nan margin) has no near-tie to flip
    return min(x for x in margins if x == x)
