"""From generation output (or arbitrary text) to detection records — the
port of ``repro.core.detection.pipeline``.

At detection time there are only tokens and the watermark key: context
hashes, the candidate statistics y^D / y^T and the acceptance coins
u = G(ζ^R) are recovered through the counter PRF (on ``device``).  The
``src`` ground truth comes only from the engine (oracle and MLP
training).  ``records_from_generation`` takes the statistics the engine
recorded as it generated (``GenerationResult.y_draft`` / ``y_target``,
equal to the recovered ones) when they were recorded under the same
decoder and, per row, the same key word; ``null_records`` always
recovers.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import prf
from repro_torch.core.detection.records import SeqRecord
from repro_torch.core.watermark.base import Decoder
from repro_torch.serve.engine import GenerationResult
from repro_torch.serve.keys import _word_of


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


def recover_u(key, ctx_hashes: np.ndarray, device="cuda") -> np.ndarray:
    """The acceptance coins u = G(ζ^R) of each context hash."""
    return prf.accept_uniform(key, _t(ctx_hashes, device)).cpu().numpy()


def _stats(dec: Decoder, tokens, key, hashes, stream, vocab, device):
    return dec.recover_stats(_t(tokens, device), key, _t(hashes, device),
                             stream, vocab).cpu().numpy()


def _squeeze_stat(y: np.ndarray, dec: Decoder) -> np.ndarray:
    """Served stats are (n, stat_dim): flat (n,) for a scalar-stat scheme
    (gumbel), (n, stat_dim) otherwise (synthid, even at m == 1)."""
    return y[..., 0] if dec.flat_stat else y


def records_from_generation(res: GenerationResult, dec: Decoder, key,
                            vocab: int, *, n_tokens: Optional[int] = None,
                            watermarked: bool = True, use_served: bool = True,
                            device="cuda") -> List[SeqRecord]:
    """One SeqRecord per sequence, truncated to ``n_tokens``; served
    statistics are taken as they are when they were recorded under
    ``dec`` and the row's key word is ``key``'s (a wrong-key run, e.g. a
    false-positive calibration, recovers them instead)."""
    out: List[SeqRecord] = []
    scheme_ok = (use_served and res.y_draft is not None
                 and res.stat_scheme == dec.name
                 and res.y_draft.shape[-1] == dec.stat_dim
                 and res.keys is not None)
    word = _word_of(key)
    for b in range(res.tokens.shape[0]):
        n = int(res.lengths[b])
        if n_tokens is not None:
            n = min(n, n_tokens)
        toks = res.tokens[b, :n]
        hashes = res.ctx_hashes[b, :n]
        if scheme_ok and int(res.keys[b]) == word:
            y_d = _squeeze_stat(np.asarray(res.y_draft[b, :n]), dec)
            y_t = _squeeze_stat(np.asarray(res.y_target[b, :n]), dec)
        else:
            y_d = _stats(dec, toks, key, hashes, prf.STREAM_DRAFT, vocab,
                         device)
            y_t = _stats(dec, toks, key, hashes, prf.STREAM_TARGET, vocab,
                         device)
        out.append(SeqRecord(
            tokens=toks, y_draft=y_d, y_target=y_t,
            u=recover_u(key, hashes, device),
            src=res.from_draft[b, :n].astype(np.int8),
            watermarked=watermarked,
            accept_ratio=float(np.mean(res.from_draft[b, :n] == 1)),
            ctx=hashes.astype(np.uint32)))
    return out


def null_records(tokens: np.ndarray, dec: Decoder, key, vocab: int, *,
                 ctx_window: int = 4, device="cuda") -> List[SeqRecord]:
    """Records of unwatermarked text (H0): tokens (B, N) from any source,
    everything recovered as for suspect text; ``src`` all zeros."""
    hashes = prf.sliding_context_hashes(_t(tokens, device),
                                        ctx_window).cpu().numpy()
    out: List[SeqRecord] = []
    for b in range(tokens.shape[0]):
        y_d = _stats(dec, tokens[b], key, hashes[b], prf.STREAM_DRAFT, vocab,
                     device)
        y_t = _stats(dec, tokens[b], key, hashes[b], prf.STREAM_TARGET,
                     vocab, device)
        out.append(SeqRecord(
            tokens=np.asarray(tokens[b]), y_draft=y_d, y_target=y_t,
            u=recover_u(key, hashes[b], device),
            src=np.zeros(tokens.shape[1], np.int8), watermarked=False,
            accept_ratio=0.0, ctx=hashes[b].astype(np.uint32)))
    return out
