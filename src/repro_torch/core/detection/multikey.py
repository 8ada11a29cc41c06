"""Multi-key watermark detection (multi-tenant serving) — the port of
``repro.core.detection.multikey``.

A key-pooled serving batch (``serve.keys.KeyPool``) emits texts under
different key words, so detection is a texts × keys sweep: every text is
scored against every candidate word and attributed to the word that
explains it.  A (text, key) cell whose key is the one the text was served
under takes its recorded statistics (``pipeline.records_from_generation``);
every other cell recovers them from (key, context, token).  Scalar
statistics (gumbel) score as the normalised Aaronson sum, g-bit vectors
(synthid) as the bit-frequency z; both are z-scores under their exact H0
law, so one threshold serves the whole matrix.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.detection.gumbel_detect import ars_score, select_tau
from repro_torch.core.detection.pipeline import records_from_generation
from repro_torch.core.detection.records import SeqRecord
from repro_torch.core.watermark.base import Decoder
from repro_torch.serve.keys import _word_of, fingerprint_of


def _as_generation_results(results) -> list:
    """``GenerationResult``s and scheduler ``RequestResult``s -> one batch-1
    ``GenerationResult`` per text."""
    out = []
    for r in results:
        gen = r.as_generation_result() if hasattr(
            r, "as_generation_result") else r
        if gen.tokens.shape[0] == 1:
            out.append(gen)
            continue
        for b in range(gen.tokens.shape[0]):

            def row(a):
                return None if a is None else a[b:b + 1]

            out.append(dataclasses.replace(
                gen, tokens=row(gen.tokens), lengths=row(gen.lengths),
                from_draft=row(gen.from_draft), u=row(gen.u),
                ctx_hashes=row(gen.ctx_hashes), masked=row(gen.masked),
                eos=row(gen.eos), y_draft=row(gen.y_draft),
                y_target=row(gen.y_target), keys=row(gen.keys),
                strength=row(gen.strength), state=None))
    return out


def record_score(rec: SeqRecord, *, tau: float = 0.5) -> float:
    """z-score of one (deduped, truncated) record with the Ars-τ selector:
    the normalised Aaronson sum for scalar statistics (H0: Gamma(n, 1)),
    the bit-frequency z for (n, m) g-bits (H0: Bernoulli(1/2) per bit)."""
    y = select_tau(rec, tau)
    if y.ndim == 1:
        return ars_score(y)
    n = max(y.size, 1)
    return float((y.sum() - 0.5 * n) / np.sqrt(0.25 * n))


@dataclasses.dataclass
class MultiKeyReport:
    """A texts × keys detection sweep."""
    scores: np.ndarray            # (n_texts, n_keys) z-scores
    key_words: List[int]          # candidate words, column order
    fingerprints: List[str]       # 8-hex per column
    served_hit: np.ndarray        # (n_texts, n_keys) the cell took the
    #                               served statistics
    best: np.ndarray              # (n_texts,) argmax column per text

    def attributions(self, threshold: float = 4.0) -> List[Optional[str]]:
        """Per text: the best key's fingerprint when its z clears
        ``threshold`` (≈ p < 3e-5 one-sided), else None."""
        return [self.fingerprints[int(b)]
                if self.scores[t, int(b)] >= threshold else None
                for t, b in enumerate(self.best)]


def score_texts_by_keys(results: Sequence, keys: Sequence, dec: Decoder,
                        vocab: int, *, tau: float = 0.5,
                        n_tokens: Optional[int] = None,
                        device="cuda") -> MultiKeyReport:
    """Score every text of ``results`` (``GenerationResult`` rows and / or
    ``RequestResult``s) under every candidate key word of ``keys``."""
    texts = _as_generation_results(results)
    words = [_word_of(k) for k in keys]
    scores = np.zeros((len(texts), len(words)), np.float64)
    hit = np.zeros((len(texts), len(words)), bool)
    for j, word in enumerate(words):
        for i, gen in enumerate(texts):
            rec = records_from_generation(gen, dec, word, vocab,
                                          n_tokens=n_tokens,
                                          device=device)[0]
            scores[i, j] = record_score(rec.dedupe(), tau=tau)
            hit[i, j] = gen.keys is not None and int(gen.keys[0]) == word
    return MultiKeyReport(
        scores=scores, key_words=words,
        fingerprints=[fingerprint_of(w) for w in words],
        served_hit=hit, best=np.argmax(scores, axis=1))
