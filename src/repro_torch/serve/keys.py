"""Multi-tenant watermark key management — the port of ``KeyPool`` and its
word derivation from ``repro.serve.keys``.

``KeyPool`` is a refcounted pool of 32-bit watermark *key words*.  Active
words are derived from a master key through the counter-PRF chain (no key
material is stored), tagged by **epoch** so ``rotate()`` retires the
current generation for *new* requests while in-flight requests keep their
word until released.  Every word has an 8-hex **fingerprint**, the only
identifier that leaves the serving process.  All of it is host-side
Python over ``prf._chain`` on ints, so the words equal the reference's.

``StrengthController`` maps a request's strength tier to the watermark
strength γ it serves at, from the scheme's linear-class trade-off curve
(``core.tradeoff``), computed once on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import prf

# chain stream tag for pool-derived words (disjoint from the sampling
# streams in core.prf)
STREAM_KEYPOOL = 0x4B


def _word_of(key) -> int:
    """Host-side 32-bit key word of an int, a numpy word or a 0-d tensor."""
    if isinstance(key, torch.Tensor):
        key = key.item()
    return int(key) & prf.MASK


def fingerprint_of(word: int) -> str:
    """8-hex fingerprint of a key word."""
    return format(int(word) & prf.MASK, "08x")


def derive_key_word(master, epoch: int, index: int) -> int:
    """The pool's word derivation: chain the master word with the pool
    stream, the epoch and the index through the counter PRF."""
    w = prf._chain(_word_of(master), STREAM_KEYPOOL)
    w = prf._chain(w, int(epoch))
    return int(prf._chain(w, int(index)))


class KeyPool:
    """Refcounted pool of watermark key words with epoch rotation.

    ``acquire()`` hands out the least-loaded *active* word (ties go to the
    lower index); ``acquire(key)`` pins an explicit per-request key
    instead (still refcounted).  ``rotate()`` advances the epoch: the next
    generation of derived words becomes active for new acquisitions, while
    outstanding words stay valid until their refcount drains.
    ``lookup(fingerprint)`` maps a fingerprint back to every word this pool
    has handed out."""

    def __init__(self, master, *, n_keys: int = 4, epoch: int = 0):
        if n_keys < 1:
            raise ValueError(f"n_keys must be >= 1, got {n_keys}")
        self.n_keys = int(n_keys)
        self.epoch = int(epoch)
        self._master = master
        self._refs: Dict[int, int] = {}          # word -> live refcount
        self._seen: Dict[str, int] = {}          # fingerprint -> word
        self._active: List[int] = []
        self._derive_active()

    def _derive_active(self) -> None:
        self._active = [derive_key_word(self._master, self.epoch, i)
                        for i in range(self.n_keys)]
        for w in self._active:
            self._seen.setdefault(fingerprint_of(w), w)

    def acquire(self, key=None) -> int:
        """Take a ref on a word: the least-loaded active word, or the
        explicit per-request ``key`` when given."""
        if key is not None:
            word = _word_of(key)
        else:
            _, _, word = min((self._refs.get(w, 0), i, w)
                             for i, w in enumerate(self._active))
        self._refs[word] = self._refs.get(word, 0) + 1
        self._seen.setdefault(fingerprint_of(word), word)
        return word

    def release(self, word) -> None:
        """Drop a ref; releasing a word with no ref raises (the refcount is
        the rotation drain witness, so it must stay exact)."""
        word = _word_of(word)
        n = self._refs.get(word, 0)
        if n <= 0:
            raise ValueError(f"release of unacquired key word "
                             f"{fingerprint_of(word)}")
        if n == 1:
            del self._refs[word]
        else:
            self._refs[word] = n - 1

    def rotate(self) -> int:
        """Advance the epoch and re-derive the active set; returns the new
        epoch.  In-flight words keep serving until released."""
        self.epoch += 1
        self._derive_active()
        return self.epoch

    @property
    def active_words(self) -> List[int]:
        return list(self._active)

    @property
    def live_words(self) -> List[int]:
        """Words with a nonzero refcount (current + pre-rotation)."""
        return sorted(self._refs)

    def refcount(self, word) -> int:
        return self._refs.get(_word_of(word), 0)

    def fingerprint(self, word: int) -> str:
        return fingerprint_of(word)

    def lookup(self, fp: str) -> Optional[int]:
        """Word behind a fingerprint this pool has handed out (None when
        the fingerprint was never seen)."""
        return self._seen.get(fp)

    def known_words(self) -> List[int]:
        """Every word ever active or acquired here."""
        return sorted(set(self._seen.values()))


# tier -> speculative-efficiency floor on the trade-off curve's x-axis:
# "latency" stays close to plain speculative sampling speed, "assurance"
# takes the maximal strength whatever the efficiency
DEFAULT_TIERS: Dict[str, float] = {
    "latency": 0.98,
    "balanced": 0.92,
    "assurance": 0.0,
}


@dataclasses.dataclass
class StrengthController:
    """Pick a request's watermark strength γ from its ``tier``: the
    largest γ on the serving scheme's linear-class trade-off curve
    (``tradeoff.linear_class_curve``, computed lazily once on ``device``)
    whose efficiency meets the tier's floor, or the most efficient γ when
    none does.  ``curve`` (a ``tradeoff.Curve`` or a zero-argument callable
    returning one) injects a precomputed curve.  ``decoder_name="none"``
    always gives 0."""

    decoder_name: str = "gumbel"
    tiers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_TIERS))
    curve: Optional[Callable] = None      # Curve or () -> Curve
    n_seeds: int = 20_000                 # Monte-Carlo budget of the curve
    n_gamma: int = 17
    device: str = "cuda"

    def __post_init__(self):
        self._curve = None
        self._cache: Dict[str, float] = {}

    def _get_curve(self):
        if self._curve is None:
            c = self.curve() if callable(self.curve) else self.curve
            if c is None:
                from repro_torch.core import tradeoff
                c = tradeoff.linear_class_curve(
                    self.decoder_name, n_seeds=self.n_seeds,
                    n_gamma=self.n_gamma, device=self.device)
            self._curve = c
        return self._curve

    def pick(self, tier: str) -> float:
        """γ for ``tier``; an unknown tier raises (a typo must not serve
        at the wrong strength)."""
        if tier not in self.tiers:
            raise ValueError(f"unknown strength tier {tier!r} — known: "
                             f"{sorted(self.tiers)}")
        if self.decoder_name == "none":
            return 0.0
        got = self._cache.get(tier)
        if got is not None:
            return got
        curve = self._get_curve()
        eff = np.asarray(curve.efficiency, np.float64)
        gammas = np.asarray(curve.gammas, np.float64)
        ok = eff >= float(self.tiers[tier])
        gamma = float(gammas[ok].max() if ok.any()
                      else gammas[int(np.argmax(eff))])
        self._cache[tier] = gamma
        return gamma
