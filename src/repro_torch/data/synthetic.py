"""Deterministic synthetic text corpus + byte tokenizer — a copy of
``repro.data.synthetic`` (numpy only), kept here so the port imports
nothing of the JAX package; the same seeds give the same tokens.

The container is offline, so the paper's ELI5/C4 datasets are replaced by a
synthetic "language" with learnable structure: a fixed word inventory,
Zipf-distributed unigrams and a bigram coupling matrix, rendered to bytes.
Draft and target models trained on this corpus acquire aligned (but not
identical) conditional distributions — exactly the regime speculative
sampling needs.  Everything is seeded and reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

VOCAB = 256   # byte-level
BOS = 1
EOS = 2
PAD = 0


@dataclasses.dataclass
class CorpusConfig:
    n_words: int = 180
    word_len: Tuple[int, int] = (2, 7)
    zipf_a: float = 1.3
    bigram_temp: float = 1.2
    seed: int = 1234


class SyntheticCorpus:
    def __init__(self, cfg: CorpusConfig = CorpusConfig()):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        letters = np.arange(ord("a"), ord("z") + 1)
        self.words: List[bytes] = []
        seen = set()
        while len(self.words) < cfg.n_words:
            ln = rng.integers(cfg.word_len[0], cfg.word_len[1] + 1)
            w = bytes(rng.choice(letters, ln).astype(np.uint8))
            if w not in seen:
                seen.add(w)
                self.words.append(w)
        # zipf unigram over words
        ranks = np.arange(1, cfg.n_words + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # bigram coupling: random logits + unigram prior
        g = rng.normal(size=(cfg.n_words, cfg.n_words)) / cfg.bigram_temp
        logits = g + np.log(self.unigram)[None, :]
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.bigram = e / e.sum(axis=1, keepdims=True)

    def sample_doc(self, rng: np.random.Generator, n_words: int = 60) -> bytes:
        w = rng.choice(self.cfg.n_words, p=self.unigram)
        out = [self.words[w]]
        for _ in range(n_words - 1):
            w = rng.choice(self.cfg.n_words, p=self.bigram[w])
            out.append(self.words[w])
        return b" ".join(out)

    def documents(self, n_docs: int, seed: int = 0) -> List[bytes]:
        rng = np.random.default_rng(self.cfg.seed * 7919 + seed)
        return [self.sample_doc(rng) for _ in range(n_docs)]


def encode(text: bytes) -> np.ndarray:
    return np.frombuffer(text, dtype=np.uint8).astype(np.int32)


def decode_bytes(tokens: np.ndarray) -> bytes:
    return bytes(int(t) for t in tokens if t > 2)


def token_stream(corpus: SyntheticCorpus, n_docs: int, seed: int = 0
                 ) -> np.ndarray:
    """Flat token stream with BOS separators."""
    parts = []
    for doc in corpus.documents(n_docs, seed):
        parts.append(np.array([BOS], np.int32))
        parts.append(encode(doc))
    return np.concatenate(parts)


def batches(stream: np.ndarray, batch: int, seq: int, *, seed: int = 0
            ) -> Iterator[dict]:
    """Infinite iterator of {"tokens": (B,S+1)} windows for LM training
    (inputs = [:, :-1], labels = [:, 1:])."""
    rng = np.random.default_rng(seed)
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([stream[s:s + seq + 1] for s in starts])
        yield {"tokens": toks}


def prompts(corpus: SyntheticCorpus, n: int, prompt_words: int = 8,
            seed: int = 99) -> List[np.ndarray]:
    """Generation prompts (question-like prefixes) for the serving engine."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        doc = corpus.sample_doc(rng, prompt_words)
        out.append(np.concatenate([[BOS], encode(doc), [ord(" ")]]))
    return out
