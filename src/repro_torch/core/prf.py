"""Keyed pseudorandom substrate — the port of ``repro.core.prf``.

A key is one 32-bit *key word*; the (key, stream, context) -> seed map is
a two-link chain of the integer hash (``_chain``), and uniforms / g-bits
come from the counter PRF ``hash(seed·MIX ^ hash(counter))``.  The CUDA
kernels (``kernels/csrc/prf.cuh``) run the same program on ``uint32_t``.

Words are int64 tensors holding values in [0, 2^32): PyTorch's CPU
backend has no ``>>`` or ``+`` on ``torch.uint32``.  Every product is
split into 16-bit halves of the constant so no int64 product overflows,
and every result is masked back to 32 bits, so the words are bit-exact
with the reference's uint32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

# stream ids
STREAM_DRAFT = 0xD0
STREAM_TARGET = 0x7A
STREAM_ACCEPT = 0x5E
STREAM_PLAIN = 0x99   # non-watermark randomness
STREAM_GAMMA = 0x6A   # strength-gate coins

MASK = 0xFFFFFFFF
_MIX = 0x9E3779B9


def words(x, device=None):
    """A python int stays a python int, masked to 32 bits (so a constant
    stream id never becomes a host-to-device copy); a numpy array or
    tensor becomes an int64 word tensor in [0, 2^32)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & MASK
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
        return t.to(torch.int64) & MASK
    arr = np.asarray(x).astype(np.int64) & MASK
    return torch.as_tensor(arr, device=device)


def _mul(x, c: int):
    """(x · c) mod 2^32 for words x and a 32-bit constant c, without any
    int64 product leaving the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def hash_u32(x):
    """murmur3-style finalizer over 32-bit words (tensor or python int)."""
    x = words(x)
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _chain(seed, counter):
    """One link of the seed chain: absorb ``counter`` into ``seed``
    (elementwise, broadcasting).  The same mixing step makes the counter
    PRF's uniforms and g-bits."""
    return hash_u32(_mul(words(seed), _MIX) ^ hash_u32(words(counter)))


def kernel_uniform(seed, counter) -> torch.Tensor:
    """U(0,1) from (seed, counter): 24 hash bits times 2^-24 plus 2^-25,
    exact in float32."""
    bits = torch.as_tensor(_chain(seed, counter))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) \
        + (1.0 / (1 << 25))


def kernel_gbit(seed, counter) -> torch.Tensor:
    """{0,1} bit (as float32) from (seed, counter)."""
    return (torch.as_tensor(_chain(seed, counter)) >> 31).to(torch.float32)


def context_hash(window_tokens: torch.Tensor) -> torch.Tensor:
    """Order-dependent hash of the last-c-token window: (..., c) -> (...)."""
    toks = words(window_tokens)
    h = torch.full(toks.shape[:-1], 2166136261, dtype=torch.int64,
                   device=toks.device)
    for i in range(toks.shape[-1]):
        t = toks[..., i]
        h = h ^ ((t + _MIX + ((h << 6) & MASK) + (h >> 2)) & MASK)
        h = _mul(h, 16777619)
    return h


def sliding_context_hashes(tokens, c: int) -> torch.Tensor:
    """Per-position context hashes of whole sequences: tokens (..., S) ->
    (..., S) words; position t hashes tokens[t-c:t], left-padded with
    token 0."""
    toks = torch.as_tensor(tokens)
    S = toks.shape[-1]
    padded = torch.nn.functional.pad(toks, (c, 0))
    return context_hash(torch.stack([padded[..., i:i + S] for i in range(c)],
                                    dim=-1))


def as_key_word(key, device=None) -> torch.Tensor:
    """A python int, or word array/tensor, -> int64 key word tensor(s)."""
    w = words(key, device=device)
    return torch.tensor(w, device=device) if isinstance(w, int) else w


def as_key_words(key, batch: int, device=None) -> torch.Tensor:
    """Normalize ``key`` (scalar or (batch,)) to a (batch,) key-word row."""
    w = as_key_word(key, device=device)
    if w.ndim == 0:
        w = w.expand(batch).clone()
    if tuple(w.shape) != (batch,):
        raise ValueError(f"key words shape {tuple(w.shape)} != ({batch},)")
    return w


def wm_seed(key, ctx_hash, stream):
    """Seed of (key, stream, context): chain the stream, then the context."""
    return _chain(_chain(key, stream), ctx_hash)


def uniform_from(key, ctx_hash, stream) -> torch.Tensor:
    """U(0,1) of stream ``stream`` at context ``ctx_hash`` (the context
    hash is the counter)."""
    return kernel_uniform(_chain(key, stream), ctx_hash)


def gumbel_uniforms(key, ctx_hash, stream: int, vocab: int) -> torch.Tensor:
    """The (U_w) vector of the Gumbel-max watermark for one context."""
    seed = wm_seed(key, ctx_hash, stream)
    return kernel_uniform(seed, torch.arange(
        vocab, device=getattr(seed, "device", None)))


def synthid_gbits(key, ctx_hash, stream: int, m: int,
                  vocab: int) -> torch.Tensor:
    """The m g-vectors of SynthID for one context: (m, vocab) in {0, 1},
    g_l(w) = gbit(seed, w + vocab·l)."""
    seed = wm_seed(key, ctx_hash, stream)
    dev = getattr(seed, "device", None)
    w = torch.arange(vocab, device=dev)
    layers = torch.arange(m, device=dev)[:, None]
    return kernel_gbit(seed, w[None, :] + vocab * layers)


def accept_uniform(key, ctx_hash) -> torch.Tensor:
    """The ζ^R acceptance coin of Alg. 1."""
    return uniform_from(key, ctx_hash, STREAM_ACCEPT)
