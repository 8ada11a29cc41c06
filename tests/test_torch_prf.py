"""The port's PRF (repro_torch.core.prf) against the reference's
(repro.core.prf): bit-exact on random words, words next to 2^32, every
stream, context windows and counters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prf as J
from repro_torch.core import prf as T

# the suite runs several pytest workers on a few cores: one torch thread
# per worker keeps torch's spinning thread pool from starving JAX's
torch.set_num_threads(1)

STREAMS = [J.STREAM_DRAFT, J.STREAM_TARGET, J.STREAM_ACCEPT, J.STREAM_PLAIN,
           J.STREAM_GAMMA, J.STREAM_PLAIN + 2, J.STREAM_PLAIN + 3,
           J.STREAM_PLAIN + J.STREAM_TARGET + 13]


def _words(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1,
                     0x9E3779B9, 0xFFFF0000], np.uint32)
    return np.concatenate([edge, w])


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        np.testing.assert_array_equal(j, t)
    else:
        np.testing.assert_array_equal(j.astype(np.int64), t)


def test_stream_constants_match():
    for name in ("STREAM_DRAFT", "STREAM_TARGET", "STREAM_ACCEPT",
                 "STREAM_PLAIN", "STREAM_GAMMA"):
        assert getattr(J, name) == getattr(T, name)


@pytest.mark.parametrize("fn", ["hash_u32", "chain", "kernel_uniform",
                                "kernel_gbit"])
def test_word_functions_bit_exact(fn):
    a, b = _words(4096, 1), _words(4096, 2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = T.words(a), T.words(b)
    if fn == "hash_u32":
        _same(J.hash_u32(ja), T.hash_u32(ta))
    elif fn == "chain":
        _same(J._chain(ja, jb), T._chain(ta, tb))
    else:
        _same(getattr(J, fn)(ja, jb), getattr(T, fn)(ta, tb))


@pytest.mark.parametrize("stream", STREAMS)
def test_seeds_and_uniforms_per_stream(stream):
    keys, ctx = _words(512, 3), _words(512, 4)
    jk, jc = jnp.asarray(keys), jnp.asarray(ctx)
    tk, tc = T.words(keys), T.words(ctx)
    _same(J.wm_seed(jk, jc, stream), T.wm_seed(tk, tc, stream))
    _same(J.uniform_from(jk, jc, stream), T.uniform_from(tk, tc, stream))
    # a (B, 1) key column broadcast against (B, K) contexts, as the engine
    # derives its per-slot seeds
    c2 = ctx[:510].reshape(102, 5)
    _same(J.wm_seed(jk[:102, None], jnp.asarray(c2), stream),
          T.wm_seed(tk[:102, None], T.words(c2), stream))


def test_accept_uniform_and_counters():
    keys, ctx = _words(1024, 5), _words(1024, 6)
    _same(J.accept_uniform(jnp.asarray(keys), jnp.asarray(ctx)),
          T.accept_uniform(T.words(keys), T.words(ctx)))
    # counters past 2^24 (w + V·l at V=256128, l < 30)
    seed = int(_words(1, 7)[-1])
    ctr = np.arange(7_000_000, 7_004_096, dtype=np.uint32)
    _same(J.kernel_gbit(jnp.uint32(seed), jnp.asarray(ctr)),
          T.kernel_gbit(T.words(seed), T.words(ctr)))
    _same(J.gumbel_uniforms(jnp.uint32(seed), jnp.uint32(77), 0x7A, 300),
          T.gumbel_uniforms(T.words(seed), T.words(77), 0x7A, 300))


@pytest.mark.parametrize("c", [1, 2, 4, 6])
def test_context_hash_windows(c):
    rng = np.random.default_rng(c)
    toks = rng.integers(0, 256128, size=(64, c)).astype(np.int32)
    toks[0] = 0
    toks[1] = 256127
    _same(J.context_hash(jnp.asarray(toks)),
          T.context_hash(torch.as_tensor(toks)))


@pytest.mark.parametrize("key", [0, 1, 1234, 2**31, 2**32 - 1, 2**32, -5,
                                 2**40 + 3])
def test_key_words(key):
    assert int(J.as_key_word(key)) == int(T.as_key_word(key))
    row = T.as_key_words(key, 3)
    assert row.shape == (3,) and row.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(J.as_key_words(key, 3)),
                                  row.numpy())


def test_key_word_rows():
    keys = _words(6, 8)
    np.testing.assert_array_equal(
        np.asarray(J.as_key_words(jnp.asarray(keys), 14)).astype(np.int64),
        T.as_key_words(keys, 14).numpy())
    with pytest.raises(ValueError):
        T.as_key_words(keys, 5)
