"""The port's paged KV path against the reference's, on numpy-made inputs.

- ``kernels.ref.paged_attention_ref`` (the plain version of the paged
  kernel, and what a CPU tensor takes through ``ops.paged_attention``)
  against ``repro.kernels.ref.paged_attention_ref`` (the reference's CPU
  serving path): GQA, Sq in {1, 4}, scalar and per-row pos, page sizes 1,
  8 and 12, hd 16 and 112, null tails and extra garbage pages, within
  1e-6 · hd / 16 in fp32 (the two frameworks sum the q·k dots, the softmax
  and the value product in other orders; a dot's rounding grows with hd).
- The same inputs against the reference's Pallas program
  (``paged_attention_kernel(..., interpret=True)``) within 1e-5: the
  Pallas body contracts q·k and p·v with its own dot order, and the
  reference's own bitwise test of that pair fails on some machines.
- ``layers.paged_cache_write``: pools bitwise equal outside the null page,
  including positions past the table (those land in page 0).
- The paged branch of ``Transformer.extend_step``, with the prompt fed in
  padded chunks: against the port's dense ``prefill`` + ``extend_step``
  (argmax tokens equal, logits within 1e-5: the paged and dense paths
  attend over other extents, and PyTorch's CPU softmax may round the last
  bit differently over another extent) and against the reference's paged
  ``extend_step`` logits within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JP
from repro.kernels import ref as JR
from repro.kernels.paged_attention import paged_attention_kernel
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as TL
from repro_torch.models.model import init_paged_cache

torch.set_num_threads(1)


def _port_cfg(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _paged(rng, *, B=3, n_pages=17, page_size=8, max_pages=4, Hkv=2, H=4,
           hd=16, Sq=3):
    """q, garbage-filled pools and a shuffled page table (disjoint pages,
    never page 0); row 1's tail points at the null page."""
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((n_pages, page_size, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, page_size, Hkv, hd)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages))[:B * max_pages]
    table = table.reshape(B, max_pages).astype(np.int64)
    table[1, -1] = 0
    return q, k, v, table


def _pos(kind):
    return np.int64(9) if kind == "scalar" else np.array([3, 11, 20],
                                                         np.int64)


def _port(q, k, v, table, pos):
    t = [torch.from_numpy(np.asarray(x)) for x in (q, k, v, table)]
    return t + [torch.as_tensor(pos)]


def _ref(q, k, v, table, pos):
    return (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(table, jnp.int32), jnp.asarray(pos, jnp.int32))


@pytest.mark.parametrize("hd", [16, 112])
@pytest.mark.parametrize("page_size", [1, 8, 12])
@pytest.mark.parametrize("Sq", [1, 4])
@pytest.mark.parametrize("pos_kind", ["scalar", "per-row"])
def test_paged_attention_ref_matches_reference(Sq, pos_kind, page_size, hd):
    """At every page size and head size the card's kernel takes (any page
    size, hd a multiple of 8), over an extent of about 32 positions."""
    max_pages = -(-32 // page_size)
    q, k, v, table = _paged(np.random.default_rng(Sq), Sq=Sq, hd=hd,
                            page_size=page_size, max_pages=max_pages,
                            n_pages=3 * max_pages + 2)
    pos = _pos(pos_kind)
    want = np.asarray(JR.paged_attention_ref(*_ref(q, k, v, table, pos)))
    got = TR.paged_attention_ref(*_port(q, k, v, table, pos))
    # 1e-6 at hd 16; the float32 rounding bound of a q·k dot (γ_hd) grows
    # linearly with hd, so a wider head gets hd / 16 times that
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * hd / 16)
    # a CPU tensor takes the plain version through the wrapper, uncounted
    ops.reset_launches()
    assert torch.equal(ops.paged_attention(*_port(q, k, v, table, pos)), got)
    assert torch.equal(TL.paged_decode_attention(
        *_port(q, k, v, table, pos)), got)
    assert ops.LAUNCHES["paged_attention"] == 0
    # extra garbage pages past every row's limit change nothing
    spare = table.size + 1            # pages no row's table holds
    wide = np.concatenate([table, np.array([[spare], [spare - 1], [0]])],
                          axis=1)
    assert torch.equal(TR.paged_attention_ref(*_port(q, k, v, wide, pos)),
                       got)


@pytest.mark.parametrize("Sq", [1, 4])
def test_paged_attention_ref_matches_pallas_interpret(Sq):
    q, k, v, table = _paged(np.random.default_rng(10 + Sq), Sq=Sq)
    pos = np.array([3, 11, 27], np.int64)
    want = np.asarray(paged_attention_kernel(*_ref(q, k, v, table, pos),
                                             interpret=True))
    got = TR.paged_attention_ref(*_port(q, k, v, table, pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos", [np.int64(6), np.array([2, 13], np.int64),
                                 np.array([23, 22], np.int64)],
                         ids=["scalar", "per-row", "past-table"])
def test_paged_cache_write_matches_reference(pos):
    rng = np.random.default_rng(3)
    _, k, _, table = _paged(rng, B=2, max_pages=3)
    kv = rng.standard_normal((2, 4, 2, 16)).astype(np.float32)
    want = np.asarray(JL.paged_cache_write(
        jnp.asarray(k), jnp.asarray(table, jnp.int32), jnp.asarray(kv),
        jnp.asarray(pos, jnp.int32)))
    pool = torch.from_numpy(k.copy())
    got = TL.paged_cache_write(pool, torch.from_numpy(table),
                               torch.from_numpy(kv), torch.as_tensor(pos))
    assert got is pool                       # written in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    # only the slots' own pages and the null page are written
    touched = np.flatnonzero((got.numpy() != k).any(axis=(1, 2, 3)))
    assert set(touched.tolist()) <= set(table.ravel().tolist()) | {0}


@pytest.fixture(scope="module")
def target():
    params = JM.init_params(jax.random.key(0), JP.TINY_TARGET)
    model = convert.from_jax_tree(jax.tree.map(np.asarray, params),
                                  _port_cfg(JP.TINY_TARGET), device="cpu")
    return params, model


@pytest.mark.parametrize("ck", [4, 3])
def test_paged_extend_step_matches_dense_and_reference(target, ck):
    params, model = target
    cfg = JP.TINY_TARGET
    rng = np.random.default_rng(4 + ck)
    S0, ps, max_pages = 7, 4, 8
    prompt = rng.integers(1, cfg.vocab, size=(1, S0))
    pages = np.array([3, 9, 5, 7, 12, 2], np.int64)

    # the port: dense prefill against the paged branch fed in chunks
    dense_logits, dense = model.prefill(torch.as_tensor(prompt), 32)
    paged = init_paged_cache(model, 1, 16, ps, max_pages)
    paged["page_table"][0, :len(pages)] = torch.from_numpy(pages)
    jcache = JM.init_paged_cache(cfg, 1, num_pages=16, page_size=ps,
                                 max_pages=max_pages)
    jcache = dict(jcache, page_table=jcache["page_table"].at[
        0, :len(pages)].set(jnp.asarray(pages, jnp.int32)))
    for i in range(-(-S0 // ck)):
        chunk = np.zeros((1, ck), np.int64)
        chunk[0, :min(ck, S0 - i * ck)] = prompt[0, i * ck:(i + 1) * ck]
        logits, paged = model.extend_step(torch.as_tensor(chunk), paged)
        jlogits, jcache = JT.extend_step(params, cfg,
                                         jnp.asarray(chunk, jnp.int32),
                                         jcache)
        new_pos = min((i + 1) * ck, S0)
        paged = dict(paged, pos=torch.full((1,), new_pos))
        jcache = dict(jcache, pos=jnp.full((1,), new_pos, jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-5)
    last = logits[:, (S0 - 1) % ck]
    np.testing.assert_allclose(last.numpy(), dense_logits[:, -1].numpy(),
                               rtol=0, atol=1e-5)
    assert torch.equal(last.argmax(-1), dense_logits[:, -1].argmax(-1))

    # a decode continuation, then a pos-only rollback
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, size=(1, 3)))
    for rollback in (S0, S0 + 1):
        dense = dict(dense, pos=torch.full((1,), rollback))
        paged = dict(paged, pos=torch.full((1,), rollback))
        jcache = dict(jcache, pos=jnp.full((1,), rollback, jnp.int32))
        ld, dense = model.extend_step(toks, dense)
        lp, paged = model.extend_step(toks, paged)
        lj, jcache = JT.extend_step(params, cfg,
                                    jnp.asarray(toks.numpy(), jnp.int32),
                                    jcache)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), rtol=0, atol=1e-5)
        assert torch.equal(lp.argmax(-1), ld.argmax(-1))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=0,
                                   atol=1e-5)
