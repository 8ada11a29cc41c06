"""The port's generate against the reference's for resume through
``state=``, ``eos_id``, a per-slot ``n_tokens`` vector and ``sync_every``,
per-row keys and strengths, and for ``accept="standard"``, whose coins come from torch.Generators and
cannot reproduce jax.random: that mode is held by its acceptance rate.
Parity is judged as in test_torch_engine.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JP
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import divergence
from repro_torch.serve import engine as TE

# the suite runs several pytest workers on a few cores: one torch thread
# per worker keeps torch's spinning thread pool from starving JAX's
torch.set_num_threads(1)

MARGIN = 1e-5
KEY = 77
FIELDS = ("tokens", "u", "ctx_hashes", "masked", "from_draft", "y_draft",
          "y_target")


def _port_cfg(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def pair():
    tp = JM.init_params(jax.random.key(0), JP.TINY_TARGET)
    dp = JM.init_params(jax.random.key(1), JP.TINY_DRAFT)
    tm = convert.from_jax_tree(jax.tree.map(np.asarray, tp),
                               _port_cfg(JP.TINY_TARGET), device="cpu")
    dm = convert.from_jax_tree(jax.tree.map(np.asarray, dp),
                               _port_cfg(JP.TINY_DRAFT), device="cpu")
    prompts = np.random.default_rng(3).integers(
        1, JP.TINY_TARGET.vocab, size=(3, 8)).astype(np.int32)
    return tp, dp, tm, dm, prompts


def _parity(rj, rt, models, scfg, prompts):
    parted = 0
    for b in range(prompts.shape[0]):
        j = divergence.first_divergence(rj, rt, b)
        n = int(rj.lengths[b]) if j is None else j
        if j is not None:
            assert divergence.decision_margin(*models, scfg, prompts[b], rt,
                                              b, j) < MARGIN
            parted += 1
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(rj, name))[b, :n],
                np.asarray(getattr(rt, name))[b, :n], err_msg=f"{b} {name}")
    if parted == 0:
        np.testing.assert_array_equal(rj.lengths, rt.lengths)
        np.testing.assert_array_equal(rj.eos, rt.eos)
        assert rj.n_steps == rt.n_steps and rj.aatps == rt.aatps
    assert parted <= 1


def test_resume_matches_reference_and_long_run(pair):
    tp, dp, tm, dm, prompts = pair
    kw = dict(K=3, watermark="gumbel", temperature=0.9)
    sj, st = JE.SpecConfig(**kw), TE.SpecConfig(**kw)
    j1 = JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                     jnp.asarray(prompts), n_tokens=10, key=KEY)
    j2 = JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                     jnp.asarray(prompts), n_tokens=10, key=KEY,
                     state=j1.state)
    t1 = TE.generate(tm, dm, st, prompts, n_tokens=10, key=KEY)
    _parity(j1, t1, (tm, dm), st, prompts)
    t2 = TE.generate(tm, dm, st, prompts, n_tokens=10, key=KEY,
                     state=t1.state)
    _parity(j2, t2, (tm, dm), st, prompts)
    # chained == one long call, inside the port
    tl = TE.generate(tm, dm, st, prompts, n_tokens=19, key=KEY)
    for b in range(prompts.shape[0]):
        m1, m2 = int(t1.lengths[b]), int(t2.lengths[b])
        for name in ("tokens", "u", "ctx_hashes", "from_draft", "masked"):
            chained = np.concatenate([getattr(t1, name)[b, :m1],
                                      getattr(t2, name)[b, 1:m2]])
            n = min(len(chained), int(tl.lengths[b]))
            np.testing.assert_array_equal(chained[:n],
                                          getattr(tl, name)[b, :n])


def test_eos_vector_targets_and_sync_every(pair):
    tp, dp, tm, dm, prompts = pair
    kw = dict(K=4, watermark="synthid", m=8)
    sj, st = JE.SpecConfig(**kw), TE.SpecConfig(**kw)
    probe = TE.generate(tm, dm, st, prompts, n_tokens=12, key=KEY)
    eos = int(probe.tokens[1, 5])          # a token row 1 emits mid-run
    n_vec = [6, 20, 13]
    rj = JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                     jnp.asarray(prompts), n_tokens=n_vec, key=KEY,
                     eos_id=eos)
    rt = TE.generate(tm, dm, st, prompts, n_tokens=n_vec, key=KEY,
                     eos_id=eos, sync_every=2)
    _parity(rj, rt, (tm, dm), st, prompts)
    assert rt.eos[1]
    assert rt.tokens[1, int(rt.lengths[1]) - 1] == eos
    assert rt.lengths[0] >= 6


def test_standard_acceptance_rate_matches_reference(pair):
    """Fresh coins: the acceptance rate over a few keys agrees with the
    reference's to within the sampling noise of these runs."""
    tp, dp, tm, dm, prompts = pair
    kw = dict(K=3, watermark="none", accept="standard")
    sj, st = JE.SpecConfig(**kw), TE.SpecConfig(**kw)
    aj, at = [], []
    for key in (1, 2, 3):
        aj.append(JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                              jnp.asarray(prompts), n_tokens=24,
                              key=key).aatps)
        rt = TE.generate(tm, dm, st, prompts, n_tokens=24, key=key)
        assert 0.0 <= rt.aatps <= 3.0
        at.append(rt.aatps)
    again = TE.generate(tm, dm, st, prompts, n_tokens=24, key=3)
    assert again.aatps == at[-1]                # seeded, so repeatable
    assert abs(np.mean(aj) - np.mean(at)) < 0.3, (aj, at)


def test_mixed_keys_and_repeated_contexts(pair):
    """A per-row key batch with per-row strength (gated positions take the
    masked / plain-stream path) and a degenerate prompt match the
    reference."""
    tp, dp, tm, dm, _ = pair
    prompts = np.full((3, 8), 5, np.int32)
    keys = np.array([1, 2**32 - 1, 0xDEADBEEF], np.uint32)
    strength = np.array([1.0, 0.5, 0.0], np.float32)
    kw = dict(K=2, watermark="synthid", m=8, temperature=0.3)
    sj, st = JE.SpecConfig(**kw), TE.SpecConfig(**kw)
    rj = JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                     jnp.asarray(prompts), n_tokens=24,
                     key=jnp.asarray(keys), strength=jnp.asarray(strength))
    rt = TE.generate(tm, dm, st, prompts, n_tokens=24, key=keys,
                     strength=strength)
    assert rt.masked.any()
    _parity(rj, rt, (tm, dm), st, prompts)
