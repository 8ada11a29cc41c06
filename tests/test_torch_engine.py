"""The port's serving path (repro_torch.serve.engine.generate) against the
reference's generate on the TINY pair, with JAX-initialised weights
carried across by repro_torch.convert: tokens, coins, context hashes,
masked flags, provenance, served statistics and AATPS are equal for
gumbel, synthid, synthid-inf and none.  The two frameworks round their
float sums differently, so a row may part at a near-tie; it is accepted
only when repro_torch.serve.divergence shows the decision's margin under
1e-5 at the first divergent position, and compared up to there."""
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
KEY = 1234
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
    prompts = np.random.default_rng(2).integers(
        1, JP.TINY_TARGET.vocab, size=(3, 8)).astype(np.int32)
    return tp, dp, tm, dm, prompts


def _configs(**kw):
    return JE.SpecConfig(**kw), TE.SpecConfig(**kw)


def assert_parity(rj, rt, models, scfg, prompts):
    """Equal results, or rows that part only at a counted near-tie."""
    parted = 0
    for b in range(prompts.shape[0]):
        j = divergence.first_divergence(rj, rt, b)
        n = int(rj.lengths[b]) if j is None else j
        if j is not None:
            marg = divergence.decision_margin(*models, scfg, prompts[b], rt,
                                              b, j)
            assert marg < MARGIN, (b, j, marg)
            parted += 1
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(rj, name))[b, :n],
                np.asarray(getattr(rt, name))[b, :n], err_msg=f"{b} {name}")
    if parted == 0:
        np.testing.assert_array_equal(rj.lengths, rt.lengths)
        assert rj.n_steps == rt.n_steps
        assert rj.aatps == rt.aatps
        assert rj.tokens_per_step == rt.tokens_per_step
    return parted


@pytest.mark.parametrize("wm", ["gumbel", "synthid", "synthid-inf", "none"])
def test_generate_matches_reference(pair, wm):
    tp, dp, tm, dm, prompts = pair
    sj, st = _configs(K=3, watermark=wm, m=30, temperature=0.8)
    rj = JE.generate(tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj,
                     jnp.asarray(prompts), n_tokens=20, key=KEY)
    rt = TE.generate(tm, dm, st, prompts, n_tokens=20, key=KEY)
    assert rt.stat_scheme == rj.stat_scheme
    np.testing.assert_array_equal(rt.keys, rj.keys)
    assert assert_parity(rj, rt, (tm, dm), st, prompts) <= 1
    assert rt.n_syncs == rt.n_steps + 1 or rt.n_syncs == rt.n_steps


@pytest.mark.parametrize("wm", ["gumbel", "synthid", "synthid-inf", "none"])
def test_fused_off_tail_matches_fused(pair, wm):
    """The decoder-generic tail (fused="off") samples the same tokens as
    the fused verification tail, as in the reference."""
    _, _, tm, dm, prompts = pair
    st = TE.SpecConfig(K=4, watermark=wm, m=8)
    rf = TE.generate(tm, dm, st, prompts, n_tokens=16, key=KEY)
    ro = TE.generate(tm, dm, dataclasses.replace(st, fused="off"), prompts,
                     n_tokens=16, key=KEY)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(rf, name), getattr(ro, name))
    assert rf.n_steps == ro.n_steps


def test_engine_dispatch():
    for wm in ("gumbel", "synthid", "synthid-inf", "none"):
        assert TE.use_fused(TE.SpecConfig(watermark=wm, fused="on"))
        assert not TE.use_fused(TE.SpecConfig(watermark=wm, fused="off"))
        jd = JE.make_decoder(JE.SpecConfig(watermark=wm))
        td = TE.make_decoder(TE.SpecConfig(watermark=wm))
        assert (td.name, td.stat_dim, td.degenerate, td.draft_stream,
                td.target_stream) == (jd.name, jd.stat_dim, jd.degenerate,
                                      jd.draft_stream, jd.target_stream)
        assert dataclasses.asdict(td.fused_tail) == dataclasses.asdict(
            jd.fused_tail)
    with pytest.raises(ValueError):
        TE.generate(None, None, TE.SpecConfig(), np.zeros((1, 2)),
                    n_tokens=4, key=0, sync_every=0)


@pytest.mark.parametrize("wm", ["gumbel", "synthid", "synthid-inf", "none"])
def test_decoder_sample_matches_reference(wm):
    """One row through each scheme's plain ``sample`` (the per-row
    semantics its batched sampler reproduces) equals the reference's."""
    import torch
    jd = JE.make_decoder(JE.SpecConfig(watermark=wm, m=12))
    td = TE.make_decoder(TE.SpecConfig(watermark=wm, m=12))
    rng = np.random.default_rng(len(wm))
    x = rng.standard_normal((3, 300)).astype(np.float32) * 2
    probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    for row, ctx in zip(probs, rng.integers(0, 2**32, 3, dtype=np.uint64)):
        tj, yj = jd.sample(jnp.asarray(row), jnp.uint32(KEY),
                           jnp.uint32(ctx), 0x7A)
        tt, yt = td.sample(torch.as_tensor(row), torch.tensor(KEY),
                           torch.tensor(int(ctx)), 0x7A)
        assert int(tj) == int(tt)
        np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
