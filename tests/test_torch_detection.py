"""Detection in the port against the reference: records recovered from a
generation and from arbitrary text (bitwise: every statistic is an
integer-PRF word or a uniform made from one), the Ars scores and τ
calibration (rtol 1e-6), the SynthID scores per record under shared ψ
parameters and MLP weights (rtol 1e-5, atol 1e-4), the ψ model and the
Bayes-MLP selector each package trains on the same records (the AUC
within 0.02 of the other's: the two fits draw other random numbers), and
the multi-key sweep.  Inputs are made with numpy from a seed; the TINY pair carries
JAX-initialised weights across through repro_torch.convert."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JP
from repro.core.detection import gumbel_detect as jgd
from repro.core.detection import multikey as jmk
from repro.core.detection import pipeline as jpipe
from repro.core.detection import synthid_detect as jsd
from repro.models import model as JM
from repro.serve import engine as JE
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core.detection import gumbel_detect, mlp, multikey, pipeline
from repro_torch.core.detection import records as trecords
from repro_torch.core.detection import synthid_detect
from repro_torch.serve import engine as TE

torch.set_num_threads(1)

KEY = 4321
V = JP.TINY_TARGET.vocab
REC_FIELDS = ("tokens", "y_draft", "y_target", "u", "src", "ctx")


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
    return tp, dp, tm, dm


def _prompts(B, seed):
    return np.random.default_rng(seed).integers(
        1, V, size=(B, 6)).astype(np.int32)


def _same_records(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for f in REC_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f)
        assert (a.watermarked, a.accept_ratio) == (b.watermarked,
                                                   b.accept_ratio)


@pytest.fixture(scope="module")
def port_records(pair):
    """Watermarked records of the port's own generate (B=6, 36 tokens)
    and null records of random text, per scheme."""
    _, _, tm, dm = pair
    out = {}
    null_toks = np.random.default_rng(5).integers(1, V, size=(6, 36))
    for wm in ("gumbel", "synthid"):
        scfg = TE.SpecConfig(K=3, watermark=wm, m=30, temperature=0.8)
        dec = TE.make_decoder(scfg)
        res = TE.generate(tm, dm, scfg, _prompts(6, 3), n_tokens=36, key=KEY)
        out[wm] = (dec, res,
                   pipeline.records_from_generation(res, dec, KEY, V,
                                                    device="cpu"),
                   pipeline.null_records(null_toks, dec, KEY, V,
                                         device="cpu"))
    return out


@pytest.mark.parametrize("wm", ["gumbel", "synthid"])
def test_records_from_generation_match_reference(port_records, wm):
    """Records of one generation, through each package's pipeline: the
    served statistics, their recovery (use_served=False) and a wrong
    key's recovery equal the reference's, and served equals recovered."""
    tdec, res, _, _ = port_records[wm]
    jdec = JE.make_decoder(JE.SpecConfig(watermark=wm, m=30))
    for key, served in ((KEY, True), (KEY, False), (KEY + 1, True)):
        want = jpipe.records_from_generation(res, jdec, key, V,
                                             use_served=served, n_tokens=30)
        got = pipeline.records_from_generation(res, tdec, key, V,
                                               use_served=served,
                                               n_tokens=30, device="cpu")
        _same_records(want, got)
    _same_records(
        pipeline.records_from_generation(res, tdec, KEY, V, device="cpu"),
        pipeline.records_from_generation(res, tdec, KEY, V,
                                         use_served=False, device="cpu"))


@pytest.mark.parametrize("wm", ["gumbel", "synthid"])
def test_null_records_match_reference(wm):
    toks = np.random.default_rng(2).integers(0, V, size=(3, 30))
    jdec = JE.make_decoder(JE.SpecConfig(watermark=wm, m=30))
    tdec = TE.make_decoder(TE.SpecConfig(watermark=wm, m=30))
    _same_records(jpipe.null_records(toks, jdec, KEY, V),
                  pipeline.null_records(toks, tdec, KEY, V, device="cpu"))


def test_ars_scores_and_calibration_match_reference(port_records):
    _, _, wm_recs, null_recs = port_records["gumbel"]
    for recs in (wm_recs, null_recs):
        for tau in (0.2, 0.5):
            np.testing.assert_allclose(
                gumbel_detect.scores_tau(recs, tau, 30),
                jgd.scores_tau(recs, tau, 30), rtol=1e-6)
        np.testing.assert_allclose(gumbel_detect.scores_prior(recs, 0.4, 30),
                                   jgd.scores_prior(recs, 0.4, 30), rtol=1e-6)
        np.testing.assert_allclose(gumbel_detect.scores_oracle(recs, 30),
                                   jgd.scores_oracle(recs, 30), rtol=1e-6)
    assert gumbel_detect.calibrate_tau(wm_recs, null_recs, 30, grid=20) == \
        jgd.calibrate_tau(wm_recs, null_recs, 30, grid=20)
    assert gumbel_detect.estimate_acceptance_prior(wm_recs) == \
        jgd.estimate_acceptance_prior(wm_recs)
    s_wm = gumbel_detect.scores_tau(wm_recs, 0.5, 36)
    s_null = gumbel_detect.scores_tau(null_recs, 0.5, 36)
    assert s_wm.min() > s_null.max()


def _shared_detector_params(m, hidden=64, seed=11):
    """ψ parameters and MLP weights drawn with numpy, in each package's
    form: a nonzero δ (so the order of the layers matters) and an MLP whose
    τ spreads over (0, 1), its output bias lowered by 3 to centre it (so
    the hard selector 1[u ≤ τ] takes both values)."""
    rng = np.random.default_rng(seed)
    psi = {"beta": rng.normal(0.0, 1.0, m).astype(np.float32),
           "delta": rng.normal(0.0, 0.5, (m, m)).astype(np.float32)}
    sizes = [2 * m, hidden, hidden, 1]
    layers = [{"w": (rng.normal(0.0, 2.0, (a, b)) / np.sqrt(a))
               .astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    layers[-1]["b"] -= 3.0
    to_t = lambda tree: jax.tree.map(torch.as_tensor, tree)   # noqa: E731
    return (to_t(psi), to_t(layers), jax.tree.map(jnp.asarray, psi),
            jax.tree.map(jnp.asarray, layers))


@pytest.mark.parametrize("rule", ["prior", "oracle", "mlp"])
def test_synthid_scores_match_reference_on_shared_params(port_records, rule):
    """The SynthID sequence scores of each package under the same ψ
    parameters and MLP weights, per record (watermarked and null), at
    rtol 1e-5 and atol 1e-4: each per-token term Σ_l log f1 is a float32
    sum of m = 30 logs, summed again over ≤ 36 tokens in another order, and
    a score near zero is a sum of terms whose magnitudes add to hundreds
    (float32 rounds that to ~3e-5)."""
    _, _, wm_recs, null_recs = port_records["synthid"]
    psi_t, mlp_t, psi_j, mlp_j = _shared_detector_params(30)
    fns = {
        "prior": (lambda rs: synthid_detect.scores_prior(psi_t, rs, 0.5, 36),
                  lambda rs: jsd.scores_prior(psi_j, rs, 0.5, 36)),
        "oracle": (lambda rs: synthid_detect.scores_oracle(psi_t, rs, 36),
                   lambda rs: jsd.scores_oracle(psi_j, rs, 36)),
        "mlp": (lambda rs: synthid_detect.scores_mlp(psi_t, mlp_t, rs, 36),
                lambda rs: jsd.scores_mlp(psi_j, mlp_j, rs, 36)),
    }[rule]
    for recs in (wm_recs, null_recs):
        np.testing.assert_allclose(fns[0](recs), fns[1](recs), rtol=1e-5,
                                   atol=1e-4)
    if rule == "mlp":
        # the selector is neither all-draft nor all-target on these records
        x = torch.as_tensor(np.concatenate(
            [np.concatenate([r.y_draft, r.y_target], -1) for r in wm_recs]),
            dtype=torch.float32)
        tau = torch.sigmoid(mlp.apply_mlp(mlp_t, x)[..., 0])
        q = torch.as_tensor(np.concatenate([r.u for r in wm_recs])) <= tau
        assert 0.2 < float(q.float().mean()) < 0.8


def _auc_pair(fn_t, fn_j, wm_recs, null_recs):
    return (trecords.auc(fn_t(wm_recs), fn_t(null_recs)),
            trecords.auc(fn_j(wm_recs), fn_j(null_recs)))


def test_psi_and_mlp_detectors_match_reference_auc(port_records):
    """ψ fitted on the watermarked g-values of the draft tokens and the
    Bayes-MLP selector trained on the records' sources, by each package on
    the same records: Bayes-Prior, Oracle and MLP AUCs within 0.02."""
    _, _, wm_recs, null_recs = port_records["synthid"]
    m = 30
    g = np.concatenate([r.y_draft[r.src == 1] for r in wm_recs])
    psi_t = synthid_detect.fit_psi(g, m, steps=100, device="cpu")
    psi_j = jsd.fit_psi(g, m, steps=100)
    ll_t = float(synthid_detect.log_f1(psi_t, torch.as_tensor(g)).mean())
    ll_j = float(jnp.mean(jsd.log_f1(psi_j, jnp.asarray(g))))
    assert ll_t == pytest.approx(ll_j, abs=0.05)
    assert ll_t > m * np.log(0.5)
    mlp_t, loss_t = synthid_detect.fit_selector_mlp(wm_recs, m, steps=100,
                                                    device="cpu")
    mlp_j, loss_j = jsd.fit_selector_mlp(wm_recs, m, steps=100)
    assert np.isfinite(loss_t) and loss_t == pytest.approx(loss_j, abs=0.1)
    rules = [
        (lambda rs: synthid_detect.scores_prior(psi_t, rs, 0.5, 36),
         lambda rs: jsd.scores_prior(psi_j, rs, 0.5, 36)),
        (lambda rs: synthid_detect.scores_oracle(psi_t, rs, 36),
         lambda rs: jsd.scores_oracle(psi_j, rs, 36)),
        (lambda rs: synthid_detect.scores_mlp(psi_t, mlp_t, rs, 36),
         lambda rs: jsd.scores_mlp(psi_j, mlp_j, rs, 36)),
    ]
    for fn_t, fn_j in rules:
        a_t, a_j = _auc_pair(fn_t, fn_j, wm_recs, null_recs)
        assert abs(a_t - a_j) <= 0.02, (a_t, a_j)


def test_multikey_sweep_matches_reference(port_records):
    """One text per row of a generation, scored under its key and two
    foreign ones: the z-scores and the served-hit cells equal the
    reference's, and every text is attributed to its key.  SynthID's
    (n, m) g-bit statistics score only in the port: the reference's
    Ars-τ selector does not broadcast the coin over the m bits and
    raises."""
    keys = [KEY + 1, KEY, 0xB0B]
    dec, res, _, _ = port_records["gumbel"]
    jdec = JE.make_decoder(JE.SpecConfig(watermark="gumbel"))
    got = multikey.score_texts_by_keys([res], keys, dec, V, n_tokens=32,
                                       device="cpu")
    want = jmk.score_texts_by_keys([res], keys, jdec, V, n_tokens=32)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)
    np.testing.assert_array_equal(got.served_hit, want.served_hit)
    assert got.fingerprints == want.fingerprints
    assert got.key_words == want.key_words
    assert got.attributions(threshold=3.0) == want.attributions(
        threshold=3.0)
    for wm in ("gumbel", "synthid"):
        dec, res, _, _ = port_records[wm]
        rep = multikey.score_texts_by_keys([res], keys, dec, V, n_tokens=32,
                                           device="cpu")
        assert list(rep.best) == [1] * res.tokens.shape[0]
        assert rep.served_hit[:, 1].all() and not rep.served_hit[:, 0].any()
    with pytest.raises(ValueError):
        jmk.score_texts_by_keys([res], keys, JE.make_decoder(
            JE.SpecConfig(watermark="synthid", m=30)), V)
