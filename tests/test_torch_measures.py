"""The paper's measures in the port against the reference: the unkeyed
tournament and verify (plain versions and CPU dispatch against the
reference's plain versions and its Pallas kernels run by the
interpreter), the decoders' batched ``modified_dist`` and
``recover_stats``, ``core.speculative``, ``core.strength`` (Def. 3.1),
``core.tradeoff`` (Fig. 1), ``StrengthController`` and tiered
``serve_requests`` on the TINY pair.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: integers (n_acc, prefix masks, context hashes, g-bits, tokens
outside margin rows) are equal; a race or argmax token may differ only
on a margin row (best two scores within 1e-5 relative: jnp.log and
torch.log differ in the last bit), counted and under 1 %.  Tournament
distributions and the speculative operators at rtol 1e-5, atol 1e-6 (the
reference reduces at the 128-lane padded extent, the port over V).
Strength estimates at rel 1e-4 at the same seed count (never against
the theoretical ceiling: the reference's own Monte-Carlo noise misses
it); curves at atol 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JP
from repro.core import prf as jprf
from repro.core import speculative as jspec
from repro.core import strength as jstrength
from repro.core import tradeoff as jtradeoff
from repro.core.watermark.base import get_decoder as jget_decoder
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.serve import config as JC
from repro.serve import engine as JE
from repro.serve import keys as JK
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prf, speculative as spec, strength, tradeoff
from repro_torch.core.watermark import get_decoder
from repro_torch.kernels import ops, ref
from repro_torch.serve import config as TC
from repro_torch.serve import engine as TE
from repro_torch.serve import keys as TK

torch.set_num_threads(1)

MARGIN = 1e-5
RTOL, ATOL = 1e-5, 1e-6
KEY = 4321
SCHEMES = [("gumbel", {}), ("synthid", {"m": 30}), ("synthid", {"m": 4}),
           ("synthid-inf", {})]


def _simplex(rng, shape, temp=3.0):
    x = rng.standard_normal(shape).astype(np.float32) * temp
    x = np.exp(x - x.max(-1, keepdims=True))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def _agree(tok_j, tok_t, margins):
    """Tokens equal outside margin rows, margin rows under 1 %; returns
    the rows that agree."""
    tok_j, tok_t = np.asarray(tok_j), np.asarray(tok_t)
    in_margin = np.asarray(margins) < MARGIN
    assert np.all((tok_j == tok_t) | in_margin), (tok_j, tok_t)
    assert in_margin.sum() <= 0.01 * len(tok_j), in_margin.sum()
    return tok_j == tok_t


# ---------------------------------------------------------------------------
# Kernel 5: the unkeyed tournament
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,V,m", [(8, 96, 8), (8, 256, 30), (4, 300, 30)])
def test_tournament_ref_matches_reference(B, V, m):
    rng = np.random.default_rng(B + V + m)
    probs, seeds = _simplex(rng, (B, V)), _words(rng, B)
    want = jref.tournament_ref(jnp.asarray(probs), jnp.asarray(seeds), m=m)
    got = ref.tournament_ref(_t(probs), _t(seeds), m=m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("V", [96, 256])
def test_tournament_matches_interpreted_kernel(V):
    rng = np.random.default_rng(V + 7)
    probs, seeds = _simplex(rng, (3, V)), _words(rng, 3)
    want = jops.tournament(jnp.asarray(probs), jnp.asarray(seeds), m=30,
                           interpret=True)
    ops.reset_launches()
    got = ops.tournament(_t(probs), _t(seeds), m=30)
    assert ops.LAUNCHES["tournament"] == 0          # the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    # on the card such a row runs in a segment of a warp, whose lanes
    # hold at most 32 entries each (csrc/tournament.cu)
    C, lanes = ops.tournament_shape(V)
    assert C == 0 and lanes <= 32 and -(-V // lanes) <= 32


# ---------------------------------------------------------------------------
# Kernel 6: the unkeyed verify
# ---------------------------------------------------------------------------


def _verify_inputs(B, K, V, seed):
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal((B, K, V)).astype(np.float32) * 3
    lq = lp + rng.standard_normal((B, K, V)).astype(np.float32)
    p, q = _simplex_of(lp), _simplex_of(lq)
    toks = np.stack([[rng.choice(V, p=q[b, s] / q[b, s].sum())
                      for s in range(K)] for b in range(B)]).astype(np.int32)
    u = rng.uniform(size=(B, K)).astype(np.float32)
    u[0] = 0.0                      # row 0 accepts all: slot K-1 still races
    u[1] = 1.0                      # row 1 rejects slot 0
    p[1, 0] = np.minimum(p[1, 0], q[1, 0])    # ... where (p - q)_+ == 0
    return p, q, toks, u, _words(rng, (B, K))


def _simplex_of(x):
    x = np.exp(x - x.max(-1, keepdims=True))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _verify_margins(p, q, n_acc, seeds):
    K = p.shape[1]
    rows = torch.arange(p.shape[0])
    slot = torch.clamp_max(n_acc, K - 1)
    r = torch.clamp_min(p[rows, slot] - q[rows, slot], 0.0)
    return ref.margin(ref.race_scores(r, seeds[rows, slot])[0])


def _check_verify(want, got, args):
    nj, pj, tj, uj = (np.asarray(x) for x in want)
    nt, pt, tt, ut = got
    np.testing.assert_array_equal(nj, nt.numpy())
    np.testing.assert_array_equal(pj, pt.numpy())
    p, q, _, _, seeds = (_t(a) for a in args)
    same = _agree(tj, tt.numpy(), _verify_margins(p, q, nt, seeds).numpy())
    np.testing.assert_array_equal(uj[same], ut.numpy()[same])


@pytest.mark.parametrize("B,K,V", [(8, 4, 96), (8, 3, 256), (4, 1, 300)])
def test_spec_verify_ref_matches_reference(B, K, V):
    args = _verify_inputs(B, K, V, seed=B * K + V)
    want = jref.spec_verify_ref(*(jnp.asarray(a) for a in args))
    got = ref.spec_verify_ref(*(_t(a) for a in args))
    _check_verify(want, got, args)
    n_acc, prefix, rtok, _ = got
    assert int(n_acc[0]) == K and int(n_acc[1]) == 0
    assert int(rtok[1]) == 0        # an all-zero residual races token 0
    assert prefix.dtype == torch.int64 and n_acc.dtype == torch.int64


@pytest.mark.parametrize("V", [96, 256])
def test_spec_verify_matches_interpreted_kernel(V):
    args = _verify_inputs(3, 3, V, seed=V + 11)
    want = jops.spec_verify(*(jnp.asarray(a) for a in args), interpret=True)
    ops.reset_launches()
    got = ops.spec_verify(*(_t(a) for a in args))
    assert ops.LAUNCHES["spec_verify"] == 0
    _check_verify(want, got, args)


# ---------------------------------------------------------------------------
# Decoders: batched modified_dist and recover_stats; prf leftovers
# ---------------------------------------------------------------------------


def _jdists(name, kw, probs, ctxs, stream):
    dec = jget_decoder(name, **kw)
    return np.asarray(jax.vmap(lambda c: dec.modified_dist(
        jnp.asarray(probs), jnp.uint32(KEY), c, stream))(
            jnp.asarray(ctxs, jnp.uint32)))


def _dist_margins(name, kw, probs, ctxs, stream):
    """The race or argmax margin behind each one-hot row."""
    n, V = len(ctxs), probs.shape[-1]
    seeds = prf.wm_seed(KEY, _t(ctxs), stream)
    if name == "gumbel":
        return ref.margin(ref.race_scores(_t(probs).expand(n, V),
                                          seeds)[0]).numpy()
    pn = _t(probs) / _t(probs).sum()
    return ref.margin(ref.tournament_ref(pn.expand(n, V), seeds,
                                         m=kw.get("m", 30))).numpy()


@pytest.mark.parametrize("name,kw", SCHEMES)
def test_modified_dist_matches_reference(name, kw):
    rng = np.random.default_rng(len(name) + kw.get("m", 0))
    probs = _simplex(rng, (120,), temp=1.5)
    ctxs = np.arange(300, dtype=np.int64) * 7919
    want = _jdists(name, kw, probs, ctxs, jprf.STREAM_TARGET)
    dec = get_decoder(name, **kw)
    got = dec.modified_dist(_t(probs), KEY, _t(ctxs), prf.STREAM_TARGET)
    assert got.shape == (300, 120) and got.dtype == torch.float32
    if dec.degenerate:
        _agree(want.argmax(-1), got.argmax(-1).numpy(),
               _dist_margins(name, kw, probs, ctxs, prf.STREAM_TARGET))
        assert torch.equal(got.sum(-1), torch.ones(300))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,kw", [("gumbel", {}), ("synthid", {"m": 7})])
def test_recover_stats_matches_reference(name, kw):
    rng = np.random.default_rng(5)
    V = 200
    toks = rng.integers(0, V, size=(3, 40))
    ctxs = _words(rng, (3, 40))
    jd, td = jget_decoder(name, **kw), get_decoder(name, **kw)
    want = jd.recover_stats(jnp.asarray(toks, jnp.int32), jnp.uint32(KEY),
                            jnp.asarray(ctxs), jprf.STREAM_DRAFT, V)
    got = td.recover_stats(_t(toks), KEY, _t(ctxs), prf.STREAM_DRAFT, V)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert td.flat_stat == jd.flat_stat


def test_prf_sliding_hashes_and_gbits_match_reference():
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 50000, size=(3, 17))
    for c in (1, 4):
        want = jprf.sliding_context_hashes(jnp.asarray(toks, jnp.int32), c)
        got = prf.sliding_context_hashes(_t(toks), c)
        np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                      got.numpy())
    want = jprf.synthid_gbits(jnp.uint32(KEY), jnp.uint32(991), 0x7A, 6, 90)
    got = prf.synthid_gbits(KEY, torch.tensor(991), 0x7A, 6, 90)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# core.speculative
# ---------------------------------------------------------------------------


def test_distribution_operators_match_reference():
    rng = np.random.default_rng(8)
    p, q, qz, rz = (_simplex(rng, (6, 50)) for _ in range(4))
    p[0] = q[0]                                     # P == Q: returns P
    u = rng.uniform(size=(6, 1)).astype(np.float32)
    J = [jnp.asarray(a) for a in (p, q, qz, rz, u)]
    T = [_t(a) for a in (p, q, qz, rz, u)]
    pairs = [
        (jspec.residual_dist(J[0], J[1]), spec.residual_dist(T[0], T[1])),
        (jspec.acceptance_rate(J[1], J[0]),
         spec.acceptance_rate(T[1], T[0])),
        (jspec.accept_prob(J[0], J[1]), spec.accept_prob(T[0], T[1])),
        (jspec.apply_spec_kernel(J[2], J[0], J[1]),
         spec.apply_spec_kernel(T[2], T[0], T[1])),
        (jspec.apply_google_kernel(J[2], J[0], J[1], J[3]),
         spec.apply_google_kernel(T[2], T[0], T[1], T[3])),
        (jspec.alg1_output_dist(J[2], J[0], J[1], J[3], J[4]),
         spec.alg1_output_dist(T[2], T[0], T[1], T[3], T[4])),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_verify_tokens_and_coins_match_reference():
    rng = np.random.default_rng(9)
    B, K = 7, 4
    draft = rng.integers(0, 100, (B, K))
    pp = rng.uniform(size=(B, K)).astype(np.float32)
    qp = rng.uniform(size=(B, K)).astype(np.float32)
    u = rng.uniform(size=(B, K)).astype(np.float32)
    u[0] = 0.0                                       # all accepted: bonus
    resid, bonus = rng.integers(0, 100, (B, K)), rng.integers(0, 100, B)
    want = jspec.verify_tokens(*(jnp.asarray(a) for a in
                                 (draft.astype(np.int32), pp, qp, u,
                                  resid.astype(np.int32),
                                  bonus.astype(np.int32))))
    got = spec.verify_tokens(*(_t(a) for a in (draft, pp, qp, u, resid,
                                               bonus)))
    for f in spec.VerifyResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    ctx = _words(rng, (B, K))
    np.testing.assert_array_equal(
        np.asarray(jspec.pseudorandom_acceptance_coins(jnp.uint32(KEY),
                                                       jnp.asarray(ctx))),
        spec.pseudorandom_acceptance_coins(KEY, _t(ctx)).numpy())
    g = torch.Generator().manual_seed(0)
    coins = spec.standard_acceptance_coins(g, (B, K))
    assert coins.shape == (B, K) and bool(((coins >= 0) & (coins < 1)).all())


# ---------------------------------------------------------------------------
# core.strength (Def. 3.1)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def probs64():
    return _simplex(np.random.default_rng(64), (64,), temp=1.0)


@pytest.mark.parametrize("name,kw", SCHEMES)
def test_strength_estimators_match_reference(probs64, name, kw):
    jd, td = jget_decoder(name, **kw), get_decoder(name, **kw)
    jp, tp = jnp.asarray(probs64), _t(probs64)
    for fn, n in (("watermark_strength", 512), ("strength_via_entropy", 512),
                  ("check_unbiased", 512)):
        want = float(getattr(jstrength, fn)(jd.modified_dist, jp,
                                            jnp.uint32(KEY), n_seeds=n))
        got = float(getattr(strength, fn)(td.modified_dist, tp, KEY,
                                          n_seeds=n))
        assert got == pytest.approx(want, rel=1e-4, abs=1e-7), fn
    assert float(strength.entropy(tp)) == pytest.approx(
        float(jstrength.entropy(jp)), rel=1e-6)
    q = _t(_simplex(np.random.default_rng(1), (64,)))
    assert float(strength.kl(tp, q)) == pytest.approx(
        float(jstrength.kl(jp, jnp.asarray(q.numpy()))), rel=1e-5)
    assert float(strength.tv(tp, q)) == pytest.approx(
        float(jstrength.tv(jp, jnp.asarray(q.numpy()))), rel=1e-5)


def test_llr_decay_matches_reference_for_a_degenerate_scheme(probs64):
    """Gumbel's P_ζ is a point mass, so the categorical draw does not
    depend on the generator and the statistic is the reference's."""
    jd, td = jget_decoder("gumbel"), get_decoder("gumbel")
    want = float(jstrength.llr_pvalue_decay(
        jd.modified_dist, jnp.asarray(probs64), jnp.uint32(KEY), 400))
    got = float(strength.llr_pvalue_decay(td.modified_dist, _t(probs64), KEY,
                                          400))
    assert got == pytest.approx(want, rel=1e-4)
    syn = float(strength.llr_pvalue_decay(get_decoder("synthid").modified_dist,
                                          _t(probs64), KEY, 400))
    assert np.isfinite(syn) and syn > 0


# ---------------------------------------------------------------------------
# core.tradeoff (Fig. 1) and the strength controller
# ---------------------------------------------------------------------------

CURVE_KW = dict(n_gamma=9, n_seeds=4000, seed_chunk=2000)


@pytest.fixture(scope="module")
def curves():
    out = {}
    for name in ("gumbel", "synthid"):
        out[name, "linear"] = (
            jtradeoff.linear_class_curve(name, n_theta=9, **CURVE_KW),
            tradeoff.linear_class_curve(name, n_theta=9, device="cpu",
                                        **CURVE_KW))
        for kind in ("hu", "google"):
            out[name, kind] = (
                jtradeoff.composed_class_curve(name, kind, **CURVE_KW),
                tradeoff.composed_class_curve(name, kind, device="cpu",
                                              **CURVE_KW))
    return out


@pytest.mark.parametrize("name", ["gumbel", "synthid"])
@pytest.mark.parametrize("kind", ["linear", "hu", "google"])
def test_curves_match_reference(curves, name, kind):
    want, got = curves[name, kind]
    assert got.label == want.label
    for f in ("efficiency", "strength", "gammas"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=1e-4, err_msg=f)


def test_reference_points_and_defaults_match():
    want = jtradeoff.reference_points()
    got = tradeoff.reference_points(device="cpu")
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    np.testing.assert_array_equal(tradeoff.Q_SIM.numpy(),
                                  np.asarray(jtradeoff.Q_SIM))
    np.testing.assert_array_equal(tradeoff.P_SIM.numpy(),
                                  np.asarray(jtradeoff.P_SIM))
    assert tradeoff.DEFAULT_KEY == int(np.asarray(
        jprf.as_key_word(jax.random.key(0))))
    with pytest.raises(ValueError):
        tradeoff.composed_class_curve("gumbel", "other", device="cpu")


def _curve_pair(eff, gammas):
    kw = dict(label="s", efficiency=np.asarray(eff),
              strength=np.linspace(0, 1, len(gammas)),
              gammas=np.asarray(gammas))
    return jtradeoff.Curve(**kw), tradeoff.Curve(**kw)


def test_strength_controller_pick_matches_reference(curves):
    jc, tc = _curve_pair([1.0, 0.99, 0.95, 0.93, 0.5],
                         [0.0, 0.25, 0.5, 0.75, 1.0])
    tiers = dict(TK.DEFAULT_TIERS, strict=1.5, mid=0.94)
    assert TK.DEFAULT_TIERS == JK.DEFAULT_TIERS
    for j_ctrl, t_ctrl in (
            (JK.StrengthController(curve=jc, tiers=tiers),
             TK.StrengthController(curve=tc, tiers=tiers, device="cpu")),
            (JK.StrengthController(curve=lambda: jc, tiers=tiers),
             TK.StrengthController(curve=lambda: tc, tiers=tiers)),
            (JK.StrengthController("synthid",
                                   curve=curves["synthid", "linear"][0]),
             TK.StrengthController("synthid",
                                   curve=curves["synthid", "linear"][1]))):
        for tier in j_ctrl.tiers:
            assert t_ctrl.pick(tier) == j_ctrl.pick(tier), tier
    with pytest.raises(ValueError, match="unknown strength tier"):
        TK.StrengthController(curve=tc).pick("warp")
    assert TK.StrengthController("none", curve=tc).pick("assurance") == 0.0


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


def test_tiered_serve_requests_matches_reference(pair, curves):
    """Requests of all three tiers through a synthid controller with the
    Fig. 1 curve: each request's γ, tokens, provenance, coins, context
    hashes and masks equal the reference's."""
    tp, dp, tm, dm = pair
    jcurve, tcurve = curves["synthid", "linear"]
    rng = np.random.default_rng(4)
    tiers = ["latency", "balanced", "assurance"]
    reqs = [{"prompt": rng.integers(1, JP.TINY_TARGET.vocab,
                                    size=5).astype(np.int32),
             "n_tokens": 6, "uid": i, "tier": t}
            for i, t in enumerate(tiers)]
    kw = dict(K=3, watermark="synthid", m=30, temperature=0.8)
    rj = JE.serve_requests(
        tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, JE.SpecConfig(**kw), reqs,
        config=JC.ServeConfig(batch=2, key=KEY, sync_every=2,
                              strength_controller=JK.StrengthController(
                                  "synthid", curve=jcurve)))
    rt = TE.serve_requests(
        tm, dm, TE.SpecConfig(**kw), reqs,
        config=TC.ServeConfig(batch=2, key=KEY, sync_every=2,
                              strength_controller=TK.StrengthController(
                                  "synthid", curve=tcurve, device="cpu")))
    gammas = [r.strength for r in rt]
    assert gammas == [r.strength for r in rj]
    assert gammas[2] == 1.0 and gammas[0] < 1.0
    assert [r.tier for r in rt] == tiers
    for a, b in zip(rj, rt):
        assert a.uid == b.uid
        for f in ("tokens", "src", "ctx_hashes", "masked"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"{a.uid} {f}")
        np.testing.assert_allclose(np.asarray(a.u), b.u, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="without a strength_controller"):
        TE.serve_requests(tm, dm, TE.SpecConfig(**kw), reqs[:1],
                          config=TC.ServeConfig(batch=2, key=KEY))
