"""The port's kernel plain versions (repro_torch.kernels.ref) against the
reference's (repro.kernels.ref) and, at small shapes, the reference's
Pallas kernels run by the interpreter; and the CPU dispatch of
repro_torch.kernels.ops.  The CUDA kernels are held against their plain
versions in test_torch_cuda.py, on a card.

Tolerances: integers (n_acc, prefix, tokens outside margin rows, g-bits)
match exactly.  A race token may differ only on a margin row, where the
best two scores are within 1e-5 relative (jnp.log and torch.log differ in
the last bit); those rows are counted and must stay under 1 %.  Floats
compare at rtol=1e-5; tournament distributions add atol=1e-6, because
their sums run in another order and an entry far below the unit mass
keeps only the absolute error of the (1 + g − mass) factor."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.watermark.base import FusedTail as JTail
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.watermark.base import FusedTail
from repro_torch.kernels import ops, ref

# the suite runs several pytest workers on a few cores: one torch thread
# per worker keeps torch's spinning thread pool from starving JAX's
torch.set_num_threads(1)

MARGIN = 1e-5
RTOL, DIST_ATOL = 1e-5, 1e-6
STREAMS = jops.DEFAULT_STREAMS


def _simplex(rng, shape, temp=3.0):
    x = rng.standard_normal(shape).astype(np.float32) * temp
    x = np.exp(x - x.max(-1, keepdims=True))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a):
    """numpy -> torch, with integer words and tokens as int64."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def _race_tokens_agree(tok_j, tok_t, margins, n_rows):
    """Tokens equal outside margin rows; margin rows under 1 %."""
    tok_j, tok_t = np.asarray(tok_j), tok_t.numpy()
    in_margin = margins.numpy() < MARGIN
    assert np.all((tok_j == tok_t) | in_margin), (tok_j, tok_t)
    assert in_margin.sum() <= 0.01 * n_rows, in_margin.sum()
    return tok_j == tok_t


# ---------------------------------------------------------------------------
# gumbel_argmax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,V", [(64, 96), (64, 256), (8, 32000)])
def test_gumbel_argmax_ref_matches_reference(B, V):
    rng = np.random.default_rng(V)
    probs = _simplex(rng, (B, V))
    probs[1] = 0.0                       # all-zero row: token 0, U[0]
    probs[2, : V // 2] = 0.0             # zero-mass tokens never win
    seeds = _words(rng, B)
    tj, uj = jref.gumbel_argmax_ref(jnp.asarray(probs), jnp.asarray(seeds))
    tt, ut = ref.gumbel_argmax_ref(_t(probs), _t(seeds))
    scores, _ = ref.race_scores(_t(probs), _t(seeds))
    same = _race_tokens_agree(tj, tt, ref.margin(scores), B)
    np.testing.assert_array_equal(np.asarray(uj)[same], ut.numpy()[same])
    assert int(tt[1]) == 0 and int(tt[2]) >= V // 2


@pytest.mark.parametrize("V", [96, 256])
def test_gumbel_argmax_ref_matches_interpreted_kernel(V):
    rng = np.random.default_rng(V + 1)
    probs, seeds = _simplex(rng, (2, V)), _words(rng, 2)
    tj, uj = jops.gumbel_argmax(jnp.asarray(probs), jnp.asarray(seeds),
                                interpret=True)
    tt, ut = ops.gumbel_argmax(_t(probs), _t(seeds))
    scores, _ = ref.race_scores(_t(probs), _t(seeds))
    same = _race_tokens_agree(tj, tt, ref.margin(scores), 2)
    np.testing.assert_array_equal(np.asarray(uj)[same], ut.numpy()[same])


# ---------------------------------------------------------------------------
# tournament_keyed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,V,m", [(8, 96, 8), (8, 256, 30), (4, 32000, 30)])
def test_tournament_keyed_ref_matches_reference(B, V, m):
    rng = np.random.default_rng(V + m)
    probs, keys, ctx = _simplex(rng, (B, V)), _words(rng, B), _words(rng, B)
    want = jref.tournament_keyed_ref(jnp.asarray(probs), jnp.asarray(keys),
                                     jnp.asarray(ctx), stream=0xD0, m=m)
    got, arg = ref.tournament_keyed_ref(_t(probs), _t(keys), _t(ctx),
                                        stream=0xD0, m=m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=DIST_ATOL)
    _race_tokens_agree(np.argmax(np.asarray(want), -1), arg,
                       ref.margin(got), B)


@pytest.mark.parametrize("V", [96, 256])
def test_tournament_keyed_matches_interpreted_kernel(V):
    rng = np.random.default_rng(V + 2)
    probs, keys, ctx = _simplex(rng, (2, V)), _words(rng, 2), _words(rng, 2)
    want = jops.tournament_keyed(jnp.asarray(probs), jnp.asarray(keys),
                                 jnp.asarray(ctx), stream=0x7A, m=30,
                                 interpret=True)
    got, _ = ops.tournament_keyed(_t(probs), _t(keys), _t(ctx), stream=0x7A,
                                  m=30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=DIST_ATOL)


# ---------------------------------------------------------------------------
# spec_verify_wm
# ---------------------------------------------------------------------------


def _verify_inputs(B, K, V, seed, seen_frac=0.3):
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal((B, K + 1, V)).astype(np.float32) * 3
    lq = lp[:, :K] + rng.standard_normal((B, K, V)).astype(np.float32)
    p, q = _softmax(lp), _softmax(lq)
    toks = np.stack([[rng.choice(V, p=q[b, s] / q[b, s].sum())
                      for s in range(K)] for b in range(B)]).astype(np.int32)
    u = rng.uniform(size=(B, K)).astype(np.float32)
    u[0] = 0.0                           # row 0 accepts all: bonus slot
    if B > 3:
        u[3] = 1.0                       # row 3 rejects slot 0
        p[3, 0] = np.where(q[3, 0] >= p[3, 0], p[3, 0], q[3, 0])  # r == 0
    keys, ctx = _words(rng, B), _words(rng, (B, K + 1))
    seen = rng.uniform(size=(B, K + 1)) < seen_frac
    if B > 1:
        seen[1] = True                   # row 1 on the plain streams
    live = np.ones(B, bool)
    if B > 2:
        live[2] = False
    return p, q, toks, u, keys, ctx, seen, live


def _softmax(x):
    x = np.exp(x - x.max(-1, keepdims=True))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


TAILS = [("race", 0, False), ("tournament", 8, False),
         ("tournament", 30, False), ("tournament", 30, True)]


def _tail_margins(args, n_acc, kind, m, degenerate):
    p, q, toks, u, keys, ctx, seen, live = (_t(a) for a in args)
    r, seen_s, wm_s, pl_s, dw_s = ref.tail_rows(p, q, n_acc, keys, ctx, seen,
                                                streams=STREAMS)
    if kind == "race":
        return ref.margin(ref.race_scores(r, torch.where(seen_s, pl_s,
                                                         wm_s))[0])
    rn = r / torch.clamp_min(r.sum(-1, keepdim=True), ref.EPS)
    pz = ref.tournament_rounds(rn, wm_s, m)
    scores = ref.race_scores(torch.where(seen_s[:, None], rn, pz),
                             torch.where(seen_s, pl_s, dw_s))[0]
    if degenerate:
        scores = torch.where(seen_s[:, None], scores, pz)
    return ref.margin(scores)


def _check_verify(want, got, args, kind, m, degenerate, n_rows):
    nj, pj, tj, sj = (np.asarray(x) for x in want)
    nt, pt, tt, st = got
    np.testing.assert_array_equal(nj, nt.numpy())
    np.testing.assert_array_equal(pj, pt.numpy())
    margins = _tail_margins(args, nt, kind, m, degenerate)
    same = _race_tokens_agree(tj, tt, margins, n_rows)
    np.testing.assert_array_equal(sj[same], st.numpy()[same])


@pytest.mark.parametrize("kind,m,degenerate", TAILS)
@pytest.mark.parametrize("B,K,V", [(16, 4, 96), (8, 3, 256), (4, 4, 32000)])
def test_spec_verify_wm_ref_matches_reference(kind, m, degenerate, B, K, V):
    args = _verify_inputs(B, K, V, seed=B * K + V + m)
    jt = JTail(kind=kind, m=m, stat_dim=m or 1, degenerate=degenerate)
    want = jref.spec_verify_wm_ref(*(jnp.asarray(a) for a in args),
                                   streams=STREAMS, tail=jt)
    got = ref.spec_verify_wm_ref(*(_t(a) for a in args), streams=STREAMS,
                                 kind=kind, m=m, degenerate=degenerate)
    _check_verify(want, got, args, kind, m, degenerate, B)
    n_acc, _, etok, estat = got
    assert int(n_acc[0]) == K                        # the bonus slot
    assert int(n_acc[2]) == 0 and int(etok[2]) == 0  # a dead row
    assert float(estat[2].abs().sum()) == 0.0


@pytest.mark.parametrize("kind,m,degenerate", TAILS)
@pytest.mark.parametrize("V", [96, 256])
def test_spec_verify_wm_matches_interpreted_kernel(kind, m, degenerate, V):
    args = _verify_inputs(2, 3, V, seed=V + m + 5, seen_frac=0.5)
    jt = JTail(kind=kind, m=m, stat_dim=m or 1, degenerate=degenerate)
    want = jops.spec_verify_wm(*(jnp.asarray(a) for a in args),
                               streams=STREAMS, tail=jt, interpret=True)
    tail = FusedTail(kind=kind, m=m, stat_dim=m or 1, degenerate=degenerate)
    got = ops.spec_verify_wm(*(_t(a) for a in args), streams=STREAMS,
                             tail=tail)
    _check_verify(want, got, args, kind, m, degenerate, 2)


def test_all_zero_residual_row_emits_token_zero():
    """A rejected slot whose (p − q)_+ row is all zero races nothing but
    -inf scores: the token is 0 and its statistic U[0], as jnp.argmax."""
    B, K, V = 2, 2, 96
    args = list(_verify_inputs(B, K, V, seed=3, seen_frac=0.0))
    p, q = args[0], args[1]
    p[:, 0] = q[:, 0]                    # r == 0 on slot 0
    args[3] = np.ones((B, K), np.float32)   # reject slot 0
    got = ref.spec_verify_wm_ref(*(_t(a) for a in args), streams=STREAMS)
    want = jref.spec_verify_wm_ref(*(jnp.asarray(a) for a in args),
                                   streams=STREAMS)
    assert got[2].tolist() == [0, 0]
    np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())


def test_cpu_dispatch_takes_plain_versions_and_counts_nothing():
    ops.reset_launches()
    args = [_t(a) for a in _verify_inputs(2, 2, 96, seed=9)]
    a = ops.spec_verify_wm(*args)
    b = ref.spec_verify_wm_ref(*args, streams=ops.DEFAULT_STREAMS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    probs = torch.softmax(torch.randn(3, 50), -1)
    seeds = torch.arange(3)
    assert torch.equal(ops.gumbel_argmax(probs, seeds)[0],
                       ref.gumbel_argmax_ref(probs, seeds)[0])
    ops.tournament_keyed(probs, seeds, seeds, stream=1, m=3)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    with pytest.raises(ValueError):
        ops.gumbel_argmax(probs.to("meta"), seeds.to("meta"))
