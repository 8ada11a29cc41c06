"""The port's continuous-batching serving path (repro_torch.serve) against
the reference's, on the TINY pair with JAX-initialised weights carried
across by repro_torch.convert.

- ``PageAllocator`` and ``PrefixCache``: one random sequence of ops
  through both packages leaves identical state (refs, free list, peak,
  entries with their pages, parents and children, hit / miss / eviction
  counters), and raises alike.
- ``serve_requests`` against the reference's on one request list, dense,
  paged, and paged with a prefix cache: integers equal exactly (tokens,
  src, context hashes, masks, lengths, admit order, the event log), coins
  within 1e-6.  The two frameworks round float sums differently, so a
  request may part from the reference at a near-tie; it is accepted only
  when ``serve.divergence`` shows the decision's margin under 1e-5, and
  compared up to there.  Margin rows are counted (0 expected).
- Inside the port, every served request equals its solo ``generate`` on
  the CPU under its own key (``KeyPool`` with explicit per-request keys),
  under the same margin rule: the served and solo dense caches differ in
  extent, and PyTorch's CPU softmax may round the last bit differently
  over another extent.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_models as JP
from repro.models import model as JM
from repro.serve import config as JC
from repro.serve import engine as JE
from repro.serve import keys as JK
from repro.serve import scheduler as JS
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import config as TC
from repro_torch.serve import divergence
from repro_torch.serve import engine as TE
from repro_torch.serve import keys as TK
from repro_torch.serve import scheduler as TS

torch.set_num_threads(1)

MARGIN = 1e-5
KEY = 4321
MODES = {
    "dense": dict(),
    "paged": dict(page_size=4, num_pages=40, prefill_chunk=4),
    "prefix": dict(page_size=4, num_pages=40, prefill_chunk=4,
                   prefix_cache=True),
}


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


@pytest.fixture(scope="module")
def port_pair():
    """The TINY pair from the port's own seeded init, for the tests that
    run no reference: a worker that runs only those skips JAX's init."""
    from repro_torch.models.model import init_params
    return (init_params(_port_cfg(JP.TINY_TARGET), seed=0, device="cpu"),
            init_params(_port_cfg(JP.TINY_DRAFT), seed=1, device="cpu"))


def _requests(seed, n=5):
    """Mixed prompt lengths and targets; every other prompt starts with
    one shared 9-token system prompt (two full pages at page_size 4).
    Four prompt lengths in all: the reference's dense admission compiles
    one prefill per length."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, JP.TINY_TARGET.vocab, 9)
    reqs = []
    for i in range(n):
        p = rng.integers(1, JP.TINY_TARGET.vocab, int(rng.choice([3, 7])))
        if i % 2:
            p = np.concatenate([system, p])
        reqs.append((p.astype(np.int32), int(rng.integers(4, 13))))
    return reqs


def _compare(a, b, models, scfg, prompt):
    """a, b: batch-1 GenerationResult views of one request.  Returns 1 if
    they part at a near-tie (compared up to there), else 0 (all equal)."""
    j = divergence.first_divergence(a, b, 0)
    n = int(a.lengths[0]) if j is None else j
    if j is not None:
        marg = divergence.decision_margin(*models, scfg, prompt, b, 0, j)
        assert marg < MARGIN, (j, marg)
    for name in ("tokens", "from_draft", "ctx_hashes", "masked"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[0, :n],
                                      np.asarray(getattr(b, name))[0, :n],
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(a.u)[0, :n], b.u[0, :n], rtol=0,
                               atol=1e-6)
    if j is None:
        np.testing.assert_array_equal(a.lengths, b.lengths)
    return int(j is not None)


# ---------------------------------------------------------------------------
# PageAllocator / PrefixCache
# ---------------------------------------------------------------------------


def _state(alloc, cache):
    entries = [(d, e.page, e.parent, sorted(e.children))
               for d, e in cache._entries.items()]
    return (list(alloc._free), dict(alloc._refs), alloc.n_used_peak,
            entries, cache.hits, cache.misses, cache.evictions)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_and_prefix_cache_match_reference(seed):
    rng = np.random.default_rng(seed)
    ps = 4
    system = rng.integers(1, 50, 12).astype(np.int32)
    pair_ = []
    for S in (JS, TS):
        alloc = S.PageAllocator(24)
        pair_.append((alloc, S.PrefixCache(alloc, ps)))
    held = []                     # (prompt, hit digests, pages) per slot
    for _ in range(60):
        op = rng.integers(0, 5)
        prompt = np.concatenate([system[:int(rng.integers(0, 13))],
                                 rng.integers(1, 50, int(rng.integers(1, 9)))
                                 ]).astype(np.int32)
        pick = int(rng.integers(0, 1 << 30))
        outcomes = []
        for alloc, cache in pair_:
            try:
                if op == 0 or (op == 1 and not held):   # admit a prompt
                    digests, shared = cache.lookup(prompt)
                    need = -(-len(prompt) // ps) - len(shared)
                    if need > alloc.n_free:
                        cache.evict(need - alloc.n_free,
                                    protect=set(digests))
                    for p in shared:
                        alloc.share(p)
                    got = ("admit", prompt, digests,
                           list(shared) + alloc.alloc(need))
                elif op == 1:                           # finalize a slot
                    p_, dg, pages = held[pick % len(held)]
                    got = ("insert", cache.insert_chain(p_, dg, pages))
                elif op == 2 and held:                  # flush a slot
                    got = ("free", held[0][2])
                    alloc.free(held[0][2])
                elif op == 3:
                    got = ("evict", cache.evict(1 + pick % 3))
                else:
                    got = ("share0", alloc.share(0))    # always raises
            except (RuntimeError, ValueError) as e:
                got = ("raised", type(e).__name__)
            outcomes.append(got)
        assert str(outcomes[0]) == str(outcomes[1])
        if outcomes[0][0] == "admit":
            held.append(outcomes[0][1:])
        elif outcomes[0][0] == "free":
            held.pop(0)
        assert _state(*pair_[0]) == _state(*pair_[1])
    assert (TS.PrefixCache.block_digest("ab", system)
            == JS.PrefixCache.block_digest("ab", system))


# ---------------------------------------------------------------------------
# serve_requests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,wm", [("dense", "gumbel"),
                                     ("paged", "synthid"),
                                     ("prefix", "gumbel")])
def test_serve_requests_matches_reference(pair, mode, wm):
    tp, dp, tm, dm = pair
    reqs = _requests(7)
    kw = dict(K=3, watermark=wm, m=12, temperature=0.8)
    sj, st = JE.SpecConfig(**kw), TE.SpecConfig(**kw)
    jstats, tstats = {}, {}
    rj = JE.serve_requests(
        tp, dp, JP.TINY_TARGET, JP.TINY_DRAFT, sj, reqs,
        config=JC.ServeConfig(batch=2, key=KEY, sync_every=2,
                              **MODES[mode]), stats_out=jstats)
    rt = TE.serve_requests(
        tm, dm, st, reqs,
        config=TC.ServeConfig(batch=2, key=KEY, sync_every=2,
                              **MODES[mode]), stats_out=tstats)
    assert [r.uid for r in rt] == [r.uid for r in rj]
    parted = 0
    for a, b, (prompt, _) in zip(rj, rt, reqs):
        assert b.key_word == a.key_word and b.stat_scheme == a.stat_scheme
        parted += _compare(a.as_generation_result(),
                           b.as_generation_result(), (tm, dm), st, prompt)
    assert parted <= 1
    if parted == 0:
        for a, b in zip(rj, rt):
            assert (a.alive_steps, a.n_accepted, a.n_emitted, a.eos) == \
                (b.alive_steps, b.n_accepted, b.n_emitted, b.eos)
        counts = [k for k in jstats if not k.endswith("_s")]
        assert {k: tstats[k] for k in counts} == \
            {k: jstats[k] for k in counts}


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
def test_scheduler_order_and_events_match_reference(pair, mode):
    tp, dp, tm, dm = pair
    reqs = _requests(11, n=6)
    kw = dict(K=3, watermark="gumbel", m=12, temperature=0.8)
    scheds = []
    for S, E, C, models, cfgs in (
            (JS, JE, JC, (tp, dp), (JP.TINY_TARGET, JP.TINY_DRAFT)),
            (TS, TE, TC, (tm, dm), ())):
        s = S.Scheduler(*models, *cfgs, E.SpecConfig(**kw), batch=3,
                        key=KEY, max_tokens=12, max_prompt_len=20,
                        sync_every=3, **MODES[mode])
        s.submit_many(reqs)
        scheds.append((s, s.run()))
    (sj, rj), (st, rt) = scheds
    parted = sum(_compare(a.as_generation_result(), b.as_generation_result(),
                          (tm, dm), TE.SpecConfig(**kw), p)
                 for a, b, (p, _) in zip(rj, rt, reqs))
    assert parted <= 1
    if parted == 0:
        assert st.admit_order == sj.admit_order
        assert st.events == sj.events
        assert st.n_rounds == sj.n_rounds
    # FIFO: slots are taken in submission order (paged admit_order is the
    # finalize order, so there the first prefill chunks witness it)
    first = [e[1] for e in st.events if e[0] == "admit_chunk" and e[2] == 0]
    order = first if st.paged else st.admit_order
    assert order == sorted(order) and len(order) == len(reqs)


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
def test_served_equals_solo_generate(port_pair, mode):
    tm, dm = port_pair
    reqs = _requests(3, n=6)
    keys = [11, 2**32 - 3, 11, 5, 12345, 7]
    scfg = TE.SpecConfig(K=3, watermark="synthid", m=12)
    pool = TK.KeyPool(99, n_keys=2)
    res = TE.serve_requests(
        tm, dm, scfg,
        [{"prompt": p, "n_tokens": n, "key": k}
         for (p, n), k in zip(reqs, keys)],
        config=TC.ServeConfig(batch=2, key=KEY, sync_every=2,
                              key_pool=pool, **MODES[mode]))
    assert pool.live_words == []              # every ref released at flush
    parted = 0
    for r, (p, n), k in zip(res, reqs, keys):
        assert r.key_word == k and r.key_fingerprint == f"{k:08x}"
        solo = TE.generate(tm, dm, scfg, p[None], n_tokens=n, key=k)
        parted += _compare(r.as_generation_result(), solo, (tm, dm), scfg,
                           p)
        if parted == 0:
            np.testing.assert_array_equal(r.y_target, solo.y_target[0,
                                                                   :r.length])
    assert parted <= 1


def test_key_pool_and_config_match_reference():
    for m in (0, 1234, 2**32 + 5):
        for e in range(2):
            for i in range(3):
                assert TK.derive_key_word(m, e, i) == \
                    JK.derive_key_word(m, e, i)
    pj, pt = JK.KeyPool(99, n_keys=3), TK.KeyPool(99, n_keys=3)
    for key in (None, None, 5, None, None):
        assert pt.acquire(key) == pj.acquire(key)
    pj.release(5)
    pt.release(5)
    assert pt.rotate() == pj.rotate()
    assert pt.acquire() == pj.acquire()
    assert pt.live_words == [int(w) for w in pj.live_words]
    assert pt.known_words() == [int(w) for w in pj.known_words()]
    with pytest.raises(ValueError):
        pt.release(5)
    bad = [dict(batch=0), dict(sync_every=0), dict(page_size=4),
           dict(num_pages=8), dict(prefix_cache=True),
           dict(page_size=4, num_pages=1),
           dict(page_size=4, num_pages=8, prefill_chunk=0)]
    for kw in bad:
        for C in (JC, TC):
            with pytest.raises(ValueError):
                C.ServeConfig(**{"batch": 2, "key": 0, **kw}).validate()
    cfg = TC.ServeConfig(batch=2, key=0).resolved(
        [TS.as_request(r) for r in _requests(1)])
    assert cfg.max_tokens == max(n for _, n in _requests(1))
    # every Scheduler keyword of the reference
    assert set(cfg.scheduler_kwargs()) == set(JC.LEGACY_KWARGS)


def test_unported_options_raise(port_pair):
    """What the serving surface still refuses.  ``mesh=`` and
    ``shard_params`` are ported (their refusals, of the sharded shapes
    the port does not run, are tests/test_torch_sharding.py's)."""
    tm, dm = port_pair
    scfg = TE.SpecConfig(K=3)
    with pytest.raises(ValueError):
        TS.Scheduler(tm, dm, TE.SpecConfig(accept="standard"), batch=2,
                     key=0, max_tokens=4)
    # the keyword-argument shim takes shard_params (it acts only with a
    # mesh) and refuses a mix with config=, as the reference's does
    with pytest.warns(DeprecationWarning):
        assert TE.serve_requests(tm, dm, scfg, [], batch=2, key=0,
                                 shard_params=False) == []
    with pytest.raises(TypeError):
        TE.serve_requests(tm, dm, scfg, [],
                          config=TC.ServeConfig(batch=2, key=0), batch=2)
    sched = TS.Scheduler(tm, dm, scfg, batch=2, key=0, max_tokens=4,
                         shard_params=False)
    assert sched.layout is None
