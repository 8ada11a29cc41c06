"""The port's streaming surface and double-buffered serving loop
(``Scheduler(overlap=True)``, ``engine.serve_stream``) against the
reference's ``tests/test_streaming.py`` invariants, on the TINY pair with
JAX-initialised weights carried across by ``repro_torch.convert``.

- Event parity: the reference's ``Scheduler.run_stream()`` (for gumbel
  through its ``serve_stream``) and the port's yield the same ``(uid,
  token, index, round, final)`` sequence, dense gumbel and synthid with
  overlap off and on, and paged with a prefix cache and mixed
  per-request keys under overlap.  The drained results match too (tokens,
  src, context hashes, masks exactly, coins within rtol 1e-6); a request
  may part from the reference only at a near-tie whose margin
  ``serve.divergence`` puts under 1e-5, and such rows are counted (0
  expected).  Inside the port, overlap changes no served bit.
- ``serve_stream`` under ``asyncio.run`` equals the port's
  ``serve_requests`` and the reference's ``serve_stream`` events.
- One transfer a sync round: ``scheduler.device_get`` runs exactly
  ``n_rounds`` times, dense and paged, overlap off and on.
- Timing under overlap (hypothesis): arrivals monotone, TTFT the first
  arrival, gaps >= 0.
- The deprecation shim of ``serve_requests`` / ``serve_stream``: it warns
  and equals ``config=``, and rejects mixed and unknown keywords, as
  ``tests/test_serve_config.py`` holds the reference's.
"""
import asyncio
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st
from repro.configs import paper_models as JP
from repro.models import model as JM
from repro.serve import config as JC
from repro.serve import engine as JE
from repro.serve import scheduler as JS
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import config as TC
from repro_torch.serve import divergence
from repro_torch.serve import engine as TE
from repro_torch.serve import scheduler as TS

torch.set_num_threads(1)

MARGIN = 1e-5
KEY = 4321
V = JP.TINY_TARGET.vocab
PAGED = dict(page_size=4, num_pages=60, prefill_chunk=4)
# (mode, scheme, overlap) of the event-parity cases
CASES = [("dense", "gumbel", False), ("dense", "gumbel", True),
         ("dense", "synthid", False), ("dense", "synthid", True),
         ("prefix", "gumbel", True)]


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


def _requests(mode):
    """Dense: 4 prompts of one length (the reference's dense admission
    compiles a prefill per length).  Prefix: 5 prompts opening with one
    9-token system prompt (two full pages), with mixed per-request keys
    as the reference's test_streaming_parity_paged_prefix_mixed_keys."""
    rng = np.random.default_rng(7)
    if mode == "dense":
        return [(rng.integers(1, V, 6).astype(np.int32),
                 int(rng.integers(4, 10))) for _ in range(4)]
    system = rng.integers(1, V, 9)
    return [dict(prompt=np.concatenate([system, rng.integers(1, V, 3 + i)])
                 .astype(np.int32), n_tokens=5 + i, key=k)
            for i, k in enumerate([None, 0xA11CE, 0xB0B, None, 0xA11CE])]


def _spec(E, wm):
    return E.SpecConfig(K=3, watermark=wm, m=12)


def _config(C, mode, overlap, **kw):
    return C.ServeConfig(batch=2, key=KEY, max_tokens=12, max_prompt_len=16,
                         sync_every=2, overlap=overlap,
                         **(PAGED if mode == "prefix" else {}),
                         prefix_cache=mode == "prefix", **kw)


def _event(ev):
    uid, tok, meta = ev
    assert set(meta) == {"index", "round", "t_rel_s", "final"}
    return (uid, tok, meta["index"], meta["round"], meta["final"])


def _drain(agen):
    async def run():
        return [_event(ev) async for ev in agen]
    return asyncio.run(run())


_REF = {}


def _reference(pair, mode, wm, overlap):
    """The reference's events and results for one case, computed once per
    module: gumbel through its ``serve_stream`` (the events the port's
    ``serve_stream`` is held to), synthid and paged through its
    ``Scheduler.run_stream()``."""
    case = (mode, wm, overlap)
    if case not in _REF:
        tp, dp = pair[:2]
        cfgs = (JP.TINY_TARGET, JP.TINY_DRAFT)
        got = []
        cfg = _config(JC, mode, overlap, on_result=got.append)
        if wm == "gumbel" and mode == "dense":
            events = _drain(JE.serve_stream(tp, dp, *cfgs, _spec(JE, wm),
                                            _requests(mode), config=cfg))
        else:
            s = JS.Scheduler(tp, dp, *cfgs, _spec(JE, wm),
                             **cfg.scheduler_kwargs())
            s.submit_many(_requests(mode))
            events = [_event(ev) for ev in s.run_stream()]
        _REF[case] = events, sorted(got, key=lambda r: r.uid)
    return _REF[case]


def _port(pair, mode, wm, overlap):
    """The port's events, results and scheduler for one case."""
    tm, dm = pair[2:]
    s = TS.Scheduler(tm, dm, _spec(TE, wm),
                     **_config(TC, mode, overlap).scheduler_kwargs())
    s.submit_many(_requests(mode))
    events = [_event(ev) for ev in s.run_stream()]
    return events, [s.results[u] for u in sorted(s.results)], s


def _compare(a, b, models, scfg, prompt):
    """a, b: batch-1 GenerationResult views of one request (reference,
    port).  Returns 1 if they part at a near-tie (compared up to there),
    else 0 (all equal)."""
    j = divergence.first_divergence(a, b, 0)
    n = int(a.lengths[0]) if j is None else j
    if j is not None:
        marg = divergence.decision_margin(*models, scfg, prompt, b, 0, j)
        assert marg < MARGIN, (j, marg)
    for name in ("tokens", "from_draft", "ctx_hashes", "masked"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[0, :n],
                                      np.asarray(getattr(b, name))[0, :n],
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(a.u)[0, :n], b.u[0, :n],
                               rtol=1e-6, atol=0)
    return int(j is not None)


def _streams(events):
    out = {}
    for uid, tok, *_ in events:
        out.setdefault(uid, []).append(tok)
    return out


def _assert_streams_match(events, results):
    streamed = _streams(events)
    assert set(streamed) == {r.uid for r in results}
    for r in results:
        np.testing.assert_array_equal(streamed[r.uid], r.tokens,
                                      err_msg=f"uid {r.uid}")
    for uid in streamed:
        finals = [e[4] for e in events if e[0] == uid]
        assert finals[-1] and not any(finals[:-1])


def _assert_same_bits(a, b):
    for x, y in zip(a, b):
        for f in ("tokens", "src", "u", "ctx_hashes", "masked", "y_draft",
                  "y_target"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f),
                                          err_msg=f)


def _assert_timing(r):
    assert r.ttft_s is not None and len(r.arrivals_s) == r.length
    assert r.ttft_s == r.arrivals_s[0]
    assert np.all(np.diff(r.arrivals_s) >= 0)
    if r.length > 1:
        assert r.ttft_s <= r.arrivals_s[1] and np.all(r.gaps_s >= 0)


@pytest.mark.parametrize("mode,wm,overlap", CASES)
def test_stream_events_match_reference(pair, mode, wm, overlap):
    ref_events, ref_results = _reference(pair, mode, wm, overlap)
    events, results, _ = _port(pair, mode, wm, overlap)
    assert [r.uid for r in results] == [r.uid for r in ref_results]
    _assert_streams_match(events, results)
    parted = 0
    for a, b, req in zip(ref_results, results, _requests(mode)):
        prompt = req["prompt"] if isinstance(req, dict) else req[0]
        assert b.key_word == a.key_word
        parted += _compare(a.as_generation_result(),
                           b.as_generation_result(), pair[2:],
                           _spec(TE, wm), prompt)
    print(f"margin rows {mode} {wm} overlap={overlap}: {parted}")
    assert parted <= 1
    if parted == 0:
        assert events == ref_events
    for r in results:
        _assert_timing(r)
    if overlap:
        # the snapshot is the chunk's input: tokens surface a round later,
        # but no served bit changes
        _, strict, _ = _port(pair, mode, wm, False)
        _assert_same_bits(results, strict)


def test_serve_stream_matches_serve_requests_and_reference(pair):
    tm, dm = pair[2:]
    reqs, scfg = _requests("dense"), _spec(TE, "gumbel")
    got, stats = [], {}
    events = _drain(TE.serve_stream(
        tm, dm, scfg, reqs, stats_out=stats,
        config=_config(TC, "dense", True, on_result=got.append)))
    drained = TE.serve_requests(tm, dm, scfg, reqs,
                                config=_config(TC, "dense", True))
    _assert_same_bits(sorted(got, key=lambda r: r.uid), drained)
    _assert_streams_match(events, drained)
    assert stats["served"] == len(reqs) and "ttft_mean_s" in stats
    ref_events, _ = _reference(pair, "dense", "gumbel", True)
    assert events == ref_events
    # empty request lists yield nothing
    assert _drain(TE.serve_stream(tm, dm, scfg, [],
                                  config=_config(TC, "dense", True))) == []


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("overlap", [False, True])
def test_one_transfer_per_sync_round(monkeypatch, paged, overlap):
    """The port's counterpart of the reference's
    test_one_batched_transfer_per_sync_round: flags, pos and live rows
    reach the host in one ``device_get`` a round."""
    tm, dm = _port_pair()
    calls = []
    real = TS.device_get
    monkeypatch.setattr(TS, "device_get",
                        lambda h: (calls.append(1), real(h))[1])
    sched = TS.Scheduler(tm, dm, _spec(TE, "gumbel"), batch=2, key=KEY,
                         max_tokens=8, sync_every=2, overlap=overlap,
                         **(PAGED if paged else {}))
    rng = np.random.default_rng(5)
    for _ in range(5):
        sched.submit(rng.integers(1, V, int(rng.integers(4, 8))),
                     int(rng.integers(3, 8)))
    assert len(sched.run()) == 5
    assert len(calls) == sched.n_rounds > 0


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**16),
       targets=st.lists(st.sampled_from([3, 5, 8]), min_size=3,
                        max_size=4))
def test_timing_property_under_overlap(seed, targets):
    """For arbitrary schedules under overlap every request's arrivals
    are monotone, TTFT is the first arrival and precedes the second, and
    every gap is >= 0."""
    tm, dm = _port_pair()
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(1, V, 6).astype(np.int32), n) for n in targets]
    results = TE.serve_requests(
        tm, dm, _spec(TE, "gumbel"), reqs,
        config=TC.ServeConfig(batch=2, key=KEY, sync_every=2, max_tokens=8,
                              overlap=True))
    assert len(results) == len(reqs)
    for r in results:
        _assert_timing(r)


@functools.lru_cache(maxsize=1)
def _port_pair():
    """The port's TINY pair from seeds (hypothesis tests take no
    fixtures)."""
    from repro_torch.models.model import init_params
    return (init_params(_port_cfg(JP.TINY_TARGET), seed=0, device="cpu"),
            init_params(_port_cfg(JP.TINY_DRAFT), seed=1, device="cpu"))


def _served(fn, **call_kw):
    tm, dm = _port_pair()
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, V, 6).astype(np.int32), 5) for _ in range(2)]
    out = fn(tm, dm, _spec(TE, "gumbel"), reqs, **call_kw)
    return _drain(out) if fn is TE.serve_stream else out


@pytest.mark.parametrize("fn", [TE.serve_requests, TE.serve_stream])
def test_legacy_kwargs_shim(fn):
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        legacy = _served(fn, batch=2, key=KEY, sync_every=2)
    # the legacy surface of serve_stream defaults overlap on
    modern = _served(fn, config=TC.ServeConfig(
        batch=2, key=KEY, sync_every=2, overlap=fn is TE.serve_stream))
    if fn is TE.serve_stream:
        assert legacy == modern and len(legacy) > 0
    else:
        assert len(legacy) == len(modern) == 2
        _assert_same_bits(legacy, modern)
    cfg = TC.ServeConfig(batch=2, key=KEY)
    with pytest.raises(TypeError, match="both config="):
        _served(fn, config=cfg, sync_every=2)
    with pytest.raises(TypeError, match="unexpected keyword"):
        _served(fn, config=cfg, sink_every=2)
    with pytest.raises(TypeError, match="config=ServeConfig"):
        _served(fn)
    # shard_params acts only with a mesh: without one it serves the same
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        unsharded = _served(fn, batch=2, key=KEY, sync_every=2,
                            shard_params=False)
    if fn is TE.serve_stream:
        assert unsharded == legacy
    else:
        _assert_same_bits(legacy, unsharded)
    assert set(TC.LEGACY_KWARGS) == set(JC.LEGACY_KWARGS)
    assert TC.LEGACY_KWARGS == JC.LEGACY_KWARGS
