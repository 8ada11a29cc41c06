"""The port's recurrent drafters (repro_torch.serve.drafter) and the
engine and scheduler paths they open, against the reference, on the CPU.

The pair is the reference's test pair (tests/test_drafter.py): a V=96
yi-6b smoke target and a one-layer rwkv6-3b (or zamba2-1.2b) smoke draft,
JAX-initialised and carried across by ``convert.from_jax_tree``.

- Registry, flags and error paths (unknown family; recurrent target,
  hybrid draft and prefix cache refused in paged mode, with the
  reference's message words).
- Inside the port, bitwise: a checkpoint/rollback round trip equals
  replaying exactly out_len tokens; a frozen slot's recurrent rows are
  unchanged by a step; ``slot_extend`` lands a prefill's state (atol
  1e-5) even over a poisoned (re-admitted) slot.
- A recurrent target's committed state equals a fresh prefill of the
  committed tokens (atol 1e-4: decode steps and the sequence scan sum in
  other orders).
- ``generate`` and ``serve_requests`` against the reference: RWKV6 draft
  with gumbel and synthid, dense and paged, per-request keys; Zamba2 draft
  in dense mode.  Tokens, provenance, context hashes, masks and lengths
  are equal exactly and coins within 1e-6, outside margin rows (a row may
  part at a near-tie, accepted only under a 1e-5 margin, counted, at
  most one per run); a chained ``generate(state=...)`` equals the
  reference's chained calls and the port's one long call.
Reference runs are made once per module and shared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.serve import config as JC
from repro.serve import drafter as JD
from repro.serve import engine as JE
from repro_torch import convert
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.serve import config as TC
from repro_torch.serve import divergence
from repro_torch.serve import drafter as TD
from repro_torch.serve import engine as TE

torch.set_num_threads(1)

V = 96
KEY = 1234
MARGIN = 1e-5
PAGED = dict(page_size=4, num_pages=96, prefill_chunk=4)
FIELDS = ("tokens", "from_draft", "ctx_hashes", "masked")
WORDS = [0xA11CE, 0xB0B, 0xA11CE, 0xC0FFEE]


def port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(cfg.ssm))
    return ModelConfig(**kw)


TCFG = get_smoke_config("yi-6b", vocab=V, d_model=64, d_ff=128, n_heads=2,
                        n_kv_heads=2, head_dim=32)
DRAFTS = {"rwkv6": get_smoke_config("rwkv6-3b", n_layers=1, vocab=V,
                                    d_model=32),
          "zamba2": get_smoke_config("zamba2-1.2b", n_layers=1, vocab=V,
                                     d_model=32)}


@pytest.fixture(scope="module")
def pairs():
    """name -> (tcfg, dcfg, JAX target params, JAX draft params, port
    target, port draft); one target shared by both drafts."""
    init = jax.jit(JM.init_params, static_argnums=1)
    tp = init(jax.random.key(0), TCFG)
    tm = convert.from_jax_tree(jax.tree.map(np.asarray, tp), port_cfg(TCFG),
                               device="cpu")
    out = {}
    for name, dcfg in DRAFTS.items():
        dp = init(jax.random.key(1), dcfg)
        dm = convert.from_jax_tree(jax.tree.map(np.asarray, dp),
                                   port_cfg(dcfg), device="cpu")
        out[name] = (TCFG, dcfg, tp, dp, tm, dm)
    return out


def _requests(seed, n):
    """n requests of one prompt length (the reference's dense admission
    compiles one prefill per length) with explicit mixed keys."""
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(1, V, 6).astype(np.int32),
             "n_tokens": int(rng.integers(6, 12)), "key": WORDS[i % 4],
             "uid": i} for i in range(n)]


def _compare(a, b, models, scfg, prompt):
    """Two batch-1 GenerationResults of one request: equal, or parting at
    a counted near-tie (compared up to there).  Returns 1 if they part."""
    j = divergence.first_divergence(a, b, 0)
    n = int(a.lengths[0]) if j is None else j
    if j is not None:
        assert divergence.decision_margin(*models, scfg, prompt, b, 0,
                                          j) < MARGIN
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[0, :n],
                                      np.asarray(getattr(b, name))[0, :n],
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(a.u)[0, :n], b.u[0, :n], rtol=0,
                               atol=1e-6)
    if j is None:
        np.testing.assert_array_equal(a.lengths, b.lengths)
    return int(j is not None)


def _rows(res, b):
    """Row b of a batch GenerationResult as a batch-1 one."""
    return dataclasses.replace(
        res, **{f: getattr(res, f)[b:b + 1]
                for f in FIELDS + ("u", "lengths", "keys")})


# ---------------------------------------------------------------------------
# Registry and error paths
# ---------------------------------------------------------------------------


def test_registry_per_arch(pairs):
    assert TD.get_drafter(port_cfg(TCFG)).name == "transformer"
    rec = TD.get_drafter(port_cfg(DRAFTS["rwkv6"]))
    hyb = TD.get_drafter(port_cfg(DRAFTS["zamba2"]))
    for port, ref in ((rec, JD.RECURRENT_DRAFTER), (hyb, JD.HYBRID_DRAFTER),
                      (TD.get_drafter(port_cfg(TCFG)),
                       JD.TRANSFORMER_DRAFTER)):
        assert (port.name, port.state_keys, port.paged_cache,
                port.chunked_extend) == (ref.name, ref.state_keys,
                                         ref.paged_cache, ref.chunked_extend)
    assert TD.RECURRENT_KEYS == JD.RECURRENT_KEYS
    with pytest.raises(ValueError, match="no drafter registered"):
        TD.get_drafter(dataclasses.replace(port_cfg(TCFG),
                                           arch_type="quantum"))


def test_error_paths(pairs):
    tcfg, dcfg, _, _, tm, dm = pairs["rwkv6"]
    _, _, _, _, _, zm = pairs["zamba2"]
    scfg = TE.SpecConfig(K=2)
    reqs = _requests(1, 1)
    with pytest.raises(ValueError, match="(?s)recurrent.*drafter"):
        TE.serve_requests(dm, dm, scfg, reqs,
                          config=TC.ServeConfig(batch=2, key=KEY, **PAGED))
    with pytest.raises(ValueError, match="(?s)recurrent.*drafter"):
        TE.init_empty_paged_state(dm, tm, scfg, 2, num_pages=8, page_size=4,
                                  max_pages=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        TE.serve_requests(tm, zm, scfg, reqs,
                          config=TC.ServeConfig(batch=2, key=KEY, **PAGED))
    with pytest.raises(ValueError, match="prefix_cache"):
        TE.serve_requests(tm, dm, scfg, reqs,
                          config=TC.ServeConfig(batch=2, key=KEY,
                                                prefix_cache=True, **PAGED))


# ---------------------------------------------------------------------------
# Checkpoints, rollback, the freeze and admission chunks (inside the port)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,out_lens", [("rwkv6", [1, 2, 4]),
                                           ("zamba2", [4, 3, 1])])
def test_checkpoint_rollback_roundtrip(pairs, name, out_lens):
    """commit(checkpoints, out_len) == replaying exactly out_len tokens
    from the post-prefill state, per slot, bitwise."""
    dm = pairs[name][5]
    drafter = TD.get_drafter(dm.cfg)
    B, K = len(out_lens), 3
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(1, V, (B, 6)))
    seq = torch.as_tensor(rng.integers(1, V, (B, K + 1)))
    _, cache = drafter.prefill(dm, prompts, 32)
    pos0 = cache["pos"]
    chks, cur = [], cache
    for t in range(K):
        _, cur = drafter.propose(dm, seq[:, t], cur)
        chks.append(drafter.checkpoint(cur))
    out_len = torch.as_tensor(out_lens)
    committed = drafter.commit(dm, seq[:, K], cur, chks, pos0, out_len)
    assert torch.equal(committed["pos"], pos0 + out_len)
    states, replay = [], cache
    for t in range(K + 1):
        _, replay = drafter.propose(dm, seq[:, t], replay)
        states.append(replay)
    for b, n in enumerate(out_lens):
        for k in drafter.state_keys:
            if k in committed:
                assert torch.equal(committed[k][:, b],
                                   states[n - 1][k][:, b]), (b, n, k)


def test_frozen_slot_keeps_its_recurrent_rows(pairs):
    """A spec step with live=[True, False, True] leaves row 1 of every
    recurrent entry of both caches, and its pos, bitwise unchanged, for a
    recurrent draft and for a recurrent target."""
    _, _, _, _, tm, dm = pairs["rwkv6"]
    prompts = np.random.default_rng(1).integers(1, V, (3, 7))
    live = torch.tensor([True, False, True])
    for t_model, d_model in ((tm, dm), (dm, tm)):
        scfg = TE.SpecConfig(K=3)
        state = TE.init_state(t_model, d_model, scfg,
                              torch.as_tensor(prompts), 40, KEY)
        step = TE.make_spec_step(t_model.cfg, d_model.cfg, scfg)
        new, _ = step(t_model, d_model, state, live=live)
        moved = 0
        for cn in ("t_cache", "d_cache"):
            for k in TD.RECURRENT_KEYS + ("pos",):
                if k not in state[cn]:
                    continue
                old, got = state[cn][k], new[cn][k]
                row = (slice(None), 1) if k != "pos" else (1,)
                assert torch.equal(got[row], old[row]), (cn, k)
                moved += int(not torch.equal(got, old))
        assert moved > 0                 # the live rows did advance


@pytest.mark.parametrize("ck", [4, 3])
def test_slot_extend_matches_prefill_and_zeroes_stale_state(pairs, ck):
    """Chunked admission through ``slot_extend`` lands a full prefill's
    recurrent state, and the reference's, even when the slot's rows were
    poisoned by a previous occupant first (no position gate hides them)."""
    tcfg, dcfg, _, dp, _, dm = pairs["rwkv6"]
    drafter = TD.get_drafter(dm.cfg)
    B, S0, b = 2, 10, 1
    prompt = np.random.default_rng(3).integers(1, V, S0)
    cache = drafter.init_serve_cache(dm, B, max_seq=32, num_pages=0,
                                     page_size=0, max_pages=0)
    jcache = JD.RECURRENT_DRAFTER.init_serve_cache(
        dcfg, B, max_seq=32, num_pages=0, page_size=0, max_pages=0)
    for k in drafter.state_keys:
        if k in cache:
            cache[k] += 7.0
            jcache[k] = jcache[k] + 7.0
    for start in range(0, S0, ck):
        toks = np.zeros((ck,), np.int64)
        n = min(ck, S0 - start)
        toks[:n] = prompt[start:start + n]
        lt, cache = drafter.slot_extend(dm, torch.as_tensor(toks), cache, b,
                                        start, start + n)
        lj, jcache = jax.jit(JD.RECURRENT_DRAFTER.slot_extend,
                             static_argnums=1)(
            dp, dcfg, jnp.asarray(toks, jnp.int32), jcache, b, start,
            start + n)
        np.testing.assert_allclose(lt[0, :n].numpy(), np.asarray(lj)[0, :n],
                                   atol=1e-4)
    _, want = drafter.prefill(dm, torch.as_tensor(prompt[None]), 32)
    assert int(cache["pos"][b]) == S0 and int(cache["pos"][0]) == 0
    for k in drafter.state_keys:
        if k in want:
            np.testing.assert_allclose(cache[k][:, b].numpy(),
                                       want[k][:, 0].numpy(), atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(cache[k][:, b].numpy(),
                                       np.asarray(jcache[k])[:, b],
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["rwkv6", "zamba2"])
def test_recurrent_target_commit_consistency(pairs, name):
    """After two spec steps with a recurrent *target* (its K+1 fed tokens
    decoded one at a time with checkpoints), the target cache equals a
    fresh prefill over exactly the committed tokens (as
    tests/test_engine.py holds the reference)."""
    _, _, _, _, dense, rec = pairs[name]
    prompts = np.random.default_rng(4).integers(1, V, (3, 8))
    scfg = TE.SpecConfig(K=3)
    state = TE.init_state(rec, dense, scfg, torch.as_tensor(prompts), 64,
                          KEY)
    step = TE.make_spec_step(rec.cfg, dense.cfg, scfg)
    st, out = step(rec, dense, state)
    st, out2 = step(rec, dense, st)
    for b in range(3):
        n1, n2 = int(out.out_len[b]), int(out2.out_len[b])
        committed = (list(prompts[b]) + [int(state["last"][b])]
                     + out.out_tokens[b, :n1].tolist()
                     + out2.out_tokens[b, :n2].tolist())
        toks = torch.as_tensor(committed[:-1])[None]
        _, want = rec.prefill(toks, 64)
        got = st["t_cache"]
        npos = len(committed) - 1
        assert int(got["pos"][b]) == npos
        for k in TD.RECURRENT_KEYS:
            if k in want:
                np.testing.assert_allclose(got[k][:, b].float().numpy(),
                                           want[k][:, 0].float().numpy(),
                                           atol=1e-4, err_msg=k)
        for k in ("k", "v"):
            if k in want:
                np.testing.assert_allclose(got[k][:, b, :npos].numpy(),
                                           want[k][:, 0, :npos].numpy(),
                                           atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# generate and serve_requests against the reference
# ---------------------------------------------------------------------------

GEN_CASES = [("rwkv6", "gumbel"), ("rwkv6", "synthid"), ("zamba2", "gumbel")]


def _spec(wm):
    kw = dict(K=3, watermark=wm, m=8, temperature=0.8)
    return JE.SpecConfig(**kw), TE.SpecConfig(**kw)


@pytest.mark.parametrize("name,wm", GEN_CASES)
def test_generate_matches_reference(pairs, name, wm):
    """Mixed per-row keys; rows compared as in test_torch_engine.py."""
    tcfg, dcfg, tp, dp, tm, dm = pairs[name]
    prompts = np.random.default_rng(5).integers(1, V, (3, 8)).astype(
        np.int32)
    keys = np.asarray(WORDS[:3], np.uint32)
    sj, st = _spec(wm)
    rj = JE.generate(tp, dp, tcfg, dcfg, sj, jnp.asarray(prompts),
                     n_tokens=14, key=jnp.asarray(keys))
    rt = TE.generate(tm, dm, st, prompts, n_tokens=14, key=keys)
    parted = sum(_compare(_rows(rj, b), _rows(rt, b), (tm, dm), st,
                          prompts[b]) for b in range(3))
    assert parted <= 1
    if parted == 0:
        assert (rj.n_steps, rj.aatps) == (rt.n_steps, rt.aatps)


SERVE_CASES = [("rwkv6", "dense", "gumbel"), ("rwkv6", "paged", "gumbel"),
               ("rwkv6", "paged", "synthid"), ("zamba2", "dense", "gumbel")]


@pytest.mark.parametrize("name,mode,wm", SERVE_CASES)
def test_serve_requests_matches_reference(pairs, name, mode, wm):
    """Four requests under mixed explicit keys through two slots; the
    port's results equal the reference's (counted margin rows), its
    paged event log too, and (RWKV6, paged) each equals the port's solo
    generate under its own key."""
    tcfg, dcfg, tp, dp, tm, dm = pairs[name]
    reqs = _requests(7, 4)
    sj, st = _spec(wm)
    extra = PAGED if mode == "paged" else {}
    rj = JE.serve_requests(tp, dp, tcfg, dcfg, sj, reqs,
                           config=JC.ServeConfig(batch=2, key=KEY,
                                                 sync_every=2, **extra))
    rt = TE.serve_requests(tm, dm, st, reqs,
                           config=TC.ServeConfig(batch=2, key=KEY,
                                                 sync_every=2, **extra))
    assert [r.uid for r in rt] == [r.uid for r in rj] == [0, 1, 2, 3]
    assert [r.key_word for r in rt] == [r.key_word for r in rj] == WORDS
    parted = sum(_compare(a.as_generation_result(), b.as_generation_result(),
                          (tm, dm), st, req["prompt"])
                 for a, b, req in zip(rj, rt, reqs))
    assert parted <= 1
    if mode == "paged" and wm == "gumbel":
        for r, req in zip(rt, reqs):
            solo = TE.generate(tm, dm, st, req["prompt"][None],
                               n_tokens=req["n_tokens"], key=r.key_word)
            assert _compare(r.as_generation_result(), solo, (tm, dm), st,
                            req["prompt"]) == 0


def test_resume_with_a_recurrent_drafter(pairs):
    """generate(state=...) with an RWKV6 draft: the grown caches skip the
    draft's recurrent state (no k/v), the chained run equals the
    reference's chained run and the port's one long call."""
    tcfg, dcfg, tp, dp, tm, dm = pairs["rwkv6"]
    prompts = np.random.default_rng(6).integers(1, V, (2, 8)).astype(
        np.int32)
    sj, st = _spec("gumbel")
    j1 = JE.generate(tp, dp, tcfg, dcfg, sj, jnp.asarray(prompts),
                     n_tokens=8, key=KEY)
    j2 = JE.generate(tp, dp, tcfg, dcfg, sj, jnp.asarray(prompts),
                     n_tokens=8, key=KEY, state=j1.state)
    t1 = TE.generate(tm, dm, st, prompts, n_tokens=8, key=KEY)
    t2 = TE.generate(tm, dm, st, prompts, n_tokens=8, key=KEY,
                     state=t1.state)
    assert "k" not in t2.state["d_cache"]
    for j, t in ((j1, t1), (j2, t2)):
        assert sum(_compare(_rows(j, b), _rows(t, b), (tm, dm), st,
                            prompts[b]) for b in range(2)) == 0
    tl = TE.generate(tm, dm, st, prompts, n_tokens=15, key=KEY)
    for b in range(2):
        m1, m2 = int(t1.lengths[b]), int(t2.lengths[b])
        for name in FIELDS + ("u",):
            chained = np.concatenate([getattr(t1, name)[b, :m1],
                                      getattr(t2, name)[b, 1:m2]])
            n = min(len(chained), int(tl.lengths[b]))
            np.testing.assert_array_equal(chained[:n],
                                          getattr(tl, name)[b, :n])
