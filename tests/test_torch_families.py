"""The other model families of the port against the reference on the CPU,
with JAX-initialised weights carried across by ``repro_torch.convert``:

- configs: every arch of the reference's registry, its smoke variant and
  its parameter counts;
- the attention families' smoke configs (olmoe and kimi-k2 MoE, the
  llama-3.2-vision VLM, the whisper audio model, nemotron's sqrelu at hd
  64, deepseek-7b, yi-6b-swa4k with its window cut to 8 so it binds):
  logits of ``forward`` / ``prefill`` / ``extend_step`` within atol 1e-4
  (fp32), the MoE aux, and ``convert`` round trips;
- ``apply_moe`` with and without capacity drops (expert ids exact outside
  counted near-tie rows, ``dropped_frac`` and ``lb_loss`` equal);
- windowed and grouped ``decode_attention`` / ``paged_decode_attention``,
  with the reference's windowed-decode rule checked by hand;
- ``generate`` of the olmoe, VLM and audio smoke pairs and paged
  ``serve_requests`` of the olmoe and windowed yi-6b pairs: tokens exact
  outside counted margin rows (``serve.divergence``; 0 expected);
- olmoe's ``lm_loss`` and gradients against ``jax.grad``, and micro-batch
  accumulation against one batch.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.kernels import paged_attention as JPA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serve import config as JC
from repro.serve import engine as JE
from repro.train import loop as JTL
from repro_torch import configs as TCFG
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serve import config as TC
from repro_torch.serve import divergence
from repro_torch.serve import engine as TE
from repro_torch.train import loop as TTL

torch.set_num_threads(1)

ATOL = 1e-4
MARGIN = 1e-5
KEY = 777
V = 128
SMOKE = {"olmoe-1b-7b": {}, "kimi-k2-1t-a32b": {},
         "llama-3.2-vision-11b": {}, "whisper-tiny": {},
         "nemotron-4-340b": {}, "deepseek-7b": {},
         "yi-6b-swa4k": {"window": 8}}


def port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TCFG.ModelConfig)}
    if cfg.moe is not None:
        kw["moe"] = TCFG.MoEConfig(**dataclasses.asdict(cfg.moe))
    if cfg.ssm is not None:
        kw["ssm"] = TCFG.SSMConfig(**dataclasses.asdict(cfg.ssm))
    return TCFG.ModelConfig(**kw)


def j_smoke(name, **kw):
    return JCFG.get_smoke_config(name, vocab=V, **{**SMOKE[name], **kw})


@functools.lru_cache(maxsize=None)
def j_params(cfg, seed=0):
    return JM.init_params(jax.random.key(seed), cfg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(cfg, seed=0):
    return convert.from_jax_tree(np_tree(j_params(cfg, seed)), port_cfg(cfg),
                                 device="cpu")


def j_batch(cfg, B, S, seed):
    """Numpy tokens and frame embeddings from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.arch_type == "audio":
        b["audio_emb"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.arch_type == "vlm":
        b["image_emb"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def t_batch(b):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in b.items()}


def extras(b):
    return {k: v for k, v in b.items() if k != "tokens"} or None


def assert_tree_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JCFG.REGISTRY))
def test_configs_match_reference(name):
    j = JCFG.get_config(name)
    t = TCFG.get_config(name)
    assert t == port_cfg(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert TCFG.get_smoke_config(name, vocab=V) == \
        port_cfg(JCFG.get_smoke_config(name, vocab=V))
    assert TCFG.draft_for(t) == port_cfg(JCFG.draft_for(j))
    for shape in JCFG.INPUT_SHAPES:
        assert TCFG.supports_shape(t, shape) == JCFG.supports_shape(j, shape)
    assert TCFG.ASSIGNED_ARCHS == JCFG.ASSIGNED_ARCHS


# ---------------------------------------------------------------------------
# forward / prefill / extend_step and convert, per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_family_logits_and_convert_match_reference(name):
    cfg = j_smoke(name)
    params = j_params(cfg)
    model = port_model(cfg)
    assert_tree_equal(convert.to_jax_tree(model), np_tree(params))
    B, S, ext = 2, 12, 3
    jb = j_batch(cfg, B, S + ext, seed=5)
    pre = {**jb, "tokens": jb["tokens"][:, :S]}
    jl, jaux = JM.forward(params, cfg, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
    tl, taux = TM.forward(model, t_batch(jb))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=ATOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5,
                               atol=1e-7)
    jp, jc = JM.prefill(params, cfg, {k: jnp.asarray(v)
                                      for k, v in pre.items()}, S + ext + 2)
    tp, tc = model.prefill(t_batch(pre)["tokens"], S + ext + 2,
                           extras=extras(t_batch(pre)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    toks = jb["tokens"][:, S:]
    je, jc = JT.extend_step(params, cfg, jnp.asarray(toks), jc)
    te, tc = model.extend_step(torch.from_numpy(toks).long(), tc)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL)
    # the decode continues the training forward's logits, except under a
    # binding window, where an extend reads one slice for all its queries
    # (the reference's rule, ROADMAP §3)
    if not cfg.window:
        np.testing.assert_allclose(te.numpy(), tl[:, S:].detach().numpy(),
                                   atol=ATOL)
    for k in ("xk", "xv", "ck", "cv"):
        if k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

MOE_CASES = {
    "drop": (dict(n_experts=4, top_k=2, d_expert=32, capacity_factor=0.5),
             "silu", False),
    "shared-dropless": (dict(n_experts=8, top_k=2, d_expert=32,
                             d_shared=16), "silu", True),
    "sqrelu-drop": (dict(n_experts=4, top_k=1, d_expert=32,
                         capacity_factor=1.0), "sqrelu", False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_reference(case):
    kw, act, dropless = MOE_CASES[case]
    jm = JCFG.MoEConfig(**kw)
    tm = TCFG.MoEConfig(**kw)
    d, T = 48, 96
    params = np_tree(JMOE.init_moe(jax.random.key(3), d, jm, act,
                                   jnp.float32))
    x = np.random.default_rng(4).standard_normal((2, T // 2, d)).astype(
        np.float32)
    jy, jaux = JMOE.apply_moe(params, jm, jnp.asarray(x), act,
                              dropless=dropless)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ty, taux = TMOE.apply_moe(tp, tm, torch.from_numpy(x), act,
                              dropless=dropless)
    # expert ids: exact outside rows whose k-th and (k+1)-th router
    # probabilities lie within float noise (counted; none expected)
    probs, _, teids = TMOE.route(torch.from_numpy(x.reshape(T, d)),
                                 tp["router"], jm.top_k)
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, d)) @ params["router"])
    _, jeids = jax.lax.top_k(jprobs, jm.top_k)
    top = torch.sort(probs, -1, descending=True).values
    near = (top[:, :jm.top_k] - top[:, 1:jm.top_k + 1]).abs().min(-1) \
        .values < 1e-6
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(teids.numpy(), np.asarray(jeids))
    if not dropless:
        assert float(jaux["dropped_frac"]) > 0   # the capacity binds
    # the dropped assignments are the same count (the two means may round
    # the quotient apart by an ulp)
    A = T * jm.top_k
    assert round(float(taux["dropped_frac"]) * A) == \
        round(float(jaux["dropped_frac"]) * A)
    np.testing.assert_allclose(float(taux["dropped_frac"]),
                               float(jaux["dropped_frac"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux["lb_loss"]), float(jaux["lb_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    assert TMOE.capacity(T, tm) == JMOE.capacity(T, jm)
    # the combine adds in a fixed order: the same bits run after run
    ty2, _ = TMOE.apply_moe(tp, tm, torch.from_numpy(x), act,
                            dropless=dropless)
    assert torch.equal(ty, ty2)


def test_moe_shard_constraints_raise():
    cfg = TCFG.get_smoke_config("olmoe-1b-7b", vocab=V,
                                moe_shard_constraints=True)
    with pytest.raises(NotImplementedError, match="Multi-device"):
        TM.init_params(cfg, device="cpu")


def test_moe_every_other_than_one_raises():
    """Every layer of a port MoE model holds the MoE FFN, as every layer
    of the reference's does: a config asking for dense layers between is
    refused rather than built as another model."""
    cfg = TCFG.get_smoke_config("olmoe-1b-7b", vocab=V, moe_every=2)
    with pytest.raises(ValueError, match="moe_every=2"):
        TM.init_params(cfg, device="cpu")


# ---------------------------------------------------------------------------
# windowed and grouped decode attention
# ---------------------------------------------------------------------------


def _attn_inputs(seed, B=2, S=32, Sq=5, H=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 2, 8, 32, 40])
@pytest.mark.parametrize("Sq", [1, 5])
@pytest.mark.parametrize("grouped", [False, True])
def test_decode_attention_window_grouped_match_reference(window, Sq,
                                                         grouped):
    q, k, v = _attn_inputs(window * 10 + Sq, Sq=Sq)
    pos = np.array([20, 3], np.int64)            # the limit of query 0
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos, jnp.int32), window=window,
                               grouped=grouped)
    got = TL.decode_attention(*map(torch.from_numpy, (q, k, v, pos)),
                              window=window, grouped=grouped)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the paged path: the same rows through a shuffled page table
    ps, P = 4, 20
    perm = np.random.default_rng(1).permutation(np.arange(1, P))[:16]
    table = perm.reshape(2, 8).astype(np.int64)
    pools = []
    for c in (k, v):
        pool = np.zeros((P, ps) + c.shape[2:], np.float32)
        for b in range(2):
            pool[table[b]] = c[b].reshape(8, ps, *c.shape[2:])
        pools.append(pool)
    jw = JPA.paged_decode_attention(
        jnp.asarray(q), *map(jnp.asarray, pools),
        jnp.asarray(table, jnp.int32), jnp.asarray(pos, jnp.int32),
        window=window, grouped=grouped)
    tw = TL.paged_decode_attention(
        torch.from_numpy(q), *map(torch.from_numpy, pools),
        torch.from_numpy(table), torch.from_numpy(pos), window=window,
        grouped=grouped)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), got.numpy(), atol=1e-6)


def test_windowed_decode_reads_one_slice_per_row():
    """The reference's rule, by hand: with the limit of query 0 at 20 and
    Sq = 5, window 8 gives query i the keys [16, 20 + i); window 2 reads
    the slice [22, 24), where queries 0-2 have no key and average v over
    it, and queries 3 and 4 attend [22, 23) and [22, 24)."""
    q, k, v = _attn_inputs(9, B=1)
    pos = torch.tensor([20])
    tq, tk, tv = map(torch.from_numpy, (q, k, v))

    def manual(i, keys):
        s = torch.einsum("hd,shd->hs", tq[0, i],
                         tk[0, keys].repeat_interleave(2, 1)) / 4.0
        p = torch.softmax(s, -1)
        return torch.einsum("hs,shd->hd", p,
                            tv[0, keys].repeat_interleave(2, 1))

    for window, spans in ((8, [(16, 20 + i) for i in range(5)]),
                          (2, [None, None, None, (22, 23), (22, 24)])):
        got = TL.decode_attention(tq, tk, tv, pos, window=window)
        want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray([20]),
                                   window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        for i, span in enumerate(spans):
            if span is None:      # the uniform average over the slice
                ref_i = tv[0, 22:24].repeat_interleave(2, 1).mean(0)
            else:
                ref_i = manual(i, torch.arange(*span))
            np.testing.assert_allclose(got[0, i].numpy(), ref_i.numpy(),
                                       atol=1e-5, err_msg=f"{window} {i}")


def test_paged_kernel_wrapper_passes_the_window_to_the_plain_version():
    """On a CPU tensor ``ops.paged_attention(window=)`` is the windowed
    plain version; a window at or past the extent changes nothing."""
    q, k, v = _attn_inputs(3, B=1, S=16)
    table = torch.arange(1, 5)[None]
    pool = [torch.cat([torch.zeros(1, 4, 2, 16),
                       torch.from_numpy(c[0]).reshape(4, 4, 2, 16)])
            for c in (k, v)]
    pos = torch.tensor([9])
    full = ops.paged_attention(torch.from_numpy(q), *pool, table, pos)
    for w in (16, 20):
        assert torch.equal(ops.paged_attention(torch.from_numpy(q), *pool,
                                               table, pos, window=w), full)
    win = ops.paged_attention(torch.from_numpy(q), *pool, table, pos,
                              window=4)
    want = TL.decode_attention(*map(torch.from_numpy, (q, k, v)), pos,
                               window=4)
    assert torch.equal(win, want)


# ---------------------------------------------------------------------------
# generate and paged serving
# ---------------------------------------------------------------------------

def _pair(name):
    tcfg = j_smoke(name, n_layers=2, d_model=64, d_ff=128, n_heads=4,
                   n_kv_heads=2, head_dim=16)
    dcfg = JCFG.draft_for(tcfg, n_layers=1, d_model=32, window=tcfg.window)
    return tcfg, dcfg


def _compare(rj, rt, tm, dm, scfg, prompts, ex=None):
    parted = 0
    for b in range(prompts.shape[0]):
        j = divergence.first_divergence(rj, rt, b)
        n = int(rj.lengths[b]) if j is None else j
        if j is not None:
            row_ex = None if ex is None else {
                k: torch.from_numpy(v[b:b + 1]) for k, v in ex.items()}
            marg = divergence.decision_margin(tm, dm, scfg, prompts[b], rt,
                                              b, j, extras=row_ex)
            assert marg < MARGIN, (b, j, marg)
            parted += 1
        for f in ("tokens", "from_draft", "ctx_hashes", "masked"):
            np.testing.assert_array_equal(np.asarray(getattr(rj, f))[b, :n],
                                          np.asarray(getattr(rt, f))[b, :n],
                                          err_msg=f"{b} {f}")
    return parted


@pytest.mark.parametrize("name,wm", [("olmoe-1b-7b", "gumbel"),
                                     ("llama-3.2-vision-11b", "synthid"),
                                     ("whisper-tiny", "gumbel")])
def test_generate_matches_reference(name, wm):
    tcfg, dcfg = _pair(name)
    tm, dm = port_model(tcfg), port_model(dcfg, seed=1)
    b = j_batch(tcfg, 3, 6, seed=8)
    prompts, ex = b["tokens"], extras(b)
    kw = dict(K=3, watermark=wm, m=12, temperature=0.8)
    rj = JE.generate(j_params(tcfg), j_params(dcfg, 1), tcfg, dcfg,
                     JE.SpecConfig(**kw), jnp.asarray(prompts), n_tokens=10,
                     key=KEY, extras=None if ex is None else
                     {k: jnp.asarray(v) for k, v in ex.items()})
    rt = TE.generate(tm, dm, TE.SpecConfig(**kw), prompts, n_tokens=10,
                     key=KEY, extras=None if ex is None else
                     {k: torch.from_numpy(v) for k, v in ex.items()})
    parted = _compare(rj, rt, tm, dm, TE.SpecConfig(**kw), prompts, ex)
    print(f"{name}: {parted} margin rows of {prompts.shape[0]}")
    assert parted <= 1
    if tcfg.arch_type in ("vlm", "audio"):
        from repro_torch.serve.scheduler import Scheduler
        with pytest.raises(ValueError, match="continuous batching"):
            Scheduler(tm, dm, TE.SpecConfig(**kw), batch=2, key=KEY,
                      max_tokens=4)
        with pytest.raises(ValueError, match="paged KV caching"):
            tm.init_paged_cache(2, 8, 4, 4)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "yi-6b-swa4k"])
def test_paged_serve_requests_matches_reference(name):
    tcfg, dcfg = _pair(name)
    tm, dm = port_model(tcfg), port_model(dcfg, seed=1)
    rng = np.random.default_rng(12)
    # prompts past the window, so it binds in the prefill chunks and decode
    reqs = [(rng.integers(1, V, int(n)).astype(np.int32), int(t))
            for n, t in ((11, 9), (5, 12), (14, 6), (3, 10))]
    kw = dict(K=3, watermark="gumbel", m=12, temperature=0.8)
    mode = dict(page_size=4, num_pages=48, prefill_chunk=4)
    rj = JE.serve_requests(
        j_params(tcfg), j_params(dcfg, 1), tcfg, dcfg, JE.SpecConfig(**kw),
        reqs, config=JC.ServeConfig(batch=2, key=KEY, sync_every=2, **mode))
    rt = TE.serve_requests(
        tm, dm, TE.SpecConfig(**kw), reqs,
        config=TC.ServeConfig(batch=2, key=KEY, sync_every=2, **mode))
    assert [r.uid for r in rt] == [r.uid for r in rj]
    parted = 0
    for a, b, (prompt, _) in zip(rj, rt, reqs):
        parted += _compare(a.as_generation_result(), b.as_generation_result(),
                           tm, dm, TE.SpecConfig(**kw), prompt[None])
    print(f"{name}: {parted} margin requests of {len(reqs)}")
    assert parted <= 1


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_olmoe_loss_gradients_and_microbatches_match_reference():
    cfg = j_smoke("olmoe-1b-7b")
    params = j_params(cfg)
    toks = np.random.default_rng(13).integers(1, V, (4, 9)).astype(np.int32)

    def jloss(p):
        return JTL.lm_loss(p, cfg, {"tokens": jnp.asarray(toks)})

    (jl, jex), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = port_model(cfg)
    tl, tex = TTL.lm_loss(model, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tex["aux"].detach()), float(jex["aux"]),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(tl, list(named.values()))
    got = convert.as_tree(dict(zip(named, grads)))
    want = np_tree(jg)

    def close(g, w, path=""):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                close(g[k], w[k], f"{path}/{k}")
            else:
                scale = max(float(np.abs(w[k]).max()), 1e-30)
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=2e-4 * scale,
                                           err_msg=f"{path}/{k}")
    close(got, want)
    # micro-batch accumulation is a refactor of the batch loss
    from repro_torch.optim import adamw
    opt = adamw.AdamWConfig()
    ms = []
    for mb in (1, 2):
        m = port_model(cfg)
        step = TTL.make_train_step(port_cfg(cfg), opt, microbatches=mb)
        m, _, metrics = step(m, adamw.init(dict(m.named_parameters())),
                             {"tokens": torch.from_numpy(toks).long()})
        ms.append((m, metrics))
    assert float(ms[0][1]["ce"]) == pytest.approx(float(ms[1][1]["ce"]),
                                                  rel=1e-4)
    for (n, a), (_, b) in zip(ms[0][0].named_parameters(),
                              ms[1][0].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-2, atol=2e-4, err_msg=n)


def test_train_multiarch_refuses_frame_archs():
    from repro_torch.examples import train_multiarch
    for arch in ("whisper-tiny", "llama-3.2-vision-11b"):
        with pytest.raises(ValueError, match="frame embeddings"):
            train_multiarch.main(["--arch", arch, "--device", "cpu"])
