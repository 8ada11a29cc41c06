"""The port's training path (repro_torch.data, configs.reduced,
models' ``forward``, the differentiable recurrences, optim.adamw,
train.loop, checkpoint.io, convert.to_jax_tree, launch.train) against the
reference's, on the CPU at smoke size (2 layers, d_model 64, S <= 32).

Inputs are made by numpy from a seed; weights come from the reference's
``init_params`` through ``convert``.  Tolerances, all float32:
- the corpus, its batches and prompts, the configs and checkpoints: exact;
- ``schedule``, AdamW's params / m / v, ``lr``: rtol 1e-6 (XLA's and
  PyTorch's cos and pow may differ in the last ulp), ``grad_norm`` rtol
  1e-6 (another summation order over the leaves);
- attention: atol 1e-6 (softmax sums in another order);
- the recurrences' gradients: within 1e-4 of the largest |gradient| of
  each input (the reference's ``test_kernels`` grads hold 1e-4 too: a
  per-timestep replay over S steps in another summation order);
- logits atol 1e-4 as ``test_torch_ssm``; the loss rtol 1e-5; the
  gradients of every parameter within 2e-4 of that parameter's largest
  |gradient| (the chunked Mamba2 forward differentiates the chunked form
  in the reference and replays the per-timestep one in the port: the same
  function, rounded in another order);
- train steps and ``fit`` losses rtol 1e-4 (AdamW divides by sqrt(v),
  which magnifies a gradient's last bits where v is tiny; the losses of
  later steps inherit them).
The reference's jitted functions are built once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.data import synthetic as JSYN
from repro.kernels import ssd as JSSD
from repro.kernels import wkv as JWKV
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import loop as JT
from repro_torch import convert
from repro_torch import configs as TC
from repro_torch.checkpoint import io as TIO
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as TLAUNCH
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.train import loop as TT

torch.set_num_threads(1)

V = 96
S = 24
SMALL = dict(vocab=V, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2,
             head_dim=16)


def with_chunk(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


J_FAMILIES = {
    "dense": j_get_smoke_config("yi-6b", **SMALL),
    "rwkv6": j_get_smoke_config("rwkv6-3b", **SMALL),
    "hybrid": j_get_smoke_config("zamba2-1.2b", **SMALL),
    "hybrid-chunk8": with_chunk(j_get_smoke_config("zamba2-1.2b", **SMALL),
                                8),
}


def port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(cfg.ssm))
    return ModelConfig(**kw)


def j_params(name):
    return _j_params(with_chunk(J_FAMILIES[name], 0)
                     if J_FAMILIES[name].ssm else J_FAMILIES[name])


@functools.lru_cache(maxsize=None)
def _j_params(cfg):
    # jitted (eager, every random draw of the init compiles on its own);
    # the weights do not depend on ssm.chunk, so both hybrids share them
    return jax.jit(JM.init_params, static_argnums=1)(jax.random.key(7), cfg)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(name):
    return convert.from_jax_tree(np_tree(j_params(name)),
                                 port_cfg(J_FAMILIES[name]), device="cpu")


def tokens(seed, B, n):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, V, size=(B, n)).astype(np.int32)
    toks[0, -3:] = 0                      # PAD labels are masked
    return toks


@functools.lru_cache(maxsize=None)
def j_forward_loss_and_grad(name):
    """One jitted program: the logits of tokens[:, :-1], and the loss of
    tokens with its gradients."""
    cfg = J_FAMILIES[name]
    loss_and_grad = jax.value_and_grad(lambda p, b: JT.lm_loss(p, cfg, b),
                                       has_aux=True)
    return jax.jit(lambda p, b: (
        JM.forward(p, cfg, {"tokens": b["tokens"][:, :-1]})[0],
        loss_and_grad(p, b)))


def assert_tree_close(got, want, rel, path=""):
    """Every leaf within rel · max|leaf of want|."""
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_close(got[k], want[k], rel, f"{path}/{k}")
            continue
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=rel * scale, err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# Corpus and configs
# ---------------------------------------------------------------------------


def test_synthetic_corpus_matches_reference():
    assert (TSYN.VOCAB, TSYN.BOS, TSYN.EOS, TSYN.PAD) == \
        (JSYN.VOCAB, JSYN.BOS, JSYN.EOS, JSYN.PAD)
    tc, jc = TSYN.SyntheticCorpus(), JSYN.SyntheticCorpus()
    assert tc.words == jc.words
    np.testing.assert_array_equal(tc.bigram, jc.bigram)
    ts, js = TSYN.token_stream(tc, 12, seed=3), JSYN.token_stream(jc, 12,
                                                                  seed=3)
    np.testing.assert_array_equal(ts, js)
    tb, jb = TSYN.batches(ts, 4, 16, seed=5), JSYN.batches(js, 4, 16, seed=5)
    for _ in range(3):
        np.testing.assert_array_equal(next(tb)["tokens"], next(jb)["tokens"])
    for a, b in zip(TSYN.prompts(tc, 5), JSYN.prompts(jc, 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["yi-6b", "rwkv6-3b", "zamba2-1.2b"])
def test_configs_and_reduced_match_reference(name):
    assert TC.get_config(name) == port_cfg(j_get_config(name))
    assert TC.get_smoke_config(name, vocab=256) == \
        port_cfg(j_get_smoke_config(name, vocab=256))
    odd = dict(SMALL, n_kv_heads=3)       # does not divide n_heads: 1
    assert TC.get_smoke_config(name, **odd) == \
        port_cfg(j_get_smoke_config(name, **odd))


def test_unported_archs_are_refused():
    from repro.configs import REGISTRY as J_REGISTRY
    assert set(J_REGISTRY) <= set(TC.REGISTRY)
    assert TC.get_config("olmoe-1b-7b").arch_type == "moe"
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-2, warmup_steps=10, total_steps=50)


def test_schedule_matches_reference():
    steps = np.arange(0, 61)
    got = TA.schedule(TA.AdamWConfig(**OPT), torch.from_numpy(steps))
    want = JA.schedule(JA.AdamWConfig(**OPT), jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("step0,gscale", [(0, 0.05), (20, 3.0)])
def test_adamw_apply_matches_reference(step0, gscale):
    rng = np.random.default_rng(step0)
    shapes = {"w": (4, 6), "b": (6,), "t": (2, 3, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (gscale * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (0.01 * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (1e-4 * rng.random(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    jp, js, jm = jax.jit(JA.apply, static_argnums=0)(
        JA.AdamWConfig(**OPT), jax.tree.map(jnp.asarray, p),
        jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.int32(step0)})
    t = lambda d: {k: torch.from_numpy(a.copy()) for k, a in d.items()}
    tp, ts, tm = TA.apply(
        TA.AdamWConfig(**OPT), t(p), t(g),
        {"m": t(m), "v": t(v), "step": torch.tensor(step0, dtype=torch.int32)})
    assert int(ts["step"]) == int(js["step"]) == step0 + 1
    assert (float(jm["grad_norm"]) > 1.0) == (gscale > 1)   # clipping or not
    for key, want in (("grad_norm", jm["grad_norm"]), ("lr", jm["lr"])):
        np.testing.assert_allclose(float(tm[key]), float(want), rtol=1e-6)
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,skip", [
    (True, 0, True), (True, 0, False), (True, 6, True), (False, 0, False)])
def test_attention_matches_reference(causal, window, skip):
    rng = np.random.default_rng(window + 2 * skip)
    q = rng.normal(size=(2, 20, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 20, 2, 8)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    full = TL.attention_full(tq, tk, tv, causal=causal, window=window)
    j_full = jax.jit(functools.partial(JL.attention_full, causal=causal,
                                       window=window))(jq, jk, jv)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=1e-6)
    kw = dict(causal=causal, window=window, q_block=8, kv_block=8,
              skip_masked_blocks=skip)
    blk = TL.attention_blockwise(tq, tk, tv, **kw)
    j_blk = jax.jit(functools.partial(JL.attention_blockwise, **kw))(
        jq, jk, jv)
    np.testing.assert_allclose(blk.numpy(), np.asarray(j_blk), atol=1e-6)
    np.testing.assert_allclose(blk.numpy(), full.numpy(), atol=1e-6)
    # the port's dispatch: blockwise past the threshold, full within it
    kw.pop("skip_masked_blocks")
    for thr, want in ((4, blk), (20, full)):
        got = TL.attention(tq, tk, tv, blockwise_threshold=thr, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The differentiable recurrences
# ---------------------------------------------------------------------------


def _wkv_args(rng, B=2, Sq=24, H=2, hd=4):
    lead = (B, Sq, H, hd)
    return [rng.normal(size=lead), rng.normal(size=lead), rng.normal(size=lead),
            1 / (1 + np.exp(-rng.normal(size=lead))), rng.normal(size=(H, hd)),
            rng.normal(size=(B, H, hd, hd))]


def _ssd_args(rng, B=2, Sq=24, H=2, hd=4, N=4):
    return [-np.log1p(np.exp(rng.normal(size=(B, Sq, H)))),
            rng.normal(size=(B, Sq, H, hd)), rng.normal(size=(B, Sq, N)),
            rng.normal(size=(B, Sq, N)), rng.normal(size=(B, H, hd, N))]


RECURRENCES = {
    # name: (inputs, the port's op, the reference's differentiable op)
    "wkv": (_wkv_args, ops.wkv, lambda *a: JWKV.wkv(*a, 8, True)),
    "ssd": (_ssd_args, lambda *a: ops.ssd(*a, chunk=8),
            lambda *a: JSSD.ssd(*a, 8, True)),
    "ssd_scan": (_ssd_args, ops.ssd_scan, JSSD.ssd_ref),
}


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_recurrence_gradients_match_reference(name, with_state):
    make, port_op, ref_op = RECURRENCES[name]
    args = [a.astype(np.float32) for a in make(np.random.default_rng(3))]
    ws = 1.0 if with_state else 0.0

    def j_loss(*a):
        y, s = ref_op(*a)
        return (y ** 2).sum() + ws * (s ** 2).sum()

    want = jax.grad(j_loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = port_op(*targs)
    loss = (y ** 2).sum() + ((s ** 2).sum() if with_state else 0.0)
    got = torch.autograd.grad(loss, targs)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{name} input {i}")


def test_recurrences_record_no_graph_without_grad():
    args = [torch.from_numpy(a.astype(np.float32))
            for a in _wkv_args(np.random.default_rng(1))]
    y, s = ops.wkv(*args)
    assert y.grad_fn is None and s.grad_fn is None
    args[0].requires_grad_()
    y, _ = ops.wkv(*args)
    assert type(y.grad_fn).__name__ == "ReplayBackward"


# ---------------------------------------------------------------------------
# forward, lm_loss, train steps, fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(J_FAMILIES))
def test_forward_loss_and_gradients_match_reference(name):
    toks = tokens(11, 2, S + 1)
    jlogits, ((jloss, jex), jgrads) = j_forward_loss_and_grad(name)(
        j_params(name), {"tokens": jnp.asarray(toks)})
    model = port_model(name)
    batch = {"tokens": torch.from_numpy(toks).long()}
    logits, aux = TM.forward(model, {"tokens": batch["tokens"][:, :-1]})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4)
    assert float(aux) == 0.0
    for remat in (False, True):
        loss, ex = TT.lm_loss(model, batch, remat=remat)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(ex["ce"].detach()), float(jex["ce"]),
                                   rtol=1e-5)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        assert_tree_close(convert.as_tree(dict(zip(params, grads))),
                          np_tree(jgrads), 2e-4)


# AdamW's first update is g / (|g| + eps): near g = 0 it turns a
# gradient's last-bit rounding into up to 2·lr of parameter, so the
# train-step parity takes an eps that keeps the update smooth at this scale
STEP_OPT = dict(OPT, eps=1e-3)


@functools.lru_cache(maxsize=None)
def j_train_step(name, microbatches):
    return jax.jit(JT.make_train_step(J_FAMILIES[name],
                                      JA.AdamWConfig(**STEP_OPT),
                                      microbatches=microbatches))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    name = "dense"
    toks = tokens(13, 4, S + 1)
    jp, js, jm = j_train_step(name, microbatches)(
        j_params(name), JA.init(j_params(name)),
        {"tokens": jnp.asarray(toks)})
    model = port_model(name)
    step = TT.make_train_step(model.cfg, TA.AdamWConfig(**STEP_OPT),
                              microbatches=microbatches)
    model, ts, tm = step(model, TA.init(dict(model.named_parameters())),
                         {"tokens": torch.from_numpy(toks).long()})
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert int(ts["step"]) == 1
    assert_tree_close(convert.to_jax_tree(model), np_tree(jp), 1e-5)
    assert_tree_close(convert.as_tree(ts["m"]), np_tree(js["m"]), 2e-4)
    with pytest.raises(ValueError):
        step(port_model("rwkv6"), ts, {"tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("name", ["dense", "hybrid-chunk8"])
def test_fit_losses_match_reference(name):
    stream = TSYN.token_stream(TSYN.SyntheticCorpus(), 20)
    stream = np.where(stream < V, stream, stream % V).astype(np.int32)
    cfg = J_FAMILIES[name]
    _, jhist = JT.fit(cfg, JSYN.batches(stream, 2, S, seed=1), steps=5,
                      params=j_params(name), opt_cfg=JA.AdamWConfig(**OPT),
                      verbose=False)
    model, thist = TT.fit(port_cfg(cfg), TSYN.batches(stream, 2, S, seed=1),
                          steps=5, params=np_tree(j_params(name)),
                          opt_cfg=TA.AdamWConfig(**OPT), verbose=False,
                          device="cpu")
    np.testing.assert_allclose(thist, jhist, rtol=1e-4)
    assert thist[-1] < thist[0]


# ---------------------------------------------------------------------------
# Checkpoints, to_jax_tree, the launcher, serving a trained model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dense", "rwkv6", "hybrid"])
def test_to_jax_tree_inverts_from_jax_tree(name):
    tree = np_tree(j_params(name))
    back = convert.to_jax_tree(port_model(name))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    jax.tree.map(np.testing.assert_array_equal, back, tree)


@pytest.mark.parametrize("name", ["dense", "hybrid"])
def test_checkpoints_round_trip_both_ways(name, tmp_path):
    tree = np_tree(j_params(name))
    # the port writes, the reference reads
    TIO.save(str(tmp_path / "port.npz"), port_model(name))
    got = JIO.load(str(tmp_path / "port.npz"), j_params(name))
    jax.tree.map(np.testing.assert_array_equal, np_tree(got), tree)
    # the reference writes, the port reads: into a model and into a tree
    JIO.save(str(tmp_path / "ref.npz"), j_params(name))
    fresh = TM.init_params(port_cfg(J_FAMILIES[name]), seed=1, device="cpu")
    loaded = TIO.load(str(tmp_path / "ref.npz"), fresh)
    assert loaded is fresh
    jax.tree.map(np.testing.assert_array_equal,
                 convert.to_jax_tree(loaded), tree)
    jax.tree.map(np.testing.assert_array_equal,
                 TIO.load(str(tmp_path / "ref.npz"), tree), tree)
    # a checkpoint of another width raises
    wider = dataclasses.replace(port_cfg(J_FAMILIES[name]), d_ff=256)
    with pytest.raises(ValueError, match="shape mismatch"):
        TIO.load(str(tmp_path / "ref.npz"),
                 TM.init_params(wider, device="cpu"))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("launch") / "yi.npz")
    model, hist = TLAUNCH.main(["--arch", "yi-6b", "--steps", "3", "--batch",
                                "2", "--seq", "16", "--device", "cpu",
                                "--save", path])
    return model, hist, path


def test_launch_train_writes_a_reference_checkpoint(launched):
    model, hist, path = launched
    assert len(hist) == 3 and all(np.isfinite(hist))
    like = jax.eval_shape(functools.partial(
        JM.init_params, cfg=j_get_smoke_config("yi-6b", vocab=256)),
        jax.random.key(0))
    got = JIO.load(path, like)
    jax.tree.map(np.testing.assert_array_equal, np_tree(got),
                 convert.to_jax_tree(model))
    with pytest.raises(NotImplementedError, match="Multi-device"):
        TLAUNCH.main(["--dry-run"])


def test_trained_model_serves_as_its_checkpoint(launched):
    from repro_torch.serve import engine as E
    model, _, path = launched
    loaded = TIO.load(path, TM.init_params(model.cfg, seed=9, device="cpu"))
    draft = TM.init_params(TC.get_smoke_config(
        "yi-6b", vocab=256, n_layers=1, d_model=64, d_ff=128, n_heads=2,
        n_kv_heads=2, head_dim=32), seed=4, device="cpu")
    scfg = E.SpecConfig(K=3, watermark="gumbel", temperature=0.7)
    prompts = tokens(17, 2, 6) % 256
    a = E.generate(model, draft, scfg, prompts, n_tokens=12, key=5)
    b = E.generate(loaded, draft, scfg, prompts, n_tokens=12, key=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_replay_grad_tol_covers_an_output_error_of_the_tolerance(name):
    """ref.replay_grad_tol, the card's bound on the Functions' gradients
    against autograd through the plain versions, holds when the forward's
    outputs are off by their whole tolerance (``wkv_tol`` / ``ssd_tol``):
    a forward that adds +tol to every output stands in for a kernel."""
    make, port_op, _ = RECURRENCES[name]
    args = [torch.from_numpy(a.astype(np.float32))
            for a in make(np.random.default_rng(4))]
    plain = ref.wkv_ref if name == "wkv" else ref.ssd_ref
    want_outs = plain(*args)
    tols = (ref.wkv_tol(*args) if name == "wkv" else
            ref.ssd_tol(*args, chunk=8 if name == "ssd" else 0))
    kernel_outs = [o + t for o, t in zip(want_outs, tols)]

    def grads(fwd):
        xs = [a.clone().requires_grad_() for a in args]
        y, s = ops.Replay.apply(fwd, plain, *xs)
        return torch.autograd.grad((y ** 2).sum() + (s ** 2).sum(), xs)

    got = grads(lambda *a: tuple(o.clone() for o in kernel_outs))
    want = grads(plain)
    bound = ref.replay_grad_tol("wkv" if name == "wkv" else "ssd", args,
                                kernel_outs, tols)
    for g, w, b in zip(got, want, bound):
        assert bool(((g - w).abs() <= b).all())
        assert bool(((g - w).abs() > 0).any())      # the error did show
