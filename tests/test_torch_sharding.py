"""The port's multi-device serving (``repro_torch.sharding``,
``repro_torch.launch.mesh``, ``generate(mesh=...)``, ``Scheduler(mesh=...)``)
against the reference, on the CPU.

- Rules: ``param_specs`` of every ``ASSIGNED_ARCHS`` config at the
  production 16x16 and 2x16x16 meshes (the port's models built on
  ``meta``), ``cache_specs`` at ``decode_32k`` / ``long_500k`` with
  yi-6b's sequence-over-"model" fallback and the paged rule,
  ``engine_state_specs``, the ``batch_spec`` / ``dp_axes`` fallbacks,
  ``logits_spec`` at whisper's odd vocab and ``opt_state_specs``: equal to
  the reference's, dimension by dimension.  The reference's mesh is
  ``jax.sharding.AbstractMesh(sizes, names)`` (JAX 0.9's signature).
- The slice: one spawn of 4 gloo ranks for each of the meshes 4x1 and
  2x2 runs ``generate`` (gumbel, synthid, none with standard acceptance,
  mixed keys, RWKV6 and Zamba2 drafts at 4x1) and ``serve_requests``
  (dense, and paged with a prefix cache; RWKV6-drafted dense and paged at
  4x1) on the TINY pair, with weights from the
  reference's ``init_params`` handed over as ``.npz`` (the ranks import
  no JAX).  Each rank's copy of each result is the same; each is held
  against the reference's unsharded run (none/standard, the Zamba2 draft
  and the RWKV6-drafted serving against the port's; none/standard's
  coins are the port's own): integers equal and tokens equal
  outside margin rows (counted and reported; a row may part only at a
  near-tie whose margin ``serve.divergence`` puts under 1e-5), n_steps
  and AATPS equal where no row parts, and the first verify's target
  logits within 1e-5.  The refusals of the shapes the port does not
  shard name their ROADMAP item.
- A 1x1 mesh (one gloo rank, in this process) equals no mesh bit for
  bit, for ``generate`` and the ``Scheduler``.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as P

import _sharding_ranks as R
from repro import sharding as JSH
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jsmoke
from repro.configs import paper_models as JP
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serve import config as JC
from repro.serve import engine as JE
from repro_torch import configs as TCFG
from repro_torch import convert
from repro_torch import sharding as TSH
from repro_torch.sharding import spmd
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.models.model import init_params
from repro_torch.serve import divergence
from repro_torch.serve import engine as TE
from repro_torch.serve.config import ServeConfig

torch.set_num_threads(1)

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model"))}
MARGIN = 1e-5
LOGIT_ATOL = 1e-5
KEY = 1234
B, S0, N_TOKENS = 4, 8, 10
MIXED = np.arange(B, dtype=np.uint32) * np.uint32(0x01010101) + np.uint32(7)
# the recurrent drafts' smoke configs
DRAFTS = {"rwkv6": ("rwkv6-3b", dict(n_layers=1, vocab=JP.TINY_TARGET.vocab,
                                     d_model=32)),
          "zamba2": ("zamba2-1.2b", dict(n_layers=1,
                                         vocab=JP.TINY_TARGET.vocab,
                                         d_model=32))}
FIELDS = ("tokens", "from_draft", "ctx_hashes", "masked")


def _meshes(name):
    sizes, names = MESHES[name]
    return JMesh(sizes, names), TSH.AbstractMesh(names, sizes)


def _flat_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _same_spec(ref_spec, ref_ndim, port_spec, port_ndim):
    """Equal entry for entry, right-aligned: the port's VLM self blocks
    are one flat axis where the reference has (n_groups, g)."""
    a = list(ref_spec) + [None] * (ref_ndim - len(ref_spec))
    b = list(port_spec) + [None] * (port_ndim - len(port_spec))
    n = min(len(a), len(b))
    return a[len(a) - n:] == b[len(b) - n:] and \
        not any(a[:len(a) - n]) and not any(b[:len(b) - n])


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def abstract_params():
    return {a: JM.abstract_params(jget_config(a)) for a in ASSIGNED_ARCHS}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(abstract_params, arch):
    model = init_params(TCFG.get_config(arch), device="meta")
    shapes = {convert.ref_path(n): p.dim()
              for n, p in model.named_parameters()}
    ref_leaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      abstract_params[arch])[0]}
    assert set(shapes) == set(ref_leaves)
    for name in MESHES:
        jm, tm = _meshes(name)
        ref = _flat_specs(JSH.param_specs(abstract_params[arch], jm))
        got = TSH.param_specs(model, tm)
        for pname, spec in got.items():
            path = convert.ref_path(pname)
            assert _same_spec(ref[path], len(ref_leaves[path].shape), spec,
                              shapes[path]), (name, path, ref[path], spec)
    # opt state mirrors the params
    o = TSH.opt_state_specs(model, tm)
    assert o["m"] == o["v"] == TSH.param_specs(model, tm) and o["step"] == ()


CACHE_ARCHS = ["yi-6b", "rwkv6-3b", "zamba2-1.2b", "olmoe-1b-7b",
               "whisper-tiny"]


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_reference(arch):
    jm, tm = _meshes("1pod")
    model = init_params(TCFG.get_config(arch), device="meta")
    for shp in ("decode_32k", "long_500k"):
        s = INPUT_SHAPES[shp]
        S = min(s.seq_len, 32768)
        ref = JSH.cache_specs(JM.abstract_cache(jget_config(arch),
                                                s.global_batch, S),
                              jm, global_batch=s.global_batch)
        cache = model.init_cache(s.global_batch, S)
        got = TSH.cache_specs(cache, tm, global_batch=s.global_batch)
        assert set(got) == set(ref)
        for k in got:
            assert got[k] == tuple(ref[k]), (shp, k, got[k], ref[k])
    if arch in ("yi-6b", "olmoe-1b-7b"):
        # yi-6b's 4 kv heads do not split 16 ways: S claims "model";
        # olmoe's 16 do
        got = TSH.cache_specs(model.init_cache(128, 1024), tm,
                              global_batch=128)
        want = ((None, "data", "model") if arch == "yi-6b"
                else (None, "data", None, "model"))
        assert got["k"][:len(want)] == want
        # the paged rule: the pool replicates over dp, kv heads split
        paged = model.init_paged_cache(128, 64, 16, 8)
        ref = JSH.cache_specs({k: jax.ShapeDtypeStruct(tuple(v.shape),
                                                       jnp.float32)
                               for k, v in paged.items()}, jm,
                              global_batch=128)
        got = TSH.cache_specs(paged, tm, global_batch=128)
        assert got == {k: tuple(v) for k, v in ref.items()}


def test_state_batch_logits_specs_match_reference():
    jm, tm = _meshes("1pod")
    jmp, tmp = _meshes("2pod")
    tcfg, dcfg = jget_config("yi-6b"), jget_config("deepseek-7b")
    scfg = JE.SpecConfig(K=3)
    for batch in (128, 3):
        ref = JSH.engine_state_specs(
            JE.abstract_state(tcfg, dcfg, scfg, batch, 64), jm,
            global_batch=batch)
        t = init_params(TCFG.get_config("yi-6b"), device="meta")
        d = init_params(TCFG.get_config("deepseek-7b"), device="meta")
        state = TE.init_empty_paged_state(
            t, d, TE.SpecConfig(K=3), batch, num_pages=4, page_size=16,
            max_pages=4)
        state["t_cache"], state["d_cache"] = (t.init_cache(batch, 64),
                                              d.init_cache(batch, 64))
        got = TSH.engine_state_specs(state, tm, global_batch=batch)
        assert set(got) == set(ref)
        for k, v in got.items():
            want = ({c: tuple(x) for c, x in ref[k].items()}
                    if isinstance(v, dict) else tuple(ref[k]))
            assert v == want, (batch, k, v, want)
        assert TSH.batch_leading_specs(
            {"toks": state["window"], "n": 3}, tm, global_batch=batch) == \
            {"toks": tuple(JSH.batch_spec({"x": jax.ShapeDtypeStruct(
                tuple(state["window"].shape), jnp.int32)}, jm,
                global_batch=batch)["x"]), "n": ()}
    # the reference's own fallbacks (tests/test_sharding.py)
    for batch, want in ((256, (("pod", "data"), None)), (1, (None, None)),
                        (16, ("data", None))):
        toks = {"tokens": (batch, 128)}
        ref = JSH.batch_spec({"tokens": jax.ShapeDtypeStruct(
            (batch, 128), jnp.int32)}, jmp, global_batch=batch)
        assert TSH.batch_spec(toks, tmp, global_batch=batch)["tokens"] == \
            tuple(ref["tokens"]) == want
        assert TSH.dp_axes(tmp, batch) == JSH.dp_axes(jmp, batch)
    # whisper's 51865 tokens do not split 16 ways; 32000 do
    for vocab in (51865, 32000, None):
        for batch in (128, 1):
            assert TSH.logits_spec(tm, global_batch=batch, vocab=vocab) == \
                tuple(JSH.logits_spec(jm, global_batch=batch, vocab=vocab))


# ---------------------------------------------------------------------------
# The slice against the reference, on 4 gloo ranks
# ---------------------------------------------------------------------------

GENERATE = {
    "gumbel": dict(scfg=dict(K=2, watermark="gumbel", temperature=0.8),
                   key=KEY),
    "synthid": dict(scfg=dict(K=2, watermark="synthid", m=8,
                              temperature=0.8), key=KEY),
    "none-standard": dict(scfg=dict(K=2, watermark="none",
                                    accept="standard", temperature=0.8),
                          key=KEY),
    "mixed-gumbel": dict(scfg=dict(K=2, watermark="gumbel",
                                   temperature=0.8), key=MIXED),
    "mixed-synthid": dict(scfg=dict(K=2, watermark="synthid", m=8,
                                    temperature=0.8), key=MIXED),
    "rwkv6-draft": dict(scfg=dict(K=2, watermark="gumbel", temperature=0.8),
                        key=KEY, draft="rwkv6"),
    # against the port's unsharded run (one reference compile fewer)
    "zamba2-draft": dict(scfg=dict(K=2, watermark="gumbel", temperature=0.8),
                         key=KEY, draft="zamba2", port_ref=True),
}
SERVE = {
    "serve-dense": dict(scfg=dict(K=2, watermark="gumbel", temperature=0.8),
                        config=dict(batch=4, key=KEY, sync_every=2),
                        system=False),
    "serve-paged": dict(scfg=dict(K=2, watermark="synthid", m=8,
                                  temperature=0.8),
                        config=dict(batch=4, key=KEY, sync_every=2,
                                    page_size=4, num_pages=60,
                                    prefill_chunk=4, prefix_cache=True),
                        system=True),
    # a recurrent draft's state rows under dp, against the port's
    # unsharded serving (the shards that do not hold a slot run its
    # admission's draft calls on zero rows)
    "serve-rwkv6-dense": dict(scfg=dict(K=2, watermark="gumbel",
                                        temperature=0.8),
                              config=dict(batch=4, key=KEY, sync_every=2),
                              system=False, draft="rwkv6"),
    "serve-rwkv6-paged": dict(scfg=dict(K=2, watermark="gumbel",
                                        temperature=0.8),
                              config=dict(batch=4, key=KEY, sync_every=2,
                                          page_size=4, num_pages=60,
                                          prefill_chunk=4),
                              system=True, draft="rwkv6"),
}


def _requests(system: bool = True):
    """Seven prompts of mixed targets; with ``system`` every other one
    opens with one shared 9-token system prompt (two full pages at page
    size 4), so prefix hits cross dp shards.  One prompt length without
    it: the reference's dense admission compiles a prefill per length."""
    rng = np.random.default_rng(7)
    head = rng.integers(1, JP.TINY_TARGET.vocab, 9)
    reqs = []
    for i in range(7):
        p = rng.integers(1, JP.TINY_TARGET.vocab, 7)
        if system and i % 2:
            p = np.concatenate([head, p])
        reqs.append((p.astype(np.int32), int(rng.integers(4, 11))))
    return reqs


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's weights as .npz, the port's models of them, and the
    ranks' case list (cheap: the ranks can start before the reference
    runs)."""
    tmp = tmp_path_factory.mktemp("sharding")
    cfgs = {name: (jsmoke(arch, **kw), TCFG.get_smoke_config(arch, **kw))
            for name, (arch, kw) in DRAFTS.items()}
    init = jax.jit(JM.init_params, static_argnums=1)
    seeds_cfgs = {"target": (0, JP.TINY_TARGET), "draft": (1, JP.TINY_DRAFT)}
    seeds_cfgs.update({name: (3, c[0]) for name, c in cfgs.items()})
    with ThreadPoolExecutor(len(seeds_cfgs)) as pool:   # compiles at once
        trees = dict(zip(seeds_cfgs, pool.map(
            lambda sc: init(jax.random.key(sc[0]), sc[1]),
            seeds_cfgs.values())))
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(tmp / f"{name}.npz")
        R.save_tree(paths[name], jax.tree.map(np.asarray, tree))
    models = {"target": R.port_model(paths["target"], TCFG.TINY_TARGET),
              "draft": R.port_model(paths["draft"], TCFG.TINY_DRAFT)}
    models.update({name: R.port_model(paths[name], c[1])
                   for name, c in cfgs.items()})
    prompts = np.random.default_rng(2).integers(
        1, JP.TINY_TARGET.vocab, (B, S0)).astype(np.int32)
    reqs = {name: _requests(case["system"]) for name, case in SERVE.items()}
    spec = {"target": paths["target"], "draft": paths["draft"],
            "tcfg": TCFG.TINY_TARGET, "dcfg": TCFG.TINY_DRAFT,
            "prompts": prompts, "requests": reqs,
            "drafts": {name: (paths[name], c[1]) for name, c in cfgs.items()},
            "serve": SERVE,
            "generate": {
                n: dict(c, n_tokens=N_TOKENS)
                for n, c in GENERATE.items()}}
    return dict(trees=trees, models=models, spec=spec, prompts=prompts,
                reqs=reqs, cfgs=cfgs)


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's unsharded run of every case (the port's for
    none/standard: its coins are the port's own), the cases compiled and
    run on three threads at once (XLA compiles without the GIL)."""
    trees, models = weights["trees"], weights["models"]
    prompts = weights["prompts"]

    def generate(case):
        draft = case.get("draft", "draft")
        dcfg = (weights["cfgs"][draft][0] if draft in weights["cfgs"]
                else JP.TINY_DRAFT)
        if case["scfg"].get("accept") == "standard" or case.get("port_ref"):
            return TE.generate(models["target"], models[draft],
                               TE.SpecConfig(**case["scfg"]), prompts,
                               n_tokens=N_TOKENS, key=case["key"])
        key = (jnp.asarray(case["key"]) if isinstance(case["key"],
                                                      np.ndarray)
               else case["key"])
        return JE.generate(trees["target"], trees[draft], JP.TINY_TARGET,
                           dcfg, JE.SpecConfig(**case["scfg"]),
                           jnp.asarray(prompts), n_tokens=N_TOKENS, key=key)

    def serve(name, case):
        if case.get("draft"):
            return TE.serve_requests(
                models["target"], models[case["draft"]],
                TE.SpecConfig(**case["scfg"]), weights["reqs"][name],
                config=ServeConfig(**case["config"]))
        return JE.serve_requests(
            trees["target"], trees["draft"], JP.TINY_TARGET, JP.TINY_DRAFT,
            JE.SpecConfig(**case["scfg"]), weights["reqs"][name],
            config=JC.ServeConfig(**case["config"]))

    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(generate, case)
                for name, case in GENERATE.items()}
        jobs.update({name: pool.submit(serve, name, case)
                     for name, case in SERVE.items()})
        return {name: job.result() for name, job in jobs.items()}


def _parity(want, got, models, scfg, prompts):
    """Rows equal, or parting at a counted near-tie (compared up to it);
    -> the margin rows."""
    parted = 0
    for b in range(prompts.shape[0]):
        j = divergence.first_divergence(want, got, b)
        n = int(want.lengths[b]) if j is None else j
        if j is not None:
            marg = divergence.decision_margin(*models, scfg, prompts[b], got,
                                              b, j)
            assert marg < MARGIN, (b, j, marg)
            parted += 1
        for f in FIELDS + ("y_draft", "y_target"):
            np.testing.assert_array_equal(
                np.asarray(getattr(want, f))[b, :n],
                np.asarray(getattr(got, f))[b, :n], err_msg=f"{b} {f}")
        np.testing.assert_allclose(np.asarray(want.u)[b, :n], got.u[b, :n],
                                   rtol=0, atol=1e-6)
    return parted


def _reference_verify(trees, prompts):
    """fed (B, K+1) -> the reference's target logits of a first verify:
    its extend_step (compiled once) over its prefill of ``prompts``."""
    _, cache = JM.prefill(trees["target"], JP.TINY_TARGET,
                          {"tokens": jnp.asarray(prompts)}, 64)
    extend = jax.jit(JT.extend_step, static_argnums=1)
    return lambda fed: np.asarray(extend(
        trees["target"], JP.TINY_TARGET, jnp.asarray(fed, jnp.int32),
        cache)[0])


def _first_verify_logits(ranks, verify, B):
    """The sharded first verify's logits (rows stitched from the ranks)
    against the reference's over the same fed tokens."""
    fed = logits = None
    for (lo, hi), first in ranks:
        if fed is None:
            fed = np.zeros((B,) + first["fed"].shape[1:], np.int64)
            logits = np.zeros((B,) + first["logits"].shape[1:], np.float32)
        fed[lo:hi], logits[lo:hi] = first["fed"], first["logits"]
    return float(np.abs(verify(fed) - logits).max())


def test_sharded_slice_matches_reference(weights, request):
    """One spawn of 4 gloo ranks for each mesh, one after the other, while
    this process runs the reference (eight ranks at once on a few cores
    wait on each other's collectives)."""
    meshes = {(4, 1): dict(weights["spec"]), (2, 2): dict(weights["spec"])}
    # the recurrent draft shards over no "model" axis
    meshes[2, 2]["generate"] = {n: c for n, c in
                                weights["spec"]["generate"].items()
                                if not c.get("draft")}
    meshes[2, 2]["serve"] = {n: c for n, c in SERVE.items()
                             if not c.get("draft")}
    with ThreadPoolExecutor(1) as pool:
        jobs = {dm: pool.submit(spawn, R.slice_rank, 4, backend="gloo",
                                args=(*dm, spec), timeout_s=300)
                for dm, spec in meshes.items()}
        reference = request.getfixturevalue("reference")
        verify = _reference_verify(weights["trees"], weights["prompts"])
        ranks = {dm: job.result() for dm, job in jobs.items()}
    for (data, model), spec in meshes.items():
        _check_mesh(ranks[data, model], data, model, spec, weights,
                    reference, verify)


def _check_mesh(ranks, data, model, spec, weights, reference, verify):
    prompts, models = weights["prompts"], weights["models"]
    margin_rows = {}
    for name, case in spec["generate"].items():
        got = [r[name] for r in ranks]
        for g in got[1:]:                # every rank has the whole batch
            for f in R.RESULT_FIELDS:
                np.testing.assert_array_equal(g[f], got[0][f])
        res = TE.GenerationResult(**{f: got[0][f] for f in R.RESULT_FIELDS
                                     if f != "lengths"},
                                  lengths=got[0]["lengths"],
                                  aatps=got[0]["aatps"],
                                  tokens_per_step=got[0]["tokens_per_step"],
                                  n_steps=got[0]["n_steps"])
        # each rank's state holds its rows
        assert [g["state_rows"] for g in got] == \
            [r["rows"][1] - r["rows"][0] for r in ranks]
        want = reference[name]
        draft = models[case.get("draft", "draft")]
        scfg = TE.SpecConfig(**case["scfg"])
        np.testing.assert_array_equal(res.keys, np.asarray(want.keys))
        parted = _parity(want, res, (models["target"], draft), scfg,
                         prompts)
        margin_rows[name] = parted
        if parted == 0:
            np.testing.assert_array_equal(res.lengths, want.lengths)
            np.testing.assert_array_equal(res.eos, want.eos)
            assert res.n_steps == want.n_steps
            assert res.aatps == want.aatps
        if not case.get("draft"):
            err = _first_verify_logits(
                [(r["rows"], r[name]["first"]) for r in ranks], verify, B)
            assert err < LOGIT_ATOL, (name, err)
    for name, case in spec["serve"].items():
        got = [r[name]["results"] for r in ranks]
        want = reference[name]
        assert [x.uid for x in got[0]] == [x.uid for x in want]
        scfg = TE.SpecConfig(**case["scfg"])
        parted = 0
        for a, b, (prompt, _) in zip(want, got[0],
                                     weights["reqs"][name]):
            for other in got[1:]:
                o = next(x for x in other if x.uid == b.uid)
                np.testing.assert_array_equal(o.tokens, b.tokens)
            assert b.key_word == a.key_word
            parted += _parity(a.as_generation_result(),
                              b.as_generation_result(),
                              (models["target"],
                               models[case.get("draft", "draft")]), scfg,
                              prompt[None])
        margin_rows[name] = parted
        if parted == 0:
            for a, b in zip(want, got[0]):
                assert (a.alive_steps, a.n_accepted, a.n_emitted, a.eos) == \
                    (b.alive_steps, b.n_accepted, b.n_emitted, b.eos)
    print(f"mesh {data}x{model}: margin rows {margin_rows}")
    assert sum(margin_rows.values()) <= 2, margin_rows
    # the refusals, each naming its ROADMAP item
    ref = ranks[0]["refusals"]
    items = {"olmoe-1b-7b": "MoE (expert-parallel)",
             "llama-3.2-vision-11b": "VLM", "whisper-tiny": "audio",
             "rwkv6-3b": "recurrent", "kv heads": "sequence over \"model\"",
             "moe dp": "MoE under dp"}
    expect = (["moe dp"] + ([k for k in items if k != "moe dp"]
                            if model > 1 else []))
    assert sorted(ref) == sorted(expect)
    for k in expect:
        assert "Multi-device and TPU tooling" in ref[k] and items[k] in \
            ref[k], (k, ref[k])
    assert "256 ranks" in ranks[0]["production"]


# ---------------------------------------------------------------------------
# A 1x1 mesh is no mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh(data=4, model=4)     # clamps to 1x1
    finally:
        dist.destroy_process_group()


def test_one_by_one_mesh_equals_no_mesh(one_rank):
    mesh = one_rank
    assert TSH.axis_sizes(mesh) == {"data": 1, "model": 1}

    def pair():
        return (init_params(TCFG.TINY_TARGET, seed=0, device="cpu"),
                init_params(TCFG.TINY_DRAFT, seed=1, device="cpu"))
    prompts = np.random.default_rng(5).integers(
        1, TCFG.TINY_TARGET.vocab, (3, 6)).astype(np.int32)
    scfg = TE.SpecConfig(K=3, watermark="synthid", m=8)
    a = TE.generate(*pair(), scfg, prompts, n_tokens=8, key=MIXED[:3])
    sharded = pair()
    b = TE.generate(*sharded, scfg, prompts, n_tokens=8, key=MIXED[:3],
                    mesh=mesh)
    assert sharded[0].spmd is not None
    for f in R.RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_steps, a.aatps) == (b.n_steps, b.aatps)
    # resumed on the mesh: the state holds its rows
    c = TE.generate(*sharded, scfg, prompts, n_tokens=4, key=MIXED[:3],
                    state=b.state, mesh=mesh)
    d = TE.generate(*pair(), scfg, prompts, n_tokens=4, key=MIXED[:3],
                    state=TE.generate(*pair(), scfg, prompts, n_tokens=8,
                                      key=MIXED[:3]).state)
    np.testing.assert_array_equal(c.tokens, d.tokens)
    reqs = _requests()[:4]
    cfg = dict(batch=2, key=KEY, sync_every=2, page_size=4, num_pages=40,
               prefill_chunk=4)
    ra = TE.serve_requests(*pair(), scfg, reqs, config=ServeConfig(**cfg))
    rb = TE.serve_requests(*sharded, scfg, reqs,
                           config=ServeConfig(mesh=mesh, **cfg))
    for x, y in zip(ra, rb):
        for f in ("tokens", "src", "u", "ctx_hashes", "masked", "y_draft"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    with pytest.raises(ValueError, match="already sharded"):
        spmd.shard_params(sharded[0], make_host_mesh())
