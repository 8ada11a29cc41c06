"""Rank bodies of tests/test_torch_sharding.py.  They run in the processes
that ``repro_torch.launch.mesh.spawn`` starts, so this module imports no
JAX: the weights arrive as ``.npz`` files of the reference's params
trees, and each rank hands back numpy results."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import init_params
from repro_torch.serve import engine as E
from repro_torch.serve.config import ServeConfig
from repro_torch.sharding import spmd

RESULT_FIELDS = ("tokens", "lengths", "from_draft", "u", "ctx_hashes",
                 "masked", "y_draft", "y_target", "eos", "keys", "strength")


def save_tree(path, tree) -> None:
    """A nested params tree as one .npz, keys joined by "/"."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node, np.float32)
    walk("", tree)
    np.savez(path, **flat)


def load_tree(path) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for name in z.files:
            node = tree
            *heads, leaf = name.split("/")
            for h in heads:
                node = node.setdefault(h, {})
            node[leaf] = z[name]
    return tree


def port_model(tree_path, cfg: ModelConfig):
    return convert.from_jax_tree(load_tree(tree_path), cfg, device="cpu")


def result_arrays(res: E.GenerationResult) -> dict:
    out = {f: np.asarray(getattr(res, f)) for f in RESULT_FIELDS}
    out.update(n_steps=res.n_steps, aatps=res.aatps,
               tokens_per_step=res.tokens_per_step)
    return out


def _capture_first_verify():
    """Wrap the engine's target verify: the first call's fed tokens and
    logits (this rank's rows)."""
    got = {}
    run = E._run_target

    def first(t_model, fed, t_cache):
        out = run(t_model, fed, t_cache)
        if "fed" not in got:
            got.update(fed=fed.numpy().copy(), logits=out[0].numpy().copy())
        return out
    E._run_target = first
    return got, run


def _refusal(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def slice_rank(rank: int, data: int, model: int, spec: dict) -> dict:
    """Every case of ``spec`` on one rank of a data x model mesh: the
    sharded generate and serve_requests results (each rank's copy of the
    whole batch), the first verify's logits of this rank's rows, and the
    refusals' messages."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(data=data, model=model)
    layout = spmd.Layout(mesh)
    tcfg, dcfg = spec["tcfg"], spec["dcfg"]
    t_model = port_model(spec["target"], tcfg)
    d_model = port_model(spec["draft"], dcfg)
    prompts = spec["prompts"]
    B = prompts.shape[0]
    out = {"rows": (layout.rows(B).start, layout.rows(B).stop),
           "coord": dict(layout.coord)}
    for name, case in spec["generate"].items():
        draft = (port_model(*spec["drafts"][case["draft"]])
                 if case.get("draft") else d_model)
        got, run = _capture_first_verify()
        try:
            res = E.generate(t_model, draft, E.SpecConfig(**case["scfg"]),
                             prompts, n_tokens=case["n_tokens"],
                             key=case["key"], mesh=mesh)
        finally:
            E._run_target = run
        out[name] = dict(result_arrays(res), first=got,
                         state_rows=int(res.state["last"].shape[0]))
    for name, case in spec["serve"].items():
        stats: dict = {}
        draft = (port_model(*spec["drafts"][case["draft"]])
                 if case.get("draft") else d_model)
        res = E.serve_requests(
            t_model, draft, E.SpecConfig(**case["scfg"]),
            spec["requests"][name],
            config=ServeConfig(mesh=mesh, **case["config"]), stats_out=stats)
        out[name] = dict(results=[dataclasses.replace(
            r, ttft_s=None, arrivals_s=None) for r in res], stats=stats)
    out["refusals"] = refusals(mesh, layout, B)
    out["production"] = _refusal_value(lambda: make_production_mesh())
    return out


def _refusal_value(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def refusals(mesh, layout, B: int) -> dict:
    """The sharded shapes the port refuses on this mesh, by case: the
    message of each NotImplementedError ("" where it ran)."""
    V = 64
    smoke = dict(vocab=V, d_model=64, d_ff=128)
    scfg = E.SpecConfig(K=2)
    prompts = np.ones((B, 4), np.int32)
    out = {}
    if layout.sizes["model"] > 1:
        for arch in ("olmoe-1b-7b", "llama-3.2-vision-11b", "whisper-tiny",
                     "rwkv6-3b"):
            m = init_params(get_smoke_config(arch, n_layers=1, **smoke),
                            seed=0, device="cpu")
            out[arch] = _refusal(lambda: spmd.shard_params(m, mesh))
        odd = init_params(get_smoke_config(
            "yi-6b", n_layers=1, n_heads=2, n_kv_heads=1, head_dim=32,
            **smoke), seed=0, device="cpu")
        out["kv heads"] = _refusal(lambda: spmd.shard_params(odd, mesh))
    if layout.dp(B):
        moe = init_params(get_smoke_config("olmoe-1b-7b", n_layers=1,
                                           **smoke), seed=0, device="cpu")
        moe_draft = init_params(get_smoke_config(
            "olmoe-1b-7b", n_layers=1, **smoke), seed=1, device="cpu")
        out["moe dp"] = _refusal(lambda: E.generate(
            moe, moe_draft, scfg, prompts, n_tokens=2, key=0, mesh=mesh,
            shard_params=False))
    return out
