"""The port's dense transformer (repro_torch.models) against the
reference's (repro.models), with JAX-initialised weights carried across by
repro_torch.convert: prefill, decode_step and an extend_step after a
pos-only rollback give logits within atol=1e-4 in fp32, on the TINY pair
and on V=96 configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs import paper_models as JP
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import paper_models as TP
from repro_torch.configs.base import ModelConfig

# the suite runs several pytest workers on a few cores: one torch thread
# per worker keeps torch's spinning thread pool from starving JAX's
torch.set_num_threads(1)

ATOL = 1e-4


def _port_cfg(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


CONFIGS = {
    "tiny-target": JP.TINY_TARGET,
    "tiny-draft": JP.TINY_DRAFT,
    "v96-target": get_smoke_config("yi-6b", vocab=96, d_model=64, d_ff=128,
                                   n_heads=2, n_kv_heads=2, head_dim=32),
    "v96-gqa": get_smoke_config("yi-6b", n_layers=1, vocab=96, d_model=64,
                                d_ff=64, n_heads=4, n_kv_heads=2,
                                head_dim=16),
}


def test_paper_configs_are_copies():
    for name in ("LLAMA_68M", "LLAMA_7B", "GEMMA_2B", "GEMMA_7B",
                 "TINY_TARGET", "TINY_DRAFT"):
        assert _port_cfg(getattr(JP, name)) == getattr(TP, name), name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_decode_extend_match_reference(name):
    cfg = CONFIGS[name]
    params = JM.init_params(jax.random.key(7), cfg)
    model = convert.from_jax_tree(jax.tree.map(np.asarray, params),
                                  _port_cfg(cfg), device="cpu")
    rng = np.random.default_rng(0)
    B, S, max_seq = 3, 10, 24
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)

    # prefill
    jl, jc = JM.prefill(params, cfg, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = model.prefill(torch.as_tensor(toks, dtype=torch.int64), max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)

    # decode one token with per-row positions
    jc = dict(jc, pos=jnp.full((B,), S, jnp.int32))
    nxt = rng.integers(0, cfg.vocab, size=(B,)).astype(np.int32)
    jl1, jc = JM.decode_step(params, cfg, jnp.asarray(nxt), jc)
    tl1, tc = model.decode_step(torch.as_tensor(nxt, dtype=torch.int64), tc)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=ATOL)

    # extend 4 tokens, roll row 1 back by pos alone, extend again
    ext = rng.integers(0, cfg.vocab, size=(B, 4)).astype(np.int32)
    jl2, jc = JT.extend_step(params, cfg, jnp.asarray(ext), jc)
    tl2, tc = model.extend_step(torch.as_tensor(ext, dtype=torch.int64), tc)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)
    back = np.array([0, 3, 1])
    jc = dict(jc, pos=jc["pos"] - jnp.asarray(back, jnp.int32))
    tc = dict(tc, pos=tc["pos"] - torch.as_tensor(back))
    ext2 = rng.integers(0, cfg.vocab, size=(B, 3)).astype(np.int32)
    jl3, jc = JT.extend_step(params, cfg, jnp.asarray(ext2), jc)
    tl3, tc = model.extend_step(torch.as_tensor(ext2, dtype=torch.int64), tc)
    np.testing.assert_allclose(tl3.numpy(), np.asarray(jl3), atol=ATOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    npos = int(tc["pos"].min())
    np.testing.assert_allclose(tc["k"][:, :, :npos].numpy(),
                               np.asarray(jc["k"])[:, :, :npos], atol=ATOL)


def test_random_init_and_unported_archs():
    from repro_torch.models.model import init_params
    m1 = init_params(TP.TINY_DRAFT, seed=3, device="cpu")
    m2 = init_params(TP.TINY_DRAFT, seed=3, device="cpu")
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert m1.blocks["wq"].shape == (2, 128, 2, 64)
    # the other families build (this slice ported them)
    from repro_torch.configs import get_smoke_config
    moe = init_params(get_smoke_config("olmoe-1b-7b", vocab=64), device="cpu")
    assert moe.blocks["moe"]["w_in"].shape == (2, 4, 256, 256)
    swa = init_params(dataclasses.replace(TP.TINY_DRAFT, window=8),
                      device="cpu")
    assert swa.cfg.window == 8
    with pytest.raises(ValueError):
        init_params(dataclasses.replace(TP.TINY_DRAFT, arch_type="nope"),
                    device="cpu")
