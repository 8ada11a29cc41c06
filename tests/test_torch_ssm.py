"""The port's recurrent families (repro_torch.models.ssm and the plain
versions of the WKV and SSD kernels) against the reference's, on the CPU.

- Plain versions: ``repro_torch.kernels.ref``'s ``wkv_ref``,
  ``wkv_step_ref``, ``ssd_ref``, ``ssd_step_ref`` and ``ssd_chunked_ref``
  against the Pallas kernels in interpret mode and against
  ``repro.kernels``' own plain scans, on one set of numpy inputs, with a
  ragged S (S % chunk != 0).  Float32 sums in other orders: within
  atol 1e-5 (1e-4 for the chunked SSD, whose cumulative sums feed exps;
  the step tests include bfloat16 inputs, upcast on both sides);
  ``ssd_step`` within a tolerance too, not bitwise (the reference's own
  bitwise test of it fails on some machines).
- Models: prefill, decode_step and extend_step (n_valid 0 .. ck) of the
  RWKV6, Mamba2 and Zamba2-hybrid smoke configs, weights carried by
  ``convert.from_jax_tree``, with ``ssm.chunk`` 0 and a chunk shorter
  than the prompt: logits and every cache entry within atol 1e-4.
- Random init (the reference's distribution, seeded), configs as copies,
  and the refusals (paged cache, hybrid extend, unknown families).
The reference models are built once per module and shared by the tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.kernels import ref as JR
from repro.kernels import ssd as JSSD
from repro.kernels import wkv as JWKV
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import RWKV6_3B, ZAMBA2_1_2B
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

torch.set_num_threads(1)

ATOL = 1e-4


def port_cfg(cfg):
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(ModelConfig)}
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(**dataclasses.asdict(cfg.ssm))
    return ModelConfig(**kw)


def with_chunk(cfg, chunk):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=chunk))


# the reference's model functions, jitted once per config (eager calls
# compile every small op of the hybrid's per-site loop separately)
J_PREFILL = jax.jit(JM.prefill, static_argnums=(1, 3))
J_DECODE = jax.jit(JM.decode_step, static_argnums=1)
J_EXTEND = jax.jit(JS.extend_step, static_argnums=1)

_ZAMBA = get_smoke_config("zamba2-1.2b", vocab=96)
FAMILIES = {
    "rwkv6": get_smoke_config("rwkv6-3b", vocab=96),
    "mamba2": dataclasses.replace(_ZAMBA, arch_type="ssm",
                                  name="mamba2-smoke"),
    "hybrid": _ZAMBA,
}


def test_configs_are_copies():
    for name, port in (("rwkv6-3b", RWKV6_3B), ("zamba2-1.2b", ZAMBA2_1_2B)):
        assert port_cfg(get_config(name)) == port, name
        assert port.ssm.chunk == 0


# ---------------------------------------------------------------------------
# Plain versions of the four kernels
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B, S, H, hd, step=False):
    rng = np.random.default_rng(seed)
    lead = (B, H, hd) if step else (B, S, H, hd)
    r, k, v = (rng.normal(size=lead).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2, 1, size=lead))).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, hd))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


def _ssd_inputs(seed, B, S, H, hd, N, step=False):
    rng = np.random.default_rng(seed)
    lead = (B,) if step else (B, S)
    la = -np.log1p(np.exp(rng.normal(size=lead + (H,)))).astype(np.float32)
    dtx = rng.normal(size=lead + (H, hd)).astype(np.float32)
    Bf, Cf = (rng.normal(size=lead + (N,)).astype(np.float32)
              for _ in range(2))
    h0 = (0.1 * rng.normal(size=(B, H, hd, N))).astype(np.float32)
    return la, dtx, Bf, Cf, h0


def _close(got, want, atol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("S,blk", [(13, 4), (8, 8), (5, 16)])
def test_wkv_plain_version_matches_reference(S, blk):
    args = _wkv_inputs(S, 2, S, 3, 8)
    got = ops.wkv(*map(torch.from_numpy, args))        # CPU: ref.wkv_ref
    jargs = [jnp.asarray(a) for a in args]
    _close(got, JWKV.wkv_kernel(*jargs, s_block=blk, interpret=True), 1e-5)
    _close(got, JWKV.wkv_ref(*jargs), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_step_plain_version_matches_reference(dtype):
    r, k, v, w, u, s0 = _wkv_inputs(3, 3, 1, 2, 16, step=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (r, k, v)] + [
        jnp.asarray(w), jnp.asarray(u, jd), jnp.asarray(s0)]
    targs = [torch.from_numpy(a).to(td) for a in (r, k, v)] + [
        torch.from_numpy(w), torch.from_numpy(u).to(td),
        torch.from_numpy(s0)]
    got = ops.wkv_step(*targs)
    _close(got, JWKV.wkv_step_kernel(*jargs, interpret=True), 1e-5)
    _close(got, JR.wkv_step_ref(*jargs), 1e-5)


@pytest.mark.parametrize("S,chunk", [(13, 4), (16, 8), (37, 16)])
def test_ssd_chunked_plain_version_matches_reference(S, chunk):
    args = _ssd_inputs(S + chunk, 2, S, 2, 8, 4)
    got = ops.ssd(*map(torch.from_numpy, args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, JSSD.ssd_kernel(*jargs, chunk=chunk, interpret=True), 1e-4)
    # the model's own chunked scan, on the identity-padded sequence
    pad = (-S) % chunk
    la, dtx, Bf, Cf, h0 = jargs
    padded = [jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (la, dtx, Bf, Cf)]
    y, h = JS._ssd_chunked_scan(*padded, h0, chunk)
    _close(got, (y[:, :S], h), 1e-4)
    # and the per-timestep recurrence computes the same function
    _close(got, JSSD.ssd_ref(*jargs), 1e-4)
    _close(ops.ssd_scan(*map(torch.from_numpy, args)), JSSD.ssd_ref(*jargs),
           1e-5)


@pytest.mark.parametrize("B,H,hd,N", [(1, 2, 4, 4), (3, 1, 8, 4),
                                      (2, 3, 16, 8)])
def test_ssd_step_plain_version_matches_reference(B, H, hd, N):
    args = _ssd_inputs(B + N, B, 1, H, hd, N, step=True)
    got = ops.ssd_step(*map(torch.from_numpy, args))
    jargs = [jnp.asarray(a) for a in args]
    _close(got, JSSD.ssd_step_kernel(*jargs, interpret=True), 1e-5)
    _close(got, JR.ssd_step_ref(*jargs), 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_ssd_scan_state_is_a_loop_of_steps(S, dtype):
    """The identity the card's one-launch scan rests on: the per-timestep
    plain version's final state is S applications of the step's plain
    version, bit for bit (the same rounded operations), and its y is
    within ref.ssd_tol(..., chunk=0) of the steps' y (another order of the
    sum over N).  The reference's own loop of steps agrees within 1e-5."""
    la, dtx, Bf, Cf, h0 = map(torch.from_numpy,
                              _ssd_inputs(S, 2, S, 3, 8, 12))
    dtx, Bf, Cf = (a.to(dtype) for a in (dtx, Bf, Cf))
    y, h = ref.ssd_ref(la, dtx, Bf, Cf, h0)
    hs, ys = h0, []
    for t in range(S):
        yt, hs = ref.ssd_step_ref(la[:, t], dtx[:, t], Bf[:, t], Cf[:, t],
                                  hs)
        ys.append(yt)
    assert torch.equal(h, hs)
    ys = torch.stack(ys, 1)
    tol_y, _ = ref.ssd_tol(la, dtx, Bf, Cf, h0, chunk=0)
    assert bool(((y - ys).abs() <= tol_y).all())
    jh = jnp.asarray(h0.numpy())
    for t in range(S):
        _, jh = JR.ssd_step_ref(*(jnp.asarray(a[:, t].float().numpy())
                                  for a in (la, dtx, Bf, Cf)), jh)
    _close((h,), (jh,), 1e-5)


def test_tolerances_hold_the_plain_versions():
    """The bounds chip_smoke holds the kernels to (ref.wkv_tol /
    ref.ssd_tol) cover the reference's own Pallas programs against the
    port's plain versions, whose sums run in other orders."""
    args = _wkv_inputs(1, 2, 13, 3, 8)
    targs = list(map(torch.from_numpy, args))
    want = JWKV.wkv_kernel(*map(jnp.asarray, args), s_block=4,
                           interpret=True)
    for g, w, tol in zip(ref.wkv_ref(*targs), want, ref.wkv_tol(*targs)):
        assert bool(((g - torch.from_numpy(np.array(w))).abs()
                     <= tol).all())
    args = _ssd_inputs(2, 2, 13, 2, 8, 4)
    targs = list(map(torch.from_numpy, args))
    want = JSSD.ssd_kernel(*map(jnp.asarray, args), chunk=4, interpret=True)
    for g, w, tol in zip(ref.ssd_chunked_ref(*targs, 4), want,
                         ref.ssd_tol(*targs, chunk=4)):
        assert bool(((g - torch.from_numpy(np.array(w))).abs()
                     <= tol).all())


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """Each family's reference params (key 3) and the port's model holding
    them, built once for the module; the chunk variants share weights."""
    out = {}
    init = jax.jit(JM.init_params, static_argnums=1)
    for name, cfg in FAMILIES.items():
        params = init(jax.random.key(3), cfg)
        tree = jax.tree.map(np.asarray, params)
        for chunk in (0, 4):
            c = with_chunk(cfg, chunk)
            out[name, chunk] = (c, params, convert.from_jax_tree(
                tree, port_cfg(c), device="cpu"))
    return out


def _cache_close(jc, tc, keys=None):
    for k, v in tc.items():
        if k == "pos" or (keys is not None and k not in keys):
            continue
        np.testing.assert_allclose(v.float().numpy(),
                                   np.asarray(jc[k], np.float32), rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_and_decode_match_reference(models, family, chunk):
    cfg, params, model = models[family, chunk]
    B, S, max_seq = 2, 10, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jc = J_PREFILL(params, cfg, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = model.prefill(torch.as_tensor(toks, dtype=torch.int64), max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc["pos"].tolist() == [S] * B
    _cache_close(jc, tc)
    jc = dict(jc, pos=jnp.full((B,), S, jnp.int32))
    for t in range(3):
        tok = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
        jl, jc = J_DECODE(params, cfg, jnp.asarray(tok), jc)
        tl, tc = model.decode_step(torch.as_tensor(tok, dtype=torch.int64),
                                   tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"step {t}")
        _cache_close(jc, tc)
    assert tc["pos"].tolist() == [S + 3] * B


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("family", ["rwkv6", "mamba2"])
def test_extend_step_matches_reference(models, family, chunk):
    """Two chunked continuations from a prefilled cache, with per-row
    n_valid (a full chunk, a ragged one, and 0 on one row)."""
    cfg, params, model = models[family, chunk]
    B, S, ck = 3, 6, 5
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    _, jc = J_PREFILL(params, cfg, {"tokens": jnp.asarray(toks)}, 24)
    jc = dict(jc, pos=jnp.full((B,), S, jnp.int32))
    _, tc = model.prefill(torch.as_tensor(toks, dtype=torch.int64), 24)
    for n_valid in ([ck, ck, ck], [ck, 3, 0]):
        chunk_toks = rng.integers(0, cfg.vocab, (B, ck)).astype(np.int32)
        nv = np.asarray(n_valid, np.int32)
        jl, jc = J_EXTEND(params, cfg, jnp.asarray(chunk_toks), jc,
                          jnp.asarray(nv))
        tl, tc = model.extend_step(
            torch.as_tensor(chunk_toks, dtype=torch.int64), tc,
            n_valid=torch.as_tensor(nv))
        for b, n in enumerate(n_valid):      # rows past n_valid: padding
            np.testing.assert_allclose(tl[b, :n].numpy(),
                                       np.asarray(jl)[b, :n], atol=ATOL)
        _cache_close(jc, tc)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_extend_of_a_split_prompt_equals_prefill(models):
    """An RWKV6 prompt admitted as chunks with a padded tail lands the
    prefill's state (the chunk path's identity mask)."""
    cfg, _, model = models["rwkv6", 4]
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 9)), dtype=torch.int64)
    lp, want = model.prefill(toks, 16)
    cache = model.init_cache(1, 16)
    for start in range(0, 9, 4):
        chunk = torch.zeros((1, 4), dtype=torch.int64)
        n = min(4, 9 - start)
        chunk[0, :n] = toks[0, start:start + n]
        lc, cache = model.extend_step(chunk, cache, n_valid=n)
    np.testing.assert_allclose(lc[0, n - 1].numpy(), lp[0, -1].numpy(),
                               atol=ATOL)
    for k in ("wkv", "att_shift", "ffn_shift"):
        np.testing.assert_allclose(cache[k].numpy(), want[k].numpy(),
                                   atol=ATOL, err_msg=k)


def test_hybrid_extend_and_paged_cache_refused(models):
    _, _, hybrid = models["hybrid", 0]
    with pytest.raises(NotImplementedError, match="hybrid"):
        hybrid.extend_step(torch.zeros((1, 4), dtype=torch.int64),
                           hybrid.init_cache(1, 8))
    _, _, rwkv = models["rwkv6", 0]
    with pytest.raises(ValueError, match="(?s)recurrent.*drafter"):
        TM.init_paged_cache(rwkv, 2, 8, 4, 4)


def test_random_init_follows_the_reference_distribution():
    cfg = port_cfg(FAMILIES["rwkv6"])
    m1 = TM.init_params(cfg, seed=5, device="cpu")
    m2 = TM.init_params(cfg, seed=5, device="cpu")
    assert isinstance(m1, TS.RecurrentLM)
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    blk = m1.blocks
    assert bool((blk["w_base"] == -6).all() and (blk["mu"] == 0.5).all())
    assert abs(float(blk["lora_b"].std()) - 0.01) < 2e-3
    d = cfg.d_model
    assert abs(float(blk["w_r"].std()) - d ** -0.5) < 0.1 * d ** -0.5
    hyb = TM.init_params(port_cfg(FAMILIES["hybrid"]), seed=5, device="cpu")
    assert abs(float(hyb.blocks["conv_w"].std()) - 0.5) < 0.05
    assert bool((hyb.blocks["a_log"] == 0).all()
                and (hyb.blocks["d_skip"] == 1).all())
    assert tuple(hyb.shared["ln_attn"].shape) == (TS.n_sites(hyb.cfg), d)
    assert "w_gate" not in hyb.shared
    # the attention families are ported: an MoE arch builds a Transformer
    # (here without experts, as the reference's init does when moe is
    # None); an unknown arch still raises
    moe = TM.init_params(dataclasses.replace(cfg, arch_type="moe", ssm=None),
                         device="cpu")
    assert not isinstance(moe, TS.RecurrentLM)
    with pytest.raises(ValueError):
        TM.init_params(dataclasses.replace(cfg, arch_type="nope", ssm=None),
                       device="cpu")


def test_site_schedule_matches_reference():
    for cfg in (FAMILIES["hybrid"], get_config("zamba2-1.2b"),
                dataclasses.replace(FAMILIES["hybrid"], n_layers=1),
                dataclasses.replace(FAMILIES["hybrid"], n_layers=5)):
        want = [-1] * cfg.n_layers
        li = 0
        for site in range(JS.n_sites(cfg)):       # the reference's loop
            li = min(li + cfg.hybrid_attn_every, cfg.n_layers)
            want[li - 1] = site
        assert TS.sites_after(port_cfg(cfg)) == want
