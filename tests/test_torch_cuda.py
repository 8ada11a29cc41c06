"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in test_torch_kernels.py: integers exact, race tokens equal
outside margin rows (best two scores within 1e-5 relative), tournament
distributions (the keyed and the unkeyed tournament) within rtol=1e-4,
atol=1e-7 (another order of float sums over up to 256128 entries and 30
rounds).  Paged attention: float32
within 1e-5 (another order of float sums); bfloat16 within
ref.paged_attention_tol, per element: two bf16 ulps of the element plus
two flips of the row's worst score or probability rounding (another sum
order may round a score, a probability or the output one ulp the other
way); with a sliding window the bf16 bound is the same, and a row alone
equals its batch bit for bit.  The recurrent kernels (wkv, wkv_step, ssd,
ssd_step and its
per-timestep scan): every output, y and the state, within ref.wkv_tol /
ref.ssd_tol, chip_smoke.py's bound (twice γ_D times the output's
envelope, the plain version run on absolute values); the WKV state equal
to ref.wkv_ref's, the scan equal to a loop of steps, and a row of ssd, wkv
and the fused tail's tournament alone equal to it in a batch, bit for
bit.  Training: the differentiable recurrences' gradients (``ops.Replay``:
the kernel forward, the plain version replayed backward) against autograd
straight through the plain version, within ref.replay_grad_tol; 3 fit
steps of a smoke Zamba2 (ssm.chunk 8) on the card against the CPU, each
loss within rtol 1e-4 (AdamW's g / (|g| + eps) turns the last bits of a
gradient near 0 into a visible step; the CPU parity test holds the same).
Serving: overlap on equals overlap off bit for bit, one device_get a
sync round; olmoe's smoke pair (MoE target and draft) gives the CPU's
tokens on the card, through generate and paged serve_requests."""
import numpy as np
import pytest
import torch

from repro_torch.core.watermark.base import FusedTail
from repro_torch.kernels import ops, ref

MARGIN = 1e-5
TAILS = [("race", 0, False), ("tournament", 30, False),
         ("tournament", 30, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, K, V, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.randn((B, K + 1, V), generator=g, device=dev) * 3
    p = torch.softmax(lp, -1)
    q = torch.softmax(lp[:, :K] + torch.randn((B, K, V), generator=g,
                                              device=dev), -1)
    toks = torch.multinomial(q.reshape(B * K, V), 1, generator=g).reshape(B, K)
    u = torch.rand((B, K), generator=g, device=dev)
    u[0] = 0.0
    keys = torch.randint(0, 2**32, (B,), generator=g, device=dev)
    ctx = torch.randint(0, 2**32, (B, K + 1), generator=g, device=dev)
    seen = torch.rand((B, K + 1), generator=g, device=dev) < 0.3
    seen[1] = True
    live = torch.ones(B, dtype=torch.bool, device=dev)
    live[2] = False
    return p, q, toks, u, keys, ctx, seen, live


@pytest.mark.gpu
@pytest.mark.parametrize("V", [32000, 256128])
def test_kernels_match_plain_versions(cuda, V):
    B = 4
    g = torch.Generator(device=cuda).manual_seed(V)
    probs = torch.softmax(torch.randn((B, V), generator=g, device=cuda) * 3,
                          -1)
    probs[3] = 0.0
    seeds = torch.randint(0, 2**32, (B,), generator=g, device=cuda)
    ops.reset_launches()
    tk, uk = ops.gumbel_argmax(probs, seeds)
    tr, ur = ref.gumbel_argmax_ref(probs, seeds)
    marg = ref.margin(ref.race_scores(probs, seeds)[0])
    assert bool(((tk == tr) | (marg < MARGIN)).all())
    assert int(tk[3]) == 0
    assert torch.equal(uk[tk == tr], ur[tk == tr])
    dk, ak = ops.tournament_keyed(probs[:3], seeds[:3], seeds[:3],
                                  stream=0xD0, m=30)
    dr, ar = ref.tournament_keyed_ref(probs[:3], seeds[:3], seeds[:3],
                                      stream=0xD0, m=30)
    torch.testing.assert_close(dk, dr, rtol=1e-4, atol=1e-7)
    assert bool(((ak == ar) | (ref.margin(dr) < MARGIN)).all())
    args = _inputs(B, 4, V, cuda, seed=V)
    for kind, m, degenerate in TAILS:
        tail = FusedTail(kind=kind, m=m, stat_dim=m or 1,
                         degenerate=degenerate)
        nk, pk, tk, sk = ops.spec_verify_wm(*args, tail=tail)
        nr, pr, tr, sr = ref.spec_verify_wm_ref(
            *args, streams=ops.DEFAULT_STREAMS, kind=kind, m=m,
            degenerate=degenerate)
        assert torch.equal(nk, nr) and torch.equal(pk, pr)
        same = tk == tr
        assert torch.equal(sk[same], sr[same])
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"spec_verify_wm": 1,
                            "spec_verify_wm_tournament": 2,
                            "gumbel_argmax": 1,
                            "tournament_keyed": 1, "paged_attention": 0,
                            "wkv": 0, "wkv_step": 0, "ssd": 0,
                            "ssd_scalar": 0, "ssd_step": 0,
                            "tournament": 0, "spec_verify": 0}


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    probs = torch.rand((2, 64), device=cuda)
    seeds = torch.arange(2, device=cuda)
    with pytest.raises(TypeError):
        ops.gumbel_argmax(probs.double(), seeds)
    with pytest.raises(ValueError):
        ops.gumbel_argmax(probs, seeds.cpu())
    with pytest.raises(TypeError):
        ops.tournament_keyed(probs, seeds.int(), seeds, stream=1, m=2)
    # paged attention: a pool off the 16-byte grid, a head size past 256
    # and one that is no multiple of 8 (any page size is taken)
    q = torch.zeros((1, 1, 2, 128), device=cuda)
    table = torch.ones((1, 1), dtype=torch.int64, device=cuda)
    pos = torch.ones(1, dtype=torch.int64, device=cuda)
    odd = torch.zeros(2 * 16 * 2 * 128 + 1, device=cuda)[1:].view(
        2, 16, 2, 128)
    with pytest.raises(ValueError):
        ops.paged_attention(q, odd, odd, table, pos)
    for hd in (260, 100):
        pool = torch.zeros((2, 16, 2, hd), device=cuda)
        with pytest.raises(ValueError):
            ops.paged_attention(torch.zeros((1, 1, 2, hd), device=cuda),
                                pool, pool, table, pos)


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda):
    """The TINY pair in fp32: the kernel path on the card gives the plain
    path's tokens (rows parting at a near-tie are explained and counted)."""
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.models.model import init_params
    from repro_torch.serve import divergence
    from repro_torch.serve import engine as E
    cpu = [init_params(c, seed=s, device="cpu")
           for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    gpu = [init_params(c, seed=s, device="cpu").to(cuda)
           for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    prompts = np.random.default_rng(0).integers(1, 256, size=(3, 8))
    scfg = E.SpecConfig(K=3, watermark="synthid", m=30)
    rc = E.generate(*cpu, scfg, prompts, n_tokens=24, key=5)
    rg = E.generate(*gpu, scfg, prompts, n_tokens=24, key=5)
    for b in range(3):
        j = divergence.first_divergence(rc, rg, b)
        if j is not None:
            assert divergence.decision_margin(*cpu, scfg, prompts[b], rc, b,
                                              j) < MARGIN


def _paged_inputs(B, Sq, H, Hkv, hd, ps, max_pages, pos, dtype, dev, seed):
    """q, shuffled k/v pools and page tables whose live pages cover pos[b]
    + Sq - 1 positions and whose tails point at the null page; the last
    row is a FREE slot (all-null table) attending kv 0 only."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * max_pages + 3
    q = torch.randn((B, Sq, H, hd), generator=g).to(dev, dtype)
    k = torch.randn((P, ps, Hkv, hd), generator=g).to(dev, dtype)
    v = torch.randn((P, ps, Hkv, hd), generator=g).to(dev, dtype)
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros((B, max_pages), dtype=torch.int64)
    pos = torch.as_tensor(pos, dtype=torch.int64)
    for b in range(B - 1):
        n = -(-(int(pos[b]) + Sq - 1) // ps)
        table[b, :n] = perm[b * max_pages:b * max_pages + n]
    pos[B - 1] = 1
    return q, k, v, table.to(dev), pos.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,H,Hkv,hd,ps,max_pages,pos", [
    (4, 5, 4, 2, 64, 16, 64, [17, 40, 3, 0]),      # the TINY pair's GQA
    (3, 5, 32, 32, 128, 16, 64, [100, 977, 0]),    # target verify
    (2, 32, 12, 12, 64, 16, 64, [1, 0]),           # a prefill chunk
    (3, 5, 4, 2, 64, 1, 256, [100, 7, 0]),         # one position a page
    (3, 5, 64, 8, 112, 12, 90, [500, 977, 0]),     # kimi-like GQA, hd 112
    (3, 5, 16, 16, 256, 48, 22, [300, 1000, 0]),   # gemma-like, hd 256
    (2, 5, 8, 8, 192, 64, 16, [900, 0]),           # hd 192, page 64
    (3, 5, 96, 8, 192, 16, 64, [600, 977, 0]),     # nemotron-like GQA
    (2, 1, 8, 8, 128, 16, 260, [4096, 0]),         # a 4096-position row
    (2, 1, 4, 4, 64, 16, 600, [9000, 0])])         # past 32 staged chunks
def test_paged_attention_matches_plain_version(cuda, dtype, B, Sq, H, Hkv,
                                               hd, ps, max_pages, pos):
    """Every case's last row is a FREE slot; the 4096-position row passes
    the kernel's kept scores (1024 positions), so pass two recomputes
    its later scores; the 9000-position row also passes its staged pages
    (8192 positions), so later copies read the table themselves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _paged_inputs(B, Sq, H, Hkv, hd, ps, max_pages, pos, dtype, cuda,
                         seed=Sq * H + ps)
    ops.reset_launches()
    out = ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    want = ref.paged_attention_ref(*args)
    assert out.dtype == dtype and out.shape == want.shape

    def close(out, want, args):
        tol = (1e-5 if dtype == torch.float32
               else ref.paged_attention_tol(*args, want))
        diff = (out.float() - want.float()).abs()
        assert bool((diff <= tol).all()), float(diff.max())

    close(out, want, args)
    # a row with no valid position averages the whole extent, as the
    # plain version does
    q, k, v, table, p = args
    p = p.clone()
    p[0] = 0
    args = (q, k, v, table, p)
    close(ops.paged_attention(*args), ref.paged_attention_ref(*args), args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,H,Hkv,hd", [(5, 32, 32, 128), (1, 12, 12, 64),
                                         (5, 64, 8, 112)])
def test_paged_attention_row_alone_equals_batched(cuda, dtype, Sq, H, Hkv,
                                                  hd):
    """A slot's output does not depend on the batch around it: its rows
    alone (B=1) equal the same rows inside a batch of 8, bit for bit."""
    args = _paged_inputs(8, Sq, H, Hkv, hd, 16, 80,
                         [1000, 17, 500, 3, 1200, 64, 900, 0], dtype, cuda,
                         seed=hd)
    batched = ops.paged_attention(*args)
    q, k, v, table, pos = args
    for b in (0, 3, 7):
        alone = ops.paged_attention(q[b:b + 1], k, v, table[b:b + 1],
                                    pos[b:b + 1])
        assert torch.equal(alone[0], batched[b]), b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,H,Hkv,hd,ps,max_pages,pos,window", [
    (3, 5, 32, 4, 128, 16, 300, [4600, 4100, 0], 4096),   # yi-6b-swa4k verify
    (2, 32, 8, 4, 64, 16, 80, [900, 0], 8),                # rows with no key
    (3, 5, 4, 2, 64, 4, 16, [3, 40, 0], 8),               # start clamped at 0
    (2, 1, 8, 8, 128, 16, 40, [639, 0], 100)])             # decode at the end
def test_paged_attention_window_matches_plain_version(
        cuda, dtype, B, Sq, H, Hkv, hd, ps, max_pages, pos, window):
    """The windowed kernel against the windowed plain version (bf16 within
    ``paged_attention_tol(window=)``, fp32 within 1e-5), one launch; each
    row alone equals its batch bit for bit."""
    args = _paged_inputs(B, Sq, H, Hkv, hd, ps, max_pages, pos, dtype, cuda,
                         seed=window + Sq)
    ops.reset_launches()
    out = ops.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 1
    want = ref.paged_attention_ref(*args, window=window)
    tol = (1e-5 if dtype == torch.float32
           else ref.paged_attention_tol(*args, want, window=window))
    diff = (out.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float(diff.max())
    q, k, v, table, p = args
    for b in range(B):
        alone = ops.paged_attention(q[b:b + 1], k, v, table[b:b + 1],
                                    p[b:b + 1], window=window)
        assert torch.equal(alone[0], out[b]), b


@pytest.mark.gpu
def test_olmoe_generate_on_card_matches_cpu(cuda):
    """olmoe's smoke pair (MoE target and draft) in fp32 through ``generate``
    and paged ``serve_requests``: the card gives the CPU's tokens (rows
    parting at a near-tie are explained and counted)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import divergence
    from repro_torch.serve import engine as E
    from repro_torch.serve.config import ServeConfig
    cfgs = (get_smoke_config("olmoe-1b-7b", vocab=256),
            get_smoke_config("olmoe-1b-7b", vocab=256, n_layers=1,
                             d_model=64, d_ff=128, n_heads=2, n_kv_heads=2,
                             head_dim=32))
    cpu = [init_params(c, seed=s, device="cpu") for c, s in zip(cfgs, (3, 4))]
    gpu = [init_params(c, seed=s, device="cpu").to(cuda)
           for c, s in zip(cfgs, (3, 4))]
    prompts = np.random.default_rng(0).integers(1, 256, size=(3, 8))
    scfg = E.SpecConfig(K=3, watermark="gumbel")
    rc = E.generate(*cpu, scfg, prompts, n_tokens=16, key=5)
    ops.reset_launches()
    rg = E.generate(*gpu, scfg, prompts, n_tokens=16, key=5)
    assert ops.LAUNCHES["spec_verify_wm"] > 0
    for b in range(3):
        j = divergence.first_divergence(rc, rg, b)
        if j is not None:
            assert divergence.decision_margin(*cpu, scfg, prompts[b], rc, b,
                                              j) < MARGIN
    reqs = [(p, 8) for p in prompts]
    conf = ServeConfig(batch=2, key=5, page_size=4, num_pages=40,
                       prefill_chunk=4, sync_every=2)
    ops.reset_launches()
    sg = E.serve_requests(*gpu, scfg, reqs, config=conf)
    assert ops.LAUNCHES["paged_attention"] > 0
    sc = E.serve_requests(*cpu, scfg, reqs, config=conf)
    for a, b2, (p, _) in zip(sc, sg, reqs):
        ra, rb = a.as_generation_result(), b2.as_generation_result()
        j = divergence.first_divergence(ra, rb, 0)
        if j is not None:
            assert divergence.decision_margin(*cpu, scfg, p, ra, 0,
                                              j) < MARGIN


def _tournament_inputs(B, V, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    probs = torch.softmax(torch.randn((B, V), generator=g, device=dev) * 3,
                          -1)
    keys = torch.randint(0, 2**32, (B,), generator=g, device=dev)
    ctx = torch.randint(0, 2**32, (B,), generator=g, device=dev)
    return probs, keys, ctx


@pytest.mark.gpu
@pytest.mark.parametrize("V", [96, 32000, 256128])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_tournament_keyed_matches_plain_version(cuda, B, V):
    """The cluster tournament against its plain version: the distribution
    within rtol=1e-4, atol=1e-7, the argmax equal outside margin rows;
    fewer rounds or another context is far outside that tolerance."""
    probs, keys, ctx = _tournament_inputs(B, V, cuda, seed=B * V)
    ops.reset_launches()
    dk, ak = ops.tournament_keyed(probs, keys, ctx, stream=0xD0, m=30)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tournament_keyed"] == 1
    dr, ar = ref.tournament_keyed_ref(probs, keys, ctx, stream=0xD0, m=30)
    torch.testing.assert_close(dk, dr, rtol=1e-4, atol=1e-7)
    assert bool(((ak == ar) | (ref.margin(dr) < MARGIN)).all())
    for bad in (ref.tournament_keyed_ref(probs, keys, ctx, stream=0xD0,
                                         m=29)[0],
                ref.tournament_keyed_ref(probs, keys, ctx ^ 1,
                                         stream=0xD0, m=30)[0]):
        assert V < 4096 or not torch.allclose(dk, bad, rtol=1e-4,
                                              atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [96, 32000, 256128])
def test_tournament_keyed_row_alone_equals_batched(cuda, V):
    """A row's rounds do not depend on B: alone equals in a batch of 8,
    distribution and argmax bit for bit."""
    probs, keys, ctx = _tournament_inputs(8, V, cuda, seed=V + 1)
    db, ab = ops.tournament_keyed(probs, keys, ctx, stream=0xD0, m=30)
    for b in (0, 5):
        da, aa = ops.tournament_keyed(probs[b:b + 1], keys[b:b + 1],
                                      ctx[b:b + 1], stream=0xD0, m=30)
        assert torch.equal(da[0], db[b]) and int(aa[0]) == int(ab[b]), b


def _recurrent_inputs(kernel, shape, dtype, dev, seed):
    """As chip_smoke.rec_inputs, on the card: the model-type inputs (r, k,
    v, u; dtx, B, C) in ``dtype``, decays, la and the state float32."""
    import torch.nn.functional as F
    g = torch.Generator(device="cpu").manual_seed(seed)

    def n(*sh, std=1.0, mean=0.0):
        return torch.randn(sh, generator=g) * std + mean

    B = shape[0]
    if kernel.startswith("wkv"):
        H, hd = shape[-2:]
        r, k, v = n(*shape), n(*shape), n(*shape)
        w = torch.exp(-torch.exp(n(*shape, mean=-2.0)))
        return (*(x.to(dev, dtype) for x in (r, k, v)), w.to(dev),
                n(H, hd, std=0.5).to(dev, dtype),
                n(B, H, hd, hd, std=0.1).to(dev))
    H, hd, N = shape[-3:]
    lead = shape[:-3]
    la = -F.softplus(n(*lead, H))
    dtx = F.softplus(n(*lead, H, 1)) * n(*lead, H, hd)
    return (la.to(dev), *(x.to(dev, dtype) for x in
                          (dtx, n(*lead, N), n(*lead, N))),
            n(B, H, hd, N, std=0.1).to(dev))


RECURRENT = {
    "wkv_step": (ops.wkv_step, ref.wkv_step_ref, ref.wkv_tol),
    "wkv": (ops.wkv, ref.wkv_ref, ref.wkv_tol),
    "ssd_step": (ops.ssd_step, ref.ssd_step_ref, ref.ssd_tol),
    "ssd": (lambda *a: ops.ssd(*a, chunk=16),
            lambda *a: ref.ssd_chunked_ref(*a, 16),
            lambda *a: ref.ssd_tol(*a, chunk=16)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", [
    ("wkv_step", (3, 5, 64)), ("wkv_step", (2, 3, 32)),
    ("wkv_step", (2, 3, 128)), ("wkv_step", (3, 2, 16)),
    ("wkv", (2, 37, 3, 64)), ("wkv", (1, 5, 2, 32)),
    ("wkv", (1, 37, 2, 128)), ("wkv", (2, 9, 3, 16)),
    ("ssd_step", (3, 5, 64, 64)), ("ssd_step", (2, 3, 16, 8)),
    ("ssd_step", (2, 3, 5, 6)), ("ssd_step", (1, 2, 8, 200)),
    ("ssd", (2, 37, 3, 64, 64)), ("ssd", (1, 16, 2, 16, 8)),
    ("ssd", (1, 5, 2, 32, 16))])
def test_recurrent_kernels_match_plain_versions(cuda, kernel, shape,
                                                dtype):
    """Each recurrent kernel, including ragged S (S % chunk != 0) and S
    under one chunk, against its plain version on the same inputs."""
    fn, plain, tolf = RECURRENT[kernel]
    args = _recurrent_inputs(kernel, shape, dtype, cuda, seed=sum(shape))
    ops.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == 1
    for out, want, tol in zip(got, plain(*args), tolf(*args)):
        assert out.dtype == torch.float32 and out.shape == want.shape
        assert bool(((out - want).abs() <= tol).all()), \
            float((out - want).abs().max())


@pytest.mark.gpu
def test_recurrent_wrappers_reject_what_the_kernels_do_not_take(cuda):
    r = torch.zeros((2, 3, 64), device=cuda)
    s0 = torch.zeros((2, 3, 64, 64), device=cuda)
    u = torch.zeros((3, 64), device=cuda)
    with pytest.raises(TypeError):               # half inputs
        ops.wkv_step(r.half(), r.half(), r.half(), r, u.half(), s0)
    with pytest.raises(TypeError):               # a bf16 state
        ops.wkv_step(r, r, r, r, u, s0.bfloat16())
    with pytest.raises(ValueError):              # no 48-wide instantiation
        z = torch.zeros((2, 3, 48), device=cuda)
        ops.wkv_step(z, z, z, z, u[:, :48],
                     torch.zeros((2, 3, 48, 48), device=cuda))
    with pytest.raises(ValueError):              # a state of the wrong shape
        ops.wkv(r[:, None], r[:, None], r[:, None], r[:, None], u, s0[:1])
    la = torch.zeros((2, 3), device=cuda)
    bc = torch.zeros((2, 16), device=cuda)
    h0 = torch.zeros((2, 3, 64, 16), device=cuda)
    with pytest.raises(TypeError):               # la must be float32
        ops.ssd_step(la.bfloat16(), r, bc, bc, h0)
    with pytest.raises(ValueError):              # B of the wrong width
        ops.ssd_step(la, r, bc[:, :8], bc, h0)
    with pytest.raises(ValueError):              # N past the registers
        wide = torch.zeros((2, 1032), device=cuda)
        ops.ssd_step(la, r, wide, wide,
                     torch.zeros((2, 3, 64, 1032), device=cuda))
    with pytest.raises(ValueError):              # a chunk past shared memory
        ops.ssd(la[:, None].expand(2, 300, 3).contiguous(),
                torch.zeros((2, 300, 3, 256), device=cuda),
                torch.zeros((2, 300, 256), device=cuda),
                torch.zeros((2, 300, 256), device=cuda),
                torch.zeros((2, 3, 256, 256), device=cuda), chunk=256)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,hd,N", [(64, 64, 64), (3, 5, 6), (2, 16, 200)])
@pytest.mark.parametrize("S", [1, 7, 64])
def test_ssd_scan_equals_a_loop_of_steps(cuda, S, H, hd, N, dtype):
    """The per-timestep scan is one launch of the step kernel and gives,
    bit for bit, what S launches of ops.ssd_step give (y and the state);
    both are within ref.ssd_tol(..., chunk=0) of the plain version.  N=6
    and hd=5 take the kernel's unaligned copies, N=200 two column groups
    a lane."""
    args = _recurrent_inputs("ssd", (2, S, H, hd, N), dtype, cuda,
                             seed=S + N)
    ops.reset_launches()
    y, h = ops.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_step"] == 1 and sum(ops.LAUNCHES.values()) == 1
    la, dtx, Bf, Cf, h0 = args
    hs, ys = h0, []
    for t in range(S):
        yt, hs = ops.ssd_step(la[:, t], dtx[:, t], Bf[:, t], Cf[:, t], hs)
        ys.append(yt)
    assert torch.equal(h, hs) and torch.equal(y, torch.stack(ys, 1))
    for out, want, tol in zip((y, h), ref.ssd_ref(*args),
                              ref.ssd_tol(*args, chunk=0)):
        assert bool(((out - want).abs() <= tol).all()), \
            float((out - want).abs().max())


@pytest.mark.gpu
def test_ssd_step_state_off_the_16_byte_grid(cuda):
    """A state that is not 16-byte aligned (read element by element) gives
    what an aligned one gives, bit for bit."""
    la, dtx, Bf, Cf, h0 = _recurrent_inputs("ssd_step", (3, 4, 64, 64),
                                            torch.float32, cuda, seed=9)
    odd = torch.empty(h0.numel() + 1, device=cuda)[1:].view(h0.shape)
    odd.copy_(h0)
    y1, s1 = ops.ssd_step(la, dtx, Bf, Cf, h0)
    y2, s2 = ops.ssd_step(la, dtx, Bf, Cf, odd)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def _within(got, want, tols):
    for out, w, tol in zip(got, want, tols):
        assert out.dtype == torch.float32 and out.shape == w.shape
        assert bool(((out - w).abs() <= tol).all()), \
            float((out - w).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,N", [(64, 64), (16, 8), (32, 16), (5, 6)])
@pytest.mark.parametrize("S,chunk", [(129, 128), (300, 128), (128, 128),
                                     (37, 16)])
def test_ssd_chunks_and_widths(cuda, S, chunk, hd, N, dtype):
    """The chunked scan over several chunks with a ragged tail (S = 129,
    300 at chunk 128; 37 at 16), over exactly one chunk (S = 128), and at
    widths off the tensor-core tiles (hd=5, N=6 pad both; hd=16, N=8 and
    hd=32, N=16 fill them), one launch, within ref.ssd_tol."""
    args = _recurrent_inputs("ssd", (2, S, 3, hd, N), dtype, cuda,
                             seed=S + hd + N)
    ops.reset_launches()
    got = ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd"] == 1 and sum(ops.LAUNCHES.values()) == 1
    _within(got, ref.ssd_chunked_ref(*args, chunk),
            ref.ssd_tol(*args, chunk=chunk))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 300])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv_state_bit_for_bit(cuda, hd, S, dtype):
    """Every head size the kernel takes, S below, at and past one tile of
    16 timesteps and a long prompt: the state equals ref.wkv_ref's bit for
    bit (the same two roundings a timestep), y within ref.wkv_tol."""
    args = _recurrent_inputs("wkv", (2, S, 3, hd), dtype, cuda,
                             seed=S + hd)
    ops.reset_launches()
    y, s = ops.wkv(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wkv"] == 1 and sum(ops.LAUNCHES.values()) == 1
    want = ref.wkv_ref(*args)
    assert torch.equal(s, want[1])
    _within((y, s), want, ref.wkv_tol(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", [
    ("ssd", (4, 200, 3, 64, 64)), ("ssd", (4, 37, 2, 5, 6)),
    ("wkv", (4, 37, 3, 64)), ("wkv", (4, 20, 2, 128))])
def test_recurrent_row_alone_equals_batched(cuda, kernel, shape, dtype):
    """Each row of a B=4 batch run alone gives, bit for bit, what it gives
    in the batch (y and the state): no sum's order depends on B."""
    fn = {"ssd": lambda *a: ops.ssd(*a, chunk=128), "wkv": ops.wkv}[kernel]
    args = _recurrent_inputs(kernel, shape, dtype, cuda, seed=sum(shape))
    batch = fn(*args)
    # u is per head (no batch axis); every other input has one
    per_row = [i for i, a in enumerate(args)
               if not (kernel == "wkv" and i == 4)]
    for b in range(shape[0]):
        row = [a[b:b + 1].clone() if i in per_row else a
               for i, a in enumerate(args)]
        for alone, batched in zip(fn(*row), batch):
            assert torch.equal(alone, batched[b:b + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape", [("ssd", (2, 150, 3, 64, 64)),
                                          ("wkv", (2, 21, 3, 64)),
                                          ("wkv", (2, 53, 2, 128))])
def test_recurrent_inputs_off_the_16_byte_grid(cuda, kernel, shape, dtype):
    """Inputs whose bases are one element off the 16-byte grid (copied
    element by element; a bfloat16 one is not even on the 4-byte grid)
    give what aligned ones give, bit for bit.  S = 53 is four WKV tiles:
    a tile is fetched while the one before the next is walked."""
    fn = {"ssd": lambda *a: ops.ssd(*a, chunk=128), "wkv": ops.wkv}[kernel]
    args = _recurrent_inputs(kernel, shape, dtype, cuda, seed=5)

    def odd(t):
        o = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)[1:]
        return o.view(t.shape).copy_(t)
    for got, want in zip(fn(*(odd(a) for a in args)), fn(*args)):
        assert torch.equal(got, want)


TOURNAMENT_TAIL = FusedTail(kind="tournament", m=30, stat_dim=30)


@pytest.mark.gpu
@pytest.mark.parametrize("degenerate", [False, True])
@pytest.mark.parametrize("V", [96, 32000, 256128])
def test_spec_verify_wm_tournament_row_alone_equals_batched(cuda, V,
                                                            degenerate):
    """The tournament tail's rows do not depend on the batch around them:
    each row alone equals the same row in a batch of 8 (a bonus row, a
    seen row and a dead row among them), every output bit for bit."""
    args = _inputs(8, 4, V, cuda, seed=V + 3)
    tail = FusedTail(kind="tournament", m=30, stat_dim=30,
                     degenerate=degenerate)
    batched = ops.spec_verify_wm(*args, tail=tail)
    for b in range(8):
        alone = ops.spec_verify_wm(*(x[b:b + 1] for x in args), tail=tail)
        assert all(torch.equal(a[0], w[b]) for a, w in zip(alone, batched)), b


@pytest.mark.gpu
@pytest.mark.parametrize("V", [32000, 256128])
def test_spec_verify_wm_tournament_serving_batch_matches_plain(cuda, V):
    """The serving step's shape: 8 rows, every one live, no slot seen.
    n_acc and the prefix bitwise, the token equal outside margin rows, its
    g-bits equal on equal tokens."""
    p, q, toks, u, keys, ctx, seen, live = _inputs(8, 4, V, cuda, seed=V + 8)
    seen[:] = False
    live[:] = True
    args = (p, q, toks, u, keys, ctx, seen, live)
    ops.reset_launches()
    nk, pk, tk, sk = ops.spec_verify_wm(*args, tail=TOURNAMENT_TAIL)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spec_verify_wm_tournament"] == 1
    nr, pr, tr, sr = ref.spec_verify_wm_ref(
        *args, streams=ops.DEFAULT_STREAMS, kind="tournament", m=30)
    assert torch.equal(nk, nr) and torch.equal(pk, pr)
    r, _, wm_s, _, dw_s = ref.tail_rows(p, q, nr, keys, ctx, seen,
                                        streams=ops.DEFAULT_STREAMS)
    rn = r / torch.clamp_min(r.sum(-1, keepdim=True), ref.EPS)
    pz = ref.tournament_rounds(rn, wm_s, 30)
    marg = ref.margin(ref.race_scores(pz, dw_s)[0])
    same = tk == tr
    assert bool((same | (marg < MARGIN)).all())
    assert torch.equal(sk[same], sr[same])


@pytest.mark.gpu
@pytest.mark.parametrize("B,V", [(4, 32000), (8, 4096), (2048, 10),
                                 (2, 256128), (1, 32000), (16384, 32000)])
def test_tournament_matches_plain_version(cuda, B, V):
    g = torch.Generator(device=cuda).manual_seed(B + V)
    probs = torch.softmax(torch.randn((B, V), generator=g, device=cuda) * 3,
                          -1)
    seeds = torch.randint(0, 2**32, (B,), generator=g, device=cuda)
    ops.reset_launches()
    got = ops.tournament(probs, seeds, m=30)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tournament"] == 1
    want = ref.tournament_ref(probs, seeds, m=30)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-7)
    # fewer rounds or another seed row is far outside that tolerance (a
    # 10-entry row may have collapsed to a fixed point by round 29; a
    # single row has no other seed row to take)
    bad = [ref.tournament_ref(probs, seeds, m=29)]
    if B > 1:
        bad.append(ref.tournament_ref(probs, seeds.roll(1), m=30))
    for x in bad:
        assert V < 4096 or not torch.allclose(got, x, rtol=1e-4, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("V", [10, 96, 4096, 32000, 256128])
def test_tournament_launch_shapes_agree(cuda, V):
    """The same rows give the same floats at every B (the launch shape
    comes from V alone): the first rows of a batch run as batches of 1, 3,
    8 (a row a cluster) and 9 (4 rows a cluster, the last cluster part
    empty) equal it bit for bit, and one row expanded to (n, V) (read at
    row stride 0, not copied) equals its contiguous copy."""
    n = 2048 if V <= 32000 else 16
    g = torch.Generator(device=cuda).manual_seed(V + 7)
    probs = torch.softmax(torch.randn((n, V), generator=g, device=cuda) * 3,
                          -1)
    seeds = torch.randint(0, 2**32, (n,), generator=g, device=cuda)
    ops.reset_launches()
    batch = ops.tournament(probs, seeds, m=30)
    for B in (1, 3, 8, 9):
        assert torch.equal(ops.tournament(probs[:B], seeds[:B], m=30),
                           batch[:B]), B
    one = probs[5].expand(n, V)
    assert one.stride(0) == 0
    got = ops.tournament(one, seeds, m=30)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["tournament"] == 6
    assert torch.equal(got, ops.tournament(one.contiguous(), seeds, m=30))
    assert torch.equal(got[5], batch[5])


def _spec_verify_inputs(B, K, V, dev, seed):
    """p, q (B, K, V), drafts from q, coins (row 0 accepts every draft) and
    seed words; the last row (B >= 2) has p = q, so it accepts every draft
    and races an all-zero residual (token 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.randn((B, K, V), generator=g, device=dev) * 3
    p = torch.softmax(lp, -1)
    q = torch.softmax(lp + torch.randn((B, K, V), generator=g, device=dev),
                      -1)
    if B >= 2:
        p[-1] = q[-1]
    toks = torch.multinomial(q.reshape(B * K, V), 1,
                             generator=g).reshape(B, K)
    u = torch.rand((B, K), generator=g, device=dev)
    u[0] = 0.0                       # all accepted: slot K-1 still races
    seeds = torch.randint(0, 2**32, (B, K), generator=g, device=dev)
    return p, q, toks, u, seeds


@pytest.mark.gpu
@pytest.mark.parametrize("B,K,V", [(4, 4, 32000), (8, 4, 4096), (3, 1, 96),
                                   (1, 4, 32000), (64, 4, 32000),
                                   (4, 4, 256128), (4, 1, 32000)])
def test_spec_verify_matches_plain_version(cuda, B, K, V):
    """n_acc and the prefix bitwise, the token equal outside margin rows,
    U on equal tokens; a p = q row gives token 0; rows alone equal
    themselves in the batch, bit for bit."""
    p, q, toks, u, seeds = _spec_verify_inputs(B, K, V, cuda, B * K + V)
    ops.reset_launches()
    nk, pk, tk, uk = ops.spec_verify(p, q, toks, u, seeds)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spec_verify"] == 1
    nr, pr, tr, ur = ref.spec_verify_ref(p, q, toks, u, seeds)
    assert torch.equal(nk, nr) and torch.equal(pk, pr)
    assert int(nk[0]) == K
    rows = torch.arange(B, device=cuda)
    slot = nr.clamp_max(K - 1)
    r = (p[rows, slot] - q[rows, slot]).clamp_min(0.0)
    marg = ref.margin(ref.race_scores(r, seeds[rows, slot])[0])
    same = tk == tr
    assert bool((same | (marg < MARGIN)).all())
    assert torch.equal(uk[same], ur[same])
    if B >= 2:
        assert int(nk[-1]) == K and int(tk[-1]) == 0
    for b in sorted({0, B // 2, B - 1}):
        alone = ops.spec_verify(p[b:b + 1], q[b:b + 1], toks[b:b + 1],
                                u[b:b + 1], seeds[b:b + 1])
        assert all(torch.equal(x[0], w[b])
                   for x, w in zip(alone, (nk, pk, tk, uk))), b


@pytest.mark.gpu
@pytest.mark.parametrize("V", [10, 96, 4099, 32000, 256128])
def test_gumbel_argmax_launch_shapes_agree(cuda, V):
    """The same rows in batches of 1, 5, 8, 9 and 4096 (every launch
    shape ops.race_split picks at V > 1024, on both sides of each switch: a
    row over 16 blocks, over 8, and one block a row; V <= 1024 races in segments of a warp; V = 4099 puts
    every other row off the 16-byte grid) give the same token and U bit for
    bit, and the first 8 rows match the plain version (tokens outside
    margin rows, U on equal tokens)."""
    g = torch.Generator(device=cuda).manual_seed(V + 5)
    probs = torch.softmax(torch.randn((4096, V), generator=g, device=cuda)
                          * 3, -1)
    probs[3] = 0.0                   # an all-zero row: token 0
    seeds = torch.randint(0, 2**32, (4096,), generator=g, device=cuda)
    ops.reset_launches()
    tok, u = ops.gumbel_argmax(probs, seeds)
    for B in (1, 5, 8, 9):
        tb, ub = ops.gumbel_argmax(probs[:B], seeds[:B])
        assert torch.equal(tb, tok[:B]) and torch.equal(ub, u[:B]), B
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gumbel_argmax"] == 5
    assert int(tok[3]) == 0
    tr, ur = ref.gumbel_argmax_ref(probs[:8], seeds[:8])
    marg = ref.margin(ref.race_scores(probs[:8], seeds[:8])[0])
    same = tok[:8] == tr
    assert bool((same | (marg < MARGIN)).all())
    assert torch.equal(u[:8][same], ur[same])


@pytest.mark.gpu
@pytest.mark.parametrize("V", [96, 32000, 256128])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_spec_verify_wm_race_matches_plain_version(cuda, B, V):
    """The race tail, one row over a cluster: n_acc and the prefix
    bitwise, the token outside margin rows, U on equal tokens, dead rows
    zero (row 0 accepts every draft: the bonus slot; at B >= 4 row 1 is
    seen everywhere and row 2 dead), and each row alone equal to it in
    the batch, bit for bit."""
    args = [x[:B].contiguous() for x in _inputs(8, 4, V, cuda, seed=V + B)]
    p, q, toks, u, keys, ctx, seen, live = args
    ops.reset_launches()
    nk, pk, tk, uk = ops.spec_verify_wm(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spec_verify_wm"] == 1
    nr, pr, tr, ur = ref.spec_verify_wm_ref(
        *args, streams=ops.DEFAULT_STREAMS, kind="race", m=0)
    assert torch.equal(nk, nr) and torch.equal(pk, pr)
    r, seen_s, wm_s, pl_s, _ = ref.tail_rows(p, q, nr, keys, ctx, seen,
                                             streams=ops.DEFAULT_STREAMS)
    marg = ref.margin(ref.race_scores(r, torch.where(seen_s, pl_s,
                                                     wm_s))[0])
    same = tk == tr
    assert bool((same | ~live | (marg < MARGIN)).all())
    assert torch.equal(uk[same & live], ur[same & live])
    assert bool((tk[~live] == 0).all() and (nk[~live] == 0).all())
    for b in range(B):
        alone = ops.spec_verify_wm(*(x[b:b + 1] for x in args))
        assert all(torch.equal(a[0], w[b])
                   for a, w in zip(alone, (nk, pk, tk, uk))), b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk,hd,N", [(67, 67, 16, 348),
                                          (200, 81, 32, 250)])
def test_ssd_scalar_kernel_takes_what_the_tiled_cannot(cuda, S, chunk, hd,
                                                       N, dtype):
    """Chunks the tiled kernel's layout cannot hold and the scalar
    kernel's can (one chunk; three with a ragged tail) run the scalar
    kernel, one launch counted under ssd and under ssd_scalar, within ref.ssd_tol of the plain
    version, each row alone equal to it in the batch; a chunk the tiled
    layout holds at a wide state runs the tiled kernel, and one that
    neither holds is refused."""
    args = _recurrent_inputs("ssd", (2, S, 3, hd, N), dtype, cuda,
                             seed=S + hd + N)
    ops.reset_launches()
    got = ops.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {**{k: 0 for k in ops.LAUNCHES}, "ssd": 1,
                            "ssd_scalar": 1}
    _within(got, ref.ssd_chunked_ref(*args, chunk),
            ref.ssd_tol(*args, chunk=chunk))
    for b in range(2):
        alone = ops.ssd(*(a[b:b + 1] for a in args), chunk=chunk)
        assert all(torch.equal(x[0], w[b]) for x, w in zip(alone, got)), b
    assert ops.ssd_kernel_for(16, 256, 64) == "tiled"
    assert ops.ssd_kernel_for(32, 300, 80) is None
    wide = _recurrent_inputs("ssd", (1, 80, 2, 32, 300), dtype, cuda, seed=1)
    with pytest.raises(ValueError):
        ops.ssd(*wide, chunk=80)


def replay_grads(kernel, args, chunk):
    """Gradients of Σ y² + Σ state² through the Function (on the card the
    kernel's forward) and through the plain version it replays, and the
    bound on their difference (ref.replay_grad_tol)."""
    op = {"wkv": ops.wkv, "ssd_scan": ops.ssd_scan,
          "ssd": lambda *a: ops.ssd(*a, chunk=chunk)}[kernel]
    plain = ref.wkv_ref if kernel == "wkv" else ref.ssd_ref

    def grads(fn):
        xs = [a.clone().requires_grad_() for a in args]
        y, s = fn(*xs)
        return (y.detach(), s.detach()), torch.autograd.grad(
            (y ** 2).sum() + (s ** 2).sum(), xs)

    ops.reset_launches()
    outs, got = grads(op)
    launches = dict(ops.LAUNCHES)
    _, want = grads(plain)
    if kernel == "wkv":
        tols = ref.wkv_tol(*args)
    else:      # the chunked kernel against the per-timestep replay
        tols = [torch.maximum(a, b) for a, b in zip(
            ref.ssd_tol(*args, chunk=chunk), ref.ssd_tol(*args))]
    bound = ref.replay_grad_tol(kernel, args, outs, tols)
    return got, want, bound, launches


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,shape,chunk", [
    ("wkv", (2, 64, 4, 64), 0), ("wkv", (2, 33, 3, 32), 0),
    ("ssd", (2, 100, 4, 64, 64), 32), ("ssd", (2, 40, 3, 32, 16), 8),
    ("ssd_scan", (2, 40, 4, 32, 16), 0)])
def test_replay_gradients_match_plain_autograd(cuda, kernel, shape, chunk):
    args = _recurrent_inputs(kernel, shape, torch.float32, cuda,
                             seed=sum(shape))
    got, want, bound, launches = replay_grads(kernel, args, chunk)
    counted = {"wkv": "wkv", "ssd": "ssd", "ssd_scan": "ssd_step"}[kernel]
    assert launches[counted] == 1 and sum(launches.values()) == 1
    for i, (g, w, b) in enumerate(zip(got, want, bound)):
        assert bool(torch.isfinite(g).all()), i
        assert bool(((g - w).abs() <= b).all()), \
            (i, float(((g - w).abs() / b).max()))


@pytest.mark.gpu
def test_fit_on_the_card_matches_the_cpu(cuda):
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic
    from repro_torch.models.model import init_params
    from repro_torch.train import loop as TT
    cfg = get_smoke_config("zamba2-1.2b", vocab=synthetic.VOCAB)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=8))
    tree = convert.to_jax_tree(init_params(cfg, seed=3, device="cpu"))
    stream = synthetic.token_stream(synthetic.SyntheticCorpus(), 30)
    hist = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launches()
        _, hist[dev] = TT.fit(cfg, synthetic.batches(stream, 2, 32, seed=4),
                              steps=3, params=tree, device=dev,
                              verbose=False)
        if dev == "cuda":
            assert ops.LAUNCHES["ssd"] == 3 * cfg.n_layers
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_overlap_serving_changes_no_bit(cuda, monkeypatch, paged):
    """The double-buffered loop on the card: serving with overlap on
    equals overlap off bit for bit (paged: with a prefix cache and the
    doubled horizon), one ``device_get`` a sync round, and the snapshot's
    host copies land in pinned memory."""
    from repro_torch.configs import TINY_DRAFT, TINY_TARGET
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine as E
    from repro_torch.serve import scheduler as S
    from repro_torch.serve.config import ServeConfig
    models = [init_params(c, seed=s, device=cuda)
              for c, s in ((TINY_TARGET, 3), (TINY_DRAFT, 4))]
    rng = np.random.default_rng(2)
    system = rng.integers(1, 256, 9)
    reqs = [(np.concatenate([system if i % 2 else [], rng.integers(
        1, 256, int(rng.integers(3, 8)))]).astype(np.int32),
        int(rng.integers(4, 13))) for i in range(6)]
    real, gets = S.device_get, []

    def counted(handles):
        gets.append(all(t.is_pinned() for t in handles["flags"].values()))
        return real(handles)
    monkeypatch.setattr(S, "device_get", counted)
    kw = dict(page_size=4, num_pages=80, prefill_chunk=4,
              prefix_cache=True) if paged else {}
    out = []
    for overlap in (False, True):
        gets.clear()
        stats = {}
        out.append(E.serve_requests(
            *models, E.SpecConfig(K=3, watermark="synthid", m=12), reqs,
            config=ServeConfig(batch=2, key=7, sync_every=2,
                               overlap=overlap, **kw), stats_out=stats))
        assert len(gets) == stats["sync_rounds"] and all(gets)
    for a, b in zip(*out):
        for f in ("tokens", "src", "u", "ctx_hashes", "masked", "y_draft",
                  "y_target"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.gpu
def test_zero_row_calls_launch_nothing(cuda):
    """A rank of a sharded scheduler that holds no row of a slot makes the
    slot's model calls on zero rows (so that its weight gathers meet its
    peers'): the paged and recurrent wrappers return empty outputs of
    the right shapes and launch no kernel."""
    ops.reset_launches()
    f32 = dict(device=cuda, dtype=torch.float32)
    pool = torch.zeros((4, 16, 2, 64), **f32)
    out = ops.paged_attention(torch.zeros((0, 5, 4, 64), **f32), pool, pool,
                              torch.zeros((0, 8), dtype=torch.int64,
                                          device=cuda),
                              torch.zeros((0,), dtype=torch.int64,
                                          device=cuda))
    assert out.shape == (0, 5, 4, 64)
    x = torch.zeros((0, 7, 2, 64), **f32)
    y, s = ops.wkv(x, x, x, x, torch.zeros((2, 64), **f32),
                   torch.zeros((0, 2, 64, 64), **f32))
    assert y.shape == (0, 7, 2, 64) and s.shape == (0, 2, 64, 64)
    la, bc = torch.zeros((0, 200, 4), **f32), torch.zeros((0, 200, 16), **f32)
    h0 = torch.zeros((0, 4, 32, 16), **f32)
    dtx = torch.zeros((0, 200, 4, 32), **f32)
    for y, h in (ops.ssd(la, dtx, bc, bc, h0, chunk=128),
                 ops.ssd_scan(la, dtx, bc, bc, h0)):
        assert y.shape == (0, 200, 4, 32) and h.shape == (0, 4, 32, 16)
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES
