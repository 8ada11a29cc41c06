"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the reference
package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Tolerances as in test_torch_kernels.py: integers exact, race tokens equal
outside margin rows (best two scores within 1e-5 relative), tournament
distributions within rtol=1e-4, atol=1e-7 (another order of float sums
over up to 256128 entries and 30 rounds)."""
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
    assert ops.LAUNCHES == {"spec_verify_wm": 3, "gumbel_argmax": 1,
                            "tournament_keyed": 1}


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
