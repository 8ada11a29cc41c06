"""The port's serving launcher (``repro_torch.launch.serve``), the trained
pair of the examples (``repro_torch.train.pair``) and the examples
(``repro_torch.examples``), on the CPU at their smallest settings.

- The launcher's report equals a direct ``generate`` / ``serve_requests``
  of the same port models: the fixed-batch path, and a ``--requests``
  replay with streaming, overlap, the paged pool, the prefix cache, a key
  pool, an explicit key, a uid and a tier line.
- ``--devices 2 --mesh 1x2`` (two gloo ranks, tensor-parallel) serves
  the batch as the unsharded launcher does, outside margin rows.
- ``--dry-run``, ``--multi-pod``, ``--devices`` without ``--mesh``, an
  unknown request field and an ``--arch`` outside the registry are
  refused.
- ``train_pair`` writes its checkpoints and a second call loads them.
- ``quickstart``, ``serve_watermarked`` and ``tradeoff_curves`` run on
  ``--device cpu``; every entry point defaults to the card.
"""
import json
import re

import numpy as np
import pytest
import torch

from repro_torch.examples import quickstart, serve_watermarked
from repro_torch.examples import tradeoff_curves
from repro_torch.launch import serve as LS
from repro_torch.serve import divergence
from repro_torch.serve import engine as E
from repro_torch.serve import keys as KZ
from repro_torch.serve.config import ServeConfig
from repro_torch.train import pair

torch.set_num_threads(1)

REQUESTS = [
    {"tokens": [1, 5, 9, 11, 40, 50, 60, 70, 80, 90], "n_tokens": 8},
    {"text": "the cat sat", "n_tokens": 6, "tier": "latency"},
    {"tokens": [1, 5, 9, 11, 40, 50, 60, 70, 80, 91, 92], "n_tokens": 7,
     "key": 1234, "uid": 40},
    {"tokens": [1, 5, 9, 11, 40, 50, 60, 70, 3], "n_tokens": 5},
]
CPU = ["--device", "cpu", "--batch", "2", "--k", "2", "--tokens", "8"]


def _report(out):
    m = re.search(r"AATPS=([0-9.]+) .*tokens=(\d+)", out)
    return float(m.group(1)), int(m.group(2))


def test_launcher_generate_matches_engine(capsys):
    LS.main(CPU)
    aatps, tokens = _report(capsys.readouterr().out)
    res = E.generate(*LS.models("yi-6b", "", "cpu"),
                     E.SpecConfig(K=2, temperature=0.7),
                     LS.prompt_batch(2), n_tokens=8, key=LS.KEY)
    assert (aatps, tokens) == (round(res.aatps, 3), int(res.lengths.sum()))


def test_launcher_replay_matches_serve_requests(tmp_path, capsys):
    path = tmp_path / "reqs.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in REQUESTS) + "\n\n")
    flags = ["--requests", str(path), "--stream", "--overlap",
             "--page-size", "4", "--num-pages", "40", "--prefix-cache",
             "--key-pool", "4"]
    LS.main(CPU + flags)
    out = capsys.readouterr().out
    aatps, tokens = _report(out)
    assert "[overlap]" in out and "prefix cache: hits=" in out
    assert "TTFT mean=" in out and "tier=latency" in out
    assert len(re.findall(r"stream uid=\d+ i=\d+ tok=\d+", out)) == tokens
    reqs = LS.read_requests(None, str(path), 8)
    assert [set(r) for r in reqs] == [
        {"prompt", "n_tokens"}, {"prompt", "n_tokens", "tier"},
        {"prompt", "n_tokens", "key", "uid"}, {"prompt", "n_tokens"}]
    cfg = ServeConfig(
        batch=2, key=LS.KEY, sync_every=4, page_size=4, num_pages=40,
        prefill_chunk=8, prefix_cache=True,
        key_pool=KZ.KeyPool(LS.KEY, n_keys=4), overlap=True,
        strength_controller=KZ.StrengthController(
            decoder_name="gumbel", n_seeds=4000, n_gamma=9, device="cpu"))
    res = E.serve_requests(*LS.models("yi-6b", "", "cpu"),
                           E.SpecConfig(K=2, temperature=0.7), reqs,
                           config=cfg)
    alive = sum(r.alive_steps for r in res)
    assert (aatps, tokens) == (
        round(sum(r.n_accepted for r in res) / alive, 3),
        sum(r.length for r in res))
    by_uid = {r.uid: r for r in res}
    assert f"req 40: {by_uid[40].length} tokens key=000004d2" in out


def test_launcher_mesh_matches_unsharded():
    sharded = LS.main(CPU + ["--devices", "2", "--mesh", "1x2"])
    models = LS.models("yi-6b", "", "cpu")
    scfg = E.SpecConfig(K=2, temperature=0.7)
    prompts = LS.prompt_batch(2)
    res = E.generate(*models, scfg, prompts, n_tokens=8, key=LS.KEY)
    assert sharded.state is None and sharded.lengths.min() >= 8
    for b in range(2):
        j = divergence.first_divergence(res, sharded, b)
        if j is not None:       # a near-tie the sharded sums round apart
            assert divergence.decision_margin(*models, scfg, prompts[b],
                                              sharded, b, j) < 1e-5
        n = int(res.lengths[b]) if j is None else j
        np.testing.assert_array_equal(sharded.tokens[b, :n],
                                      res.tokens[b, :n])


def test_launcher_refusals(tmp_path, capsys):
    for flag in (["--dry-run"], ["--multi-pod"]):
        with pytest.raises(NotImplementedError, match="Multi-device"):
            LS.main(CPU + flag)
    with pytest.raises(SystemExit):       # --devices starts --mesh's ranks
        LS.main(CPU + ["--devices", "8"])
    assert "give --mesh" in capsys.readouterr().err
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"tokens": [1, 2], "n_tokenz": 4}) + "\n")
    with pytest.raises(SystemExit):
        LS.main(CPU + ["--requests", str(bad)])
    assert "unknown request fields ['n_tokenz']" in capsys.readouterr().err
    res = LS.main(CPU + ["--arch", "olmoe-1b-7b", "--tokens", "4"])
    assert res.tokens.shape[0] == 2 and res.lengths.min() >= 4
    with pytest.raises(SystemExit):
        LS.main(CPU + ["--draft-arch", "nope"])
    assert "'nope' is not in the registry" in capsys.readouterr().err


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """A 3-step pair trained once for the module's tests."""
    path = tmp_path_factory.mktemp("pair")
    stats = {}
    pair.train_pair(3, cache_dir=str(path), device="cpu", stats_out=stats)
    assert not stats["cached"]
    assert [len(stats[m]["losses"]) for m in ("target", "draft")] == [3, 3]
    return str(path)


def test_train_pair_round_trips_its_cache(cache_dir):
    stats = {}
    tcfg, dcfg, target, draft, _ = pair.train_pair(
        3, cache_dir=cache_dir, device="cpu", stats_out=stats)
    assert stats == {"cached": True}
    assert (tcfg, dcfg) == (pair.target_cfg(), pair.draft_cfg())
    fresh = pair.train_pair(3, cache_dir=cache_dir, device="cpu",
                            force=True)
    for a, b in zip((target, draft), fresh[2:4]):
        for (n, p), (_, q) in zip(a.named_parameters(),
                                  b.named_parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    prompts = pair.bench_prompts(pair.corpus(), 3)
    assert prompts.shape == (3, 12) and prompts.dtype == np.int32
    assert pair.null_texts(pair.corpus(), 2, 40).shape == (2, 40)


def test_examples_run_on_the_cpu(cache_dir, capsys):
    small = ["--device", "cpu", "--train-steps", "3", "--cache-dir",
             cache_dir]
    q = quickstart.main(small + ["--batch", "2", "--tokens", "16"])
    assert 0 <= q["aatps"] <= 3 and 0 <= q["auc"] <= 1
    s = serve_watermarked.main(small + ["--batches", "1", "--batch", "2",
                                        "--tokens", "12", "--continuous",
                                        "3", "--stream"])
    assert s["continuous"]["requests"] == 3 and "ttft_ms" in s["continuous"]
    curves, refs = tradeoff_curves.main(["--device", "cpu", "--n-seeds",
                                         "500", "--n-gamma", "5"])
    assert all(np.isfinite(c.strength).all() and len(c.gammas) == 5
               for c in curves.values())
    out = capsys.readouterr().out
    assert "AUC = " in out and "Continuous batch. (gumbel): 3 requests" in out
    assert "sampling efficiency" in out


def test_entry_points_default_to_the_card(cache_dir):
    assert LS.parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    # without a card the default device fails at its first tensor
    for main, argv in ((quickstart.main, ["--cache-dir", cache_dir]),
                       (serve_watermarked.main, ["--cache-dir", cache_dir]),
                       (tradeoff_curves.main, []), (LS.main, [])):
        with pytest.raises((RuntimeError, AssertionError)):
            main(argv)
