"""The trained draft/target pair of the examples — the port of the
non-timing helpers of the reference's ``benchmarks/common.py``: yi-6b's
smoke family at the synthetic vocabulary (a 2-layer d 128 target and a
1-layer d 64 draft, the container-scale stand-ins of the paper's
Llama-68M / 7B), trained on the synthetic corpus and cached as ``.npz``
checkpoints in the reference's layout (``checkpoint.io``), so either
package loads the other's.

    tcfg, dcfg, target, draft, cp = train_pair(device="cuda")
"""
from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ModelConfig, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.models.model import Model, init_params
from repro_torch.train import loop as TL

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")
V = synthetic.VOCAB


def target_cfg() -> ModelConfig:
    return get_smoke_config("yi-6b", vocab=V, n_layers=2, d_model=128,
                            d_ff=256, n_heads=4, n_kv_heads=2, head_dim=32)


def draft_cfg() -> ModelConfig:
    return get_smoke_config("yi-6b", vocab=V, n_layers=1, d_model=64,
                            d_ff=128, n_heads=2, n_kv_heads=2, head_dim=32)


def corpus() -> synthetic.SyntheticCorpus:
    return synthetic.SyntheticCorpus()


def train_pair(steps: int = 300, *, force: bool = False, verbose=False,
               cache_dir: str = ART, device="cuda",
               stats_out: Optional[dict] = None
               ) -> Tuple[ModelConfig, ModelConfig, Model, Model,
                          synthetic.SyntheticCorpus]:
    """Train target and draft on the synthetic corpus (``fit``, ``steps``
    steps at B=16, S=64 over 400 documents: the target from seed 0 on
    batches of seed 0, the draft from seed 1 on batches of seed 1), or
    load them from ``cache_dir`` where both checkpoints exist and not
    ``force``.  The models are float32 on ``device``.  ``stats_out={}``
    receives, per trained model ("target", "draft"), its loss of every
    step and its seconds, and ``cached`` (whether the pair was loaded).
    -> (tcfg, dcfg, target, draft, corpus)."""
    tcfg, dcfg = target_cfg(), draft_cfg()
    paths = [os.path.join(cache_dir, f"bench_{name}.npz")
             for name in ("target", "draft")]
    cp = corpus()
    stats = {} if stats_out is None else stats_out
    stats["cached"] = not force and all(map(os.path.exists, paths))
    if stats["cached"]:
        models = [ckpt.load(path, init_params(cfg, seed=seed, device=device))
                  for path, cfg, seed in zip(paths, (tcfg, dcfg), (0, 1))]
        return tcfg, dcfg, models[0], models[1], cp
    os.makedirs(cache_dir, exist_ok=True)
    stream = synthetic.token_stream(cp, 400)
    models = []
    for name, cfg, seed, path in zip(("target", "draft"), (tcfg, dcfg),
                                     (0, 1), paths):
        t = time.perf_counter()
        model, hist = TL.fit(cfg, synthetic.batches(stream, 16, 64,
                                                    seed=seed),
                             steps=steps, seed=seed, device=device,
                             verbose=verbose)
        stats[name] = dict(losses=hist, seconds=time.perf_counter() - t)
        ckpt.save(path, model)
        models.append(model)
    return tcfg, dcfg, models[0], models[1], cp


def bench_prompts(cp: synthetic.SyntheticCorpus, n: int, seq: int = 12,
                  seed: int = 5) -> np.ndarray:
    """A fixed-length (n, seq) int32 prompt batch, left-padded with PAD."""
    rows = []
    for p in synthetic.prompts(cp, n, prompt_words=3, seed=seed):
        p = p[:seq]
        if len(p) < seq:
            p = np.concatenate([np.full(seq - len(p), synthetic.PAD,
                                        np.int32), p])
        rows.append(p)
    return np.stack(rows).astype(np.int32)


def null_texts(cp: synthetic.SyntheticCorpus, n: int, length: int,
               seed: int = 31) -> np.ndarray:
    """Human-written stand-ins: fresh corpus samples (H0 text), (n,
    length)."""
    rows = []
    for d in cp.documents(n, seed=seed):
        t = synthetic.encode(d)[:length]
        while len(t) < length:
            t = np.concatenate([t, synthetic.encode(d)])[:length]
        rows.append(t)
    return np.stack(rows)
