"""Quickstart: the paper's pipeline end to end in one file, on the card
unless ``--device cpu``.

1. Train a tiny draft/target pair on the synthetic corpus (cached under
   ``artifacts/``: ``train.pair``).
2. Generate with Algorithm 1 (watermarked speculative sampling with
   pseudorandom acceptance).
3. Detect the watermark with the Ars score — and fail to detect it in
   unwatermarked text.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

From here: ``repro_torch.examples.serve_watermarked --continuous N
--stream`` serves a request queue through the continuous-batching
scheduler and streams each token as it commits
(``repro_torch.launch.serve`` exposes the same through ``--stream`` /
``--overlap``).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.detection import gumbel_detect, pipeline, records
from repro_torch.data.synthetic import decode_bytes
from repro_torch.serve import engine as E
from repro_torch.train import pair

# the reference's demo key, jax.random.key(7), as its key word: the tiny
# byte-level model is loop-prone under any deterministic watermark
# (repeated-context masking then suppresses most of the signal), and this
# key's sample stays non-degenerate
DEMO_KEY = 1420618368


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--cache-dir", default=pair.ART)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=100)
    args = ap.parse_args(argv)
    n = args.tokens

    print("== 1. training tiny draft/target pair (cached) ==")
    tcfg, _, target, draft, cp = pair.train_pair(
        args.train_steps, verbose=True, cache_dir=args.cache_dir,
        device=args.device)

    print("== 2. watermarked speculative generation (Alg. 1) ==")
    scfg = E.SpecConfig(K=3, watermark="gumbel", temperature=0.9,
                        ctx_window=8)
    prompts = pair.bench_prompts(cp, args.batch)
    res = E.generate(target, draft, scfg, prompts, n_tokens=n, key=DEMO_KEY)
    print(f"AATPS (accepted draft tokens/step): {res.aatps:.2f}  "
          f"[0 = no draft accepted, K = max]")
    print(f"tokens/step (incl. the extra target token): "
          f"{res.tokens_per_step:.2f}  [1 = no speedup, K+1 = max]")
    print("sample:", decode_bytes(res.tokens[0, :n])[:70], "...")

    print("== 3. detection ==")
    dec = E.make_decoder(scfg)
    wm = pipeline.records_from_generation(res, dec, DEMO_KEY, tcfg.vocab,
                                          n_tokens=n, device=args.device)
    nulls = pipeline.null_records(pair.null_texts(cp, args.batch, n), dec,
                                  DEMO_KEY, tcfg.vocab,
                                  ctx_window=scfg.ctx_window,
                                  device=args.device)
    s_wm = gumbel_detect.scores_oracle(wm, n)
    s_null = gumbel_detect.scores_oracle(nulls, n)
    auc = records.auc(s_wm, s_null)
    print(f"watermarked Ars scores : {np.round(s_wm, 1)}")
    print(f"null Ars scores        : {np.round(s_null, 1)}")
    print(f"AUC = {auc:.3f}  (0.5 = chance)")
    return dict(aatps=res.aatps, tokens_per_step=res.tokens_per_step,
                auc=auc)


if __name__ == "__main__":
    main()
