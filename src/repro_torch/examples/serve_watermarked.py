"""End-to-end serving example: batched requests through the watermarked
speculative engine (the deployment the paper targets), on the card unless
``--device cpu``.

Serves a stream of prompt batches, reports AATPS / tokens/s / watermark
detectability, and compares Alg. 1 against standard speculative sampling
on the same requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_watermarked \
        [--batches 4] [--continuous 16 --stream] [--device cpu]

Serving many requests (continuous batching)
-------------------------------------------
Fixed prompt batches waste slots: a short answer parks its slot until the
longest sequence in the batch finishes.  ``engine.serve_requests`` drains
a FIFO request queue through B live slots instead, admitting the next
prompt into a freed slot at every sync point (``--continuous`` below):

    from repro_torch.serve import config as SC, engine as E
    results = E.serve_requests(
        target, draft, E.SpecConfig(K=3, watermark="gumbel"),
        [(prompt_a, 48), (prompt_b, 16), ...],         # (tokens, n_tokens)
        config=SC.ServeConfig(batch=8, key=key, sync_every=8))
    for r in results:          # uid (submission) order
        r.tokens, r.src, r.u   # a solo generate() of the same prompt/key
        r.ttft_s, r.gaps_s     # per-request streaming latency
        r.as_generation_result()   # feeds pipeline.records_from_generation

Tokens can also be **streamed** as they commit: pass ``on_token=lambda
uid, tok, meta: ...`` (fires per token at each sync point;
``meta["final"]`` marks a request's last token), or iterate the async
``engine.serve_stream(...)``, whose legacy keyword surface turns
``overlap=True`` on (each round's host snapshot is enqueued before its
decode chunk).  ``--stream`` below shows the callback.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.detection import gumbel_detect, pipeline, records
from repro_torch.examples.quickstart import DEMO_KEY
from repro_torch.serve import config as SC
from repro_torch.serve import engine as E
from repro_torch.train import pair


def serve(target, draft, vocab, cp, scfg, *, n_batches, batch, n_tokens,
          key, device):
    all_recs, aatps, tps, toks_total = [], [], [], 0
    dec = E.make_decoder(scfg)
    t0 = time.perf_counter()
    for i in range(n_batches):
        prompts = pair.bench_prompts(cp, batch, seed=500 + i)
        res = E.generate(target, draft, scfg, prompts, n_tokens=n_tokens,
                         key=key)
        aatps.append(res.aatps)
        tps.append(res.tokens_per_step)
        toks_total += int(res.lengths.sum())
        if scfg.watermark != "none":
            all_recs += pipeline.records_from_generation(
                res, dec, key, vocab, n_tokens=n_tokens, device=device)
    dt = time.perf_counter() - t0
    return {"aatps": float(np.mean(aatps)), "tps": float(np.mean(tps)),
            "tok_per_s": toks_total / dt, "records": all_recs}


def serve_continuous(target, draft, cp, scfg, *, n_requests, batch, key,
                     rng_seed=1234, stream=False):
    """Mixed-length requests through the continuous-batching scheduler —
    the "many concurrent users" deployment.  With ``stream=True`` every
    token is printed as it surfaces at a sync point (``on_token``) and
    the report adds the TTFT / inter-token-gap means."""
    rng = np.random.default_rng(rng_seed)
    reqs = [(pair.bench_prompts(cp, 1, seed=900 + i)[0],
             int(rng.integers(8, 33))) for i in range(n_requests)]
    on_token = None
    if stream:
        def on_token(uid, tok, meta):
            tail = " <end>" if meta["final"] else ""
            print(f"  stream uid={uid} i={meta['index']} tok={tok}{tail}")
    stats = {}
    t0 = time.perf_counter()
    results = E.serve_requests(
        target, draft, scfg, reqs,
        config=SC.ServeConfig(batch=batch, key=key, sync_every=4,
                              on_token=on_token),
        stats_out=stats)
    dt = time.perf_counter() - t0
    tot = sum(r.length for r in results)
    alive = sum(r.alive_steps for r in results)
    acc = sum(r.n_accepted for r in results)
    out = {"requests": len(results), "tokens": tot,
           "aatps": acc / max(alive, 1), "tok_per_s": tot / dt}
    if stream and "ttft_mean_s" in stats:
        out["ttft_ms"] = stats["ttft_mean_s"] * 1e3
        out["gap_ms"] = stats.get("gap_mean_s", 0.0) * 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="also serve N mixed-length requests through the "
                         "continuous-batching scheduler")
    ap.add_argument("--watermark", default="gumbel",
                    choices=["gumbel", "synthid", "synthid-inf"],
                    help="watermark scheme of the --continuous demo")
    ap.add_argument("--m", type=int, default=30,
                    help="synthid tournament rounds")
    ap.add_argument("--stream", action="store_true",
                    help="print each token of the --continuous demo as it "
                         "surfaces at a sync point (on_token), and report "
                         "TTFT / inter-token-gap means")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--cache-dir", default=pair.ART)
    args = ap.parse_args(argv)

    tcfg, _, target, draft, cp = pair.train_pair(
        args.train_steps, cache_dir=args.cache_dir, device=args.device)
    key = DEMO_KEY

    print(f"serving {args.batches} batches x {args.batch} requests x "
          f"{args.tokens} tokens, K={args.k}")
    run = dict(n_batches=args.batches, batch=args.batch,
               n_tokens=args.tokens, key=key, device=args.device)
    wm = serve(target, draft, tcfg.vocab, cp,
               E.SpecConfig(K=args.k, watermark="gumbel", temperature=0.9,
                            ctx_window=8), **run)
    std = serve(target, draft, tcfg.vocab, cp,
                E.SpecConfig(K=args.k, watermark="none", accept="standard"),
                **run)
    print(f"Alg.1 (gumbel):   AATPS={wm['aatps']:.3f}  "
          f"tokens/step={wm['tps']:.3f}  "
          f"throughput={wm['tok_per_s']:.1f} tok/s")
    print(f"Std. SpecSampl.:  AATPS={std['aatps']:.3f}  "
          f"tokens/step={std['tps']:.3f}  "
          f"throughput={std['tok_per_s']:.1f} tok/s")
    print("-> Alg.1 keeps the speculative speedup (Thm 4.1b)")

    # detectability of the served text
    dec = E.make_decoder(E.SpecConfig(watermark="gumbel"))
    nulls = pipeline.null_records(
        pair.null_texts(cp, len(wm["records"]), args.tokens), dec, key,
        tcfg.vocab, ctx_window=8, device=args.device)
    s_wm = gumbel_detect.scores_oracle(wm["records"], args.tokens)
    s_null = gumbel_detect.scores_oracle(nulls, args.tokens)
    auc = records.auc(s_wm, s_null)
    print(f"served-text watermark AUC: {auc:.3f}")

    out = dict(wm=wm, std=std, auc=auc)
    if args.continuous:
        cb = serve_continuous(
            target, draft, cp,
            E.SpecConfig(K=args.k, watermark=args.watermark, m=args.m,
                         temperature=0.9, ctx_window=8),
            n_requests=args.continuous, batch=args.batch, key=key,
            stream=args.stream)
        line = (f"Continuous batch. ({args.watermark}): "
                f"{cb['requests']} requests  AATPS={cb['aatps']:.3f}  "
                f"throughput={cb['tok_per_s']:.1f} tok/s")
        if "ttft_ms" in cb:
            line += (f"  TTFT={cb['ttft_ms']:.1f}ms  "
                     f"gap={cb['gap_ms']:.1f}ms")
        print(line)
        out["continuous"] = cb
    return out


if __name__ == "__main__":
    main()
