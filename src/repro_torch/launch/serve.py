"""Serving launcher: watermarked speculative decoding for an architecture
of the port's registry (its smoke config, random weights from seeds), on
the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --watermark gumbel --k 3 --tokens 32 [--device cpu]

Continuous batching: ``--requests FILE.jsonl`` replays a request log
through the scheduler (``engine.serve_requests``) instead of one fixed
batch — each line is ``{"tokens": [...], "n_tokens": N}`` (or ``{"text":
"...", ...}``, byte-encoded with the synthetic vocab); prompts are
admitted FIFO into ``--batch`` live slots at sync points:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests reqs.jsonl \
        --batch 4 --sync-every 4 [--eos-id 10]

Multi-tenant keys: a request line may carry ``"key": <int>`` (serve that
request under an explicit watermark key word), ``"tier":
"latency"|"balanced"|"assurance"`` (map the tier to a watermark strength
γ on the trade-off curve) and ``"uid"``.  ``--key-pool N`` serves keyless
requests from a rotating N-word ``serve.keys.KeyPool`` instead of the
single launch key.  The replay report prints each request's 8-hex key
fingerprint.  Unknown request fields are an error (a typo must not
silently serve under default keying).

Streaming & overlap: ``--stream`` prints every token as it surfaces at a
sync point (the ``on_token`` surface), and the replay report gives
per-request TTFT / inter-token-gap aggregates and the prefix-cache
counters; ``--overlap`` enqueues each round's host snapshot before its
decode chunk (same served bits; paged pools need the doubled page-growth
horizon).

Sharded serving: ``--mesh DATAxMODEL`` starts ``--devices`` local ranks
(by default DATA·MODEL; ``launch.mesh.spawn``) over gloo on the CPU or on
one card, over NCCL where each rank has a card of its own, and serves
the same batch or replay through ``generate(mesh=...)`` or the sharded
``Scheduler`` on ``make_host_mesh(data=, model=)``; rank 0 prints:

    PYTHONPATH=src python -m repro_torch.launch.serve --devices 2 \
        --mesh 1x2 [--device cpu]

Not ported: ``--dry-run`` and ``--multi-pod`` (they lower on a TPU mesh;
ROADMAP's "Multi-device and TPU tooling" item).  An audio or VLM
target (``--arch whisper-tiny`` / ``llama-3.2-vision-11b``) takes random
frame embeddings (``models.model.example_batch``) as its generate
extras; continuous batching refuses it (no per-request extras).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np

import torch
import torch.distributed as dist

from repro_torch.configs import REGISTRY, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.launch.mesh import make_host_mesh, spawn
from repro_torch.models.model import example_batch, extras_of, init_params
from repro_torch.serve import engine as E
from repro_torch.serve import keys as KZ
from repro_torch.serve.config import ServeConfig
from repro_torch.sharding.spmd import Layout

KEY = 0          # the reference's launch key, jax.random.key(0), as a word
PROMPT_LEN = 12
REQUEST_FIELDS = {"tokens", "text", "n_tokens", "key", "tier", "uid"}
TPU_ONLY = ("--dry-run / --multi-pod lower the serve step on a TPU mesh; "
            "ROADMAP's \"Multi-device and TPU tooling\" item ports them "
            "last (launch/dryrun.py, launch/hlocost.py)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--draft-arch", default="",
                    help="draft model architecture (e.g. rwkv6-3b for a "
                         "recurrent drafter under an attention target); "
                         "default: a 1-layer dense draft of --arch's family")
    ap.add_argument("--watermark", default="gumbel",
                    choices=["gumbel", "synthid", "synthid-inf", "none"])
    ap.add_argument("--accept", default="pseudorandom",
                    choices=["pseudorandom", "standard"])
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--dry-run", action="store_true",
                    help="(the reference lowers the serve step on a TPU "
                         "mesh; not ported)")
    ap.add_argument("--shape", default="decode_32k",
                    choices=["decode_32k", "long_500k"],
                    help="the --dry-run shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="(with --dry-run; not ported)")
    ap.add_argument("--mesh", default="",
                    help="serve sharded on a DATAxMODEL mesh of local "
                         "ranks (e.g. 2x1, 1x2)")
    ap.add_argument("--devices", type=int, default=0,
                    help="local ranks to start for --mesh (default "
                         "DATA*MODEL): gloo on the CPU or on one card, "
                         "NCCL when each rank has a card")
    ap.add_argument("--requests", default="",
                    help="continuous-batching replay: JSONL file of "
                         '{"tokens": [...], "n_tokens": N} requests '
                         "served FIFO through --batch live slots")
    ap.add_argument("--sync-every", type=int, default=4,
                    help="scheduler sync-point interval (steps between "
                         "admission/flush opportunities)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="token id that terminates a slot early "
                         "(-1 = disabled)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="block-paged KV cache: tokens per page (0 = "
                         "dense caching); requires --num-pages")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="block-paged KV cache: physical pages in the "
                         "shared pool (page 0 is the reserved null page)")
    ap.add_argument("--key-pool", type=int, default=0,
                    help="serve keyless requests from a rotating pool of "
                         "N watermark key words derived from the launch "
                         "key (0 = single shared key)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="paged admission prefills prompts in chunks of "
                         "this many tokens")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical full-page prompt prefixes across "
                         "requests via refcounted KV pages; requires "
                         "--page-size/--num-pages")
    ap.add_argument("--stream", action="store_true",
                    help="print each token as it surfaces at a sync point "
                         "(uid=.. i=.. tok=..) — the on_token surface")
    ap.add_argument("--overlap", action="store_true",
                    help="enqueue each round's host snapshot before its "
                         "decode chunk (served bits unchanged; paged pools "
                         "need the doubled page-growth horizon)")
    ap.add_argument("--device", default="cuda")
    return ap


def models(arch: str, draft_arch: str = "", device="cuda"):
    """The launcher's pair, as the reference's launcher builds it: the
    arch's smoke config at the synthetic vocabulary (weights from seed 1)
    and a 1-layer draft of its family — or of ``draft_arch``, or a small
    dense yi-6b draft under a recurrent target (seed 2).
    -> (target, draft)."""
    V = synthetic.VOCAB
    tcfg = get_smoke_config(arch, vocab=V)
    small = dict(vocab=V, n_layers=1, d_model=64, d_ff=128, n_heads=2,
                 n_kv_heads=2, head_dim=32)
    if draft_arch:
        dcfg = get_smoke_config(draft_arch, vocab=V, n_layers=1,
                                d_model=64)
    elif tcfg.arch_type in ("ssm", "hybrid", "audio", "vlm"):
        # the draft stays a small dense transformer, as in deployment (a
        # text-only draft: an audio / VLM draft would need frame inputs)
        dcfg = get_smoke_config("yi-6b", **small)
    else:
        dcfg = get_smoke_config(arch, **small)
    return (init_params(tcfg, seed=1, device=device),
            init_params(dcfg, seed=2, device=device))


def prompt_batch(batch: int) -> np.ndarray:
    """The fixed-batch path's prompts: corpus prompts, left-padded with
    zeros to PROMPT_LEN tokens."""
    rows = []
    for p in synthetic.prompts(synthetic.SyntheticCorpus(), batch,
                               prompt_words=3):
        p = p[:PROMPT_LEN]
        rows.append(np.concatenate([np.zeros(PROMPT_LEN - len(p), np.int32),
                                    p]))
    return np.stack(rows)


def read_requests(ap, path: str, n_tokens: int):
    """The JSONL request log as ``serve_requests`` dicts; an unknown field
    is a parser error naming the line."""
    reqs = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            unknown = sorted(set(obj) - REQUEST_FIELDS)
            if unknown:
                ap.error(f"{path}:{ln}: unknown request fields {unknown} — "
                         f"accepted: {sorted(REQUEST_FIELDS)}")
            toks = (obj["tokens"] if "tokens" in obj else
                    synthetic.encode(obj["text"].encode()).tolist())
            req = {"prompt": np.asarray(toks, np.int32),
                   "n_tokens": int(obj.get("n_tokens", n_tokens))}
            for fld in ("key", "tier", "uid"):
                if fld in obj:
                    req[fld] = obj[fld]
            reqs.append(req)
    return reqs


def serve_replay(ap, args, target, draft, scfg, mesh=None):
    """``--requests``: the log through ``serve_requests``, then the
    report lines."""
    reqs = read_requests(ap, args.requests, args.tokens)
    if args.page_size and not args.num_pages:
        ap.error("--page-size requires --num-pages")
    if args.prefix_cache and not args.page_size:
        ap.error("--prefix-cache requires --page-size/--num-pages "
                 "(prefix sharing lives on the paged KV pool)")
    pool = KZ.KeyPool(KEY, n_keys=args.key_pool) if args.key_pool else None
    ctrl = None
    if any("tier" in r for r in reqs):
        # a modest Monte-Carlo budget: the launcher picks γ, it does not
        # publish the curve
        ctrl = KZ.StrengthController(decoder_name=args.watermark,
                                     n_seeds=4000, n_gamma=9,
                                     device=args.device)
    on_token = None
    if args.stream:
        def on_token(uid, tok, meta):
            fin = " final" if meta["final"] else ""
            print(f"  stream uid={uid} i={meta['index']} tok={tok} "
                  f"t={meta['t_rel_s']:.3f}s{fin}")
    stats: dict = {}
    cfg = ServeConfig(
        batch=args.batch, key=KEY,
        eos_id=None if args.eos_id < 0 else args.eos_id,
        sync_every=args.sync_every, mesh=mesh,
        page_size=args.page_size or None,
        num_pages=args.num_pages or None,
        prefill_chunk=args.prefill_chunk if args.page_size else None,
        prefix_cache=args.prefix_cache, key_pool=pool,
        strength_controller=ctrl, overlap=args.overlap, on_token=on_token)
    results = E.serve_requests(target, draft, scfg, reqs, config=cfg,
                               stats_out=stats)
    tot = sum(r.length for r in results)
    alive = sum(r.alive_steps for r in results)
    acc = sum(r.n_accepted for r in results)
    paged = (f" paged(page_size={args.page_size}, "
             f"num_pages={args.num_pages}"
             + (", prefix-cache" if args.prefix_cache else "") + ")"
             if args.page_size else "")
    pooled = f" key-pool={args.key_pool}" if args.key_pool else ""
    print(f"arch={args.arch} watermark={args.watermark} "
          f"continuous batching{paged}{pooled}: {len(results)} "
          f"requests over {args.batch} slots"
          + (" [overlap]" if args.overlap else ""))
    print(f"AATPS={acc / max(alive, 1):.3f} tokens={tot} "
          f"alive-slot-steps={alive}")
    if "ttft_mean_s" in stats:
        gap = (f" gap mean={stats['gap_mean_s'] * 1e3:.1f}ms "
               f"p95={stats['gap_p95_s'] * 1e3:.1f}ms"
               if "gap_mean_s" in stats else "")
        print(f"TTFT mean={stats['ttft_mean_s'] * 1e3:.1f}ms{gap} "
              "(first-serve wall clock, compile included)")
    if "prefix_hits" in stats:
        print(f"prefix cache: hits={stats['prefix_hits']:.0f} "
              f"misses={stats['prefix_misses']:.0f} "
              f"pages-saved={stats['prefix_pages_saved']:.0f} "
              f"evictions={stats['prefix_evictions']:.0f} "
              f"(entries={stats['prefix_entries']:.0f}, "
              f"pages held={stats['prefix_pages']:.0f})")
    for r in results[:8]:
        tail = " eos" if r.eos else ""
        tier = f" tier={r.tier}" if r.tier else ""
        print(f"  req {r.uid}: {r.length} tokens{tail} "
              f"key={r.key_fingerprint} gamma={r.strength:g}{tier} | "
              + synthetic.decode_bytes(r.tokens)[:40].decode("latin1"))
    return results


def mesh_shape(ap, spec: str):
    """``--mesh DATAxMODEL`` -> (data, model)."""
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh {spec!r}: expected DATAxMODEL, e.g. 2x1")
    if data < 1 or model < 1:
        ap.error(f"--mesh {spec!r}: both sizes must be >= 1")
    return data, model


def serve(ap, args, mesh=None):
    """Build the pair and serve the batch or the replay (on ``mesh`` when
    given), printing the report."""
    for flag, arch in (("--arch", args.arch),
                       ("--draft-arch", args.draft_arch)):
        if arch and arch not in REGISTRY:
            ap.error(f"{flag} {arch!r} is not in the registry "
                     f"({sorted(REGISTRY)})")
    target, draft = models(args.arch, args.draft_arch, args.device)
    scfg = E.SpecConfig(K=args.k, watermark=args.watermark,
                        accept=args.accept, temperature=args.temperature)
    if mesh is not None:
        print(f"serving sharded on {Layout(mesh)}")
    if args.requests:
        return serve_replay(ap, args, target, draft, scfg, mesh)
    # the stub frontends' frame embeddings of an audio / VLM target
    extras = extras_of(example_batch(target.cfg, args.batch, 4,
                                     device=args.device))
    res = E.generate(target, draft, scfg, prompt_batch(args.batch),
                     n_tokens=args.tokens, key=KEY, extras=extras, mesh=mesh)
    print(f"arch={args.arch} watermark={args.watermark} "
          f"accept={args.accept} K={args.k}")
    print(f"AATPS={res.aatps:.3f} tokens/step={res.tokens_per_step:.3f} "
          f"steps={res.n_steps} tokens={int(res.lengths.sum())}")
    print("sample bytes:", synthetic.decode_bytes(
        res.tokens[0, :args.tokens])[:60])
    return res


def serve_rank(rank: int, argv):
    """One rank of ``--mesh``: the mesh over the spawned group, then
    ``serve`` (rank 0 prints).  Returns the result with the rank's engine
    state dropped (it holds tensors of this process)."""
    ap = parser()
    args = ap.parse_args(argv)
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // dist.get_world_size()))
    mesh = make_host_mesh(**dict(zip(("data", "model"),
                                     mesh_shape(ap, args.mesh))))
    with (contextlib.redirect_stdout(io.StringIO()) if rank
          else contextlib.nullcontext()):
        res = serve(ap, args, mesh)
    if isinstance(res, E.GenerationResult):
        res = dataclasses.replace(res, state=None)
    return res


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.dry_run or args.multi_pod:
        raise NotImplementedError(TPU_ONLY)
    if args.devices and not args.mesh:
        ap.error("--devices starts the ranks of a --mesh: give --mesh "
                 "DATAxMODEL")
    if not args.mesh:
        return serve(ap, args)
    data, model = mesh_shape(ap, args.mesh)
    n = args.devices or data * model
    # NCCL gives each rank a card; ranks that share one card, or the CPU,
    # reduce over gloo
    backend = ("nccl" if args.device == "cuda"
               and n <= torch.cuda.device_count() else "gloo")
    argv = list(argv if argv is not None else sys.argv[1:])
    return spawn(serve_rank, n, backend=backend, args=(argv,))[0]


if __name__ == "__main__":
    main()
