"""Train an assigned architecture's smoke config on the synthetic corpus
through ``train.loop.fit``, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.train_multiarch \
        --arch olmoe-1b-7b --steps 120 [--device cpu]

``fit`` feeds token batches only, as the reference's does, so the audio
and VLM archs (whisper-tiny, llama-3.2-vision-11b), whose forward needs
"audio_emb" / "image_emb", are refused.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.train import loop as TL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch, vocab=synthetic.VOCAB)
    if cfg.arch_type in ("audio", "vlm"):
        raise ValueError(
            f"--arch {args.arch}: fit feeds token batches only, and the "
            f"{cfg.arch_type} forward needs its frame embeddings "
            "(audio_emb / image_emb)")
    print(f"arch={args.arch} ({cfg.arch_type}), reduced params: "
          f"{cfg.param_count():,}")
    stream = synthetic.token_stream(synthetic.SyntheticCorpus(), 300)
    it = synthetic.batches(stream, batch=args.batch, seq=args.seq)
    _, hist = TL.fit(cfg, it, steps=args.steps, log_every=20,
                     device=args.device)
    if hist[-1] >= hist[0]:
        raise SystemExit(f"loss did not decrease: {hist[0]:.3f} -> "
                         f"{hist[-1]:.3f}")
    print(f"loss {hist[0]:.3f} -> {hist[-1]:.3f} over {args.steps} steps")
    return hist


if __name__ == "__main__":
    main()
