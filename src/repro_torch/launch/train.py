"""Training launcher: a config of the registry on the synthetic corpus,
on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 100 [--full-config] [--save ckpt.npz] [--device cpu]

Without ``--full-config`` the arch's smoke variant (``get_smoke_config``,
vocab 256) trains; with it the full width, whose float32 weights, moments
and gradients take 16 bytes a parameter (yi-6b: ~96 GB, more than one
H100 holds).  ``--save`` writes a checkpoint in the reference's layout.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import synthetic
from repro_torch.models.model import init_params
from repro_torch.train import loop as TL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-config", action="store_true",
                    help="train the full-width config")
    ap.add_argument("--dry-run", action="store_true",
                    help="(the reference lowers train_4k on a TPU mesh; "
                    "not ported)")
    ap.add_argument("--save", default="",
                    help="checkpoint path (.npz) to write at the end")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dry_run:
        raise NotImplementedError(
            "--dry-run lowers the train step on a TPU mesh; the port's "
            "multi-device path arrives with ROADMAP's \"Multi-device and "
            "TPU tooling\" item")

    cfg = (get_config(args.arch) if args.full_config
           else get_smoke_config(args.arch, vocab=synthetic.VOCAB))
    model = init_params(cfg, seed=0, device=args.device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training {cfg.name} ({cfg.arch_type}), params {n_params:,}, "
          f"on {args.device}")
    corpus = synthetic.SyntheticCorpus()
    stream = synthetic.token_stream(corpus, 300)
    it = synthetic.batches(stream, batch=args.batch, seq=args.seq)
    model, hist = TL.fit(cfg, it, steps=args.steps, params=model,
                         log_every=20)
    print(f"final loss {hist[-1]:.4f}")
    if args.save:
        ckpt.save(args.save, model)
        print(f"saved {args.save}")
    return model, hist


if __name__ == "__main__":
    main()
