"""Fig. 1's trade-off curves (reduced Monte-Carlo) printed as an ASCII
chart, computed on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.tradeoff_curves \
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.core import tradeoff


def ascii_plot(curves, refs, width=64, height=18):
    grid = [[" "] * width for _ in range(height)]
    ymax = refs["max_strength"] * 1.05
    marks = {"linear/gumbel": "*", "hu/gumbel": "h", "google/gumbel": "g"}
    for name, c in curves.items():
        for e, s in zip(c.efficiency, c.strength):
            xi = min(int(e * (width - 1)), width - 1)
            yi = min(int(s / ymax * (height - 1)), height - 1)
            grid[height - 1 - yi][xi] = marks[name]
    # the Alg. 1 star
    xi = int(refs["std_spec_efficiency"] * (width - 1))
    yi = int(refs["max_strength"] / ymax * (height - 1))
    grid[height - 1 - yi][xi] = "X"
    print(f"watermark strength ^   (X = Alg. 1: eff="
          f"{refs['std_spec_efficiency']:.2f}, WS="
          f"{refs['max_strength']:.2f})")
    for row in grid:
        print("|" + "".join(row))
    print("+" + "-" * width + "> sampling efficiency")
    print("legend: * linear class   h Hu's class   g Google's class")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-seeds", type=int, default=12_000)
    ap.add_argument("--n-gamma", type=int, default=13)
    args = ap.parse_args(argv)
    kw = dict(n_gamma=args.n_gamma, n_seeds=args.n_seeds,
              seed_chunk=min(4_000, args.n_seeds), device=args.device)
    curves = {
        "linear/gumbel": tradeoff.linear_class_curve(
            "gumbel", n_theta=args.n_gamma, **kw),
        "hu/gumbel": tradeoff.composed_class_curve("gumbel", "hu", **kw),
        "google/gumbel": tradeoff.composed_class_curve("gumbel", "google",
                                                       **kw),
    }
    refs = tradeoff.reference_points(device=args.device)
    ascii_plot(curves, refs)
    print("\nAlg. 1 sits strictly above every class at max efficiency: the")
    print("trade-off is broken by pseudorandom acceptance (Thm 4.1).")
    return curves, refs


if __name__ == "__main__":
    main()
