"""The paper's demonstrator, end to end (§V-§VI; port of the JAX package's
``examples/train_seizure_early_exit.py``):

1. train the seizure transformer and CNN with the early-exit joint loss at
   the paper's final operating points (w=0.1 / th=0.45, w=0.01 / th=0.35);
2. measure exit rates and F1 with and without early exit, the evaluation
   going through the kernels on the card;
3. feed the measured exit rates into the Fig. 3 energy model and print the
   speedup / energy table next to the paper's numbers;
4. with ``--sweep``, the loss weight x entropy threshold grid.

    PYTHONPATH=src python -m repro_torch.launch.train_early_exit \\
        [--steps 300] [--device cpu] [--sweep]

Runs on the card unless ``--device cpu`` is given. fp32 throughout, as the
JAX models: TF32 is turned off for cuDNN's convolutions and for matmul.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.train.early_exit import (OPERATING_POINTS, fig3_table,
                                          paper_operating_points, sweep)

PAPER_EXIT = {"transformer": "73%", "cnn": "82%"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweep", action="store_true",
                    help="also train every loss weight and evaluate every "
                         "threshold")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print(f"--- training both models at the paper's operating points on "
          f"{args.device} ---")
    points = paper_operating_points(steps=args.steps, device=args.device)
    for kind, r in points.items():
        print(f"{kind} (exit weight {r['weight']}, threshold "
              f"{r['threshold']}): loss {r['losses'][0]:.4f} -> "
              f"{r['losses'][-1]:.4f}; exit_rate={r['exit_rate']:.2%} "
              f"(paper: {PAPER_EXIT[kind]}) F1 {r['f1_full']:.3f} -> "
              f"{r['f1_early_exit']:.3f}")

    print("--- Fig. 3 with measured exit rates ---")
    print(json.dumps(fig3_table({k: r["exit_rate"]
                                 for k, r in points.items()}),
                     indent=2, default=float))
    if args.sweep:
        print("--- weight x threshold sweep ---")
        for kind, _, _ in OPERATING_POINTS:
            for row in sweep(kind, steps=args.steps, device=args.device):
                print(json.dumps(row))


if __name__ == "__main__":
    main()
