"""Training launcher for the LMs (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --steps 10 --batch 8 --seq 64 --device cpu

Runs on the card unless ``--device cpu`` is given (without a card the
default raises), under the ``"ref"`` policy: no kernel has a backward, so
autograd runs through the plain PyTorch ops. ``--ckpt`` is refused until
checkpoints are ported (ROADMAP 1.7b).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import (RunConfig, SHAPES_BY_NAME, get_arch,
                                      list_archs)
from repro_torch.models.lm import REMAT
from repro_torch.train.trainer import CHECKPOINTS, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default="train_4k", choices=SHAPES_BY_NAME)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt", default=None, help=f"refused: {CHECKPOINTS}")
    ap.add_argument("--remat", default="nothing", choices=REMAT)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt is not None:
        ap.error(f"--ckpt: {CHECKPOINTS}")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    run = RunConfig(arch=cfg, policy="ref", shape=SHAPES_BY_NAME[args.shape],
                    remat=args.remat, learning_rate=args.lr)
    train(run, num_steps=args.steps, batch_override=args.batch,
          seq_override=args.seq, device=args.device)


if __name__ == "__main__":
    main()
