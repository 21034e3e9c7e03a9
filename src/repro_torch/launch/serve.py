"""Serving launcher (port of ``repro.launch.serve``): a Poisson
request-stream simulator over the continuous-batching slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 32 --capacity 8 --rate 4 [--threshold 0.9]

Serves the arch's ``.reduced()`` config with random weights from
``init_lm``, as the JAX launcher does, and reports throughput, latency
percentiles and the early-exit rate. ``--rate 0`` makes every request ready
at t=0 (closed loop). Runs on the card by default; ``--device cpu`` runs
the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import RunConfig, get_arch, list_archs
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.scheduler import poisson_requests, serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean arrivals/s (Poisson); 0 = all at t=0")
    ap.add_argument("--prompt-len-min", type=int, default=4)
    ap.add_argument("--prompt-len-max", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per chunk between host fetches")
    ap.add_argument("--threshold", type=float, default=None,
                    help="early-exit entropy threshold (default: the arch's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prompt_len_max + args.new_tokens > args.max_len:
        ap.error("--max-len must fit --prompt-len-max + --new-tokens")

    cfg = get_arch(args.arch).reduced()
    if args.threshold is not None and cfg.early_exit is not None:
        cfg = dataclasses.replace(cfg, early_exit=dataclasses.replace(
            cfg.early_exit, entropy_threshold=args.threshold))
    params = lm.init_lm(cfg, seed=0, device=args.device)
    requests = poisson_requests(
        num=args.requests,
        rate_hz=(args.rate if args.rate > 0 else np.inf),
        prompt_lens=(args.prompt_len_min, args.prompt_len_max),
        max_new_tokens=args.new_tokens, vocab_size=cfg.vocab_size,
        seed=args.seed)
    engine = SlotEngine(RunConfig(arch=cfg), capacity=args.capacity,
                        max_len=args.max_len, chunk=args.chunk,
                        device=args.device)
    report = serve(engine, params, requests, realtime=args.rate > 0)

    lat = report.latency_percentiles()
    ttft = report.ttft_percentiles()
    itl = report.itl_percentiles()
    print(f"arch={cfg.name} capacity={args.capacity} "
          f"requests={args.requests} rate={args.rate or 'inf'}/s "
          f"device={engine.device}")
    print(f"  throughput: {report.decode_tokens} tokens in "
          f"{report.wall_s:.2f}s = {report.tokens_per_s:.1f} tok/s "
          f"(decode chunks run: {engine.decode_calls})")
    print(f"  latency: p50={lat['p50']*1e3:.0f}ms p99={lat['p99']*1e3:.0f}ms "
          f"mean={lat['mean']*1e3:.0f}ms")
    print(f"  ttft: p50={ttft['p50']*1e3:.0f}ms p99={ttft['p99']*1e3:.0f}ms"
          f"  itl: p50={itl['p50']*1e3:.1f}ms max={itl['max']*1e3:.1f}ms")
    print(f"  concurrency: peak {int(report.stats['max_concurrency'])} slots")
    if report.rejected:
        print(f"  rejected: {len(report.rejected)} request(s) "
              f"(first: {report.rejected[0].reject_reason})")
    print(f"  exit stats: exit_rate={report.stats['exit_rate']:.2%} "
          f"gated_fraction={report.stats['gated_fraction']:.2%}")
    return report


if __name__ == "__main__":
    main()
