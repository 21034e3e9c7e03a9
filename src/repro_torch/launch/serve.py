"""Serving launcher (port of ``repro.launch.serve``): a Poisson
request-stream simulator over the continuous-batching slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 32 --capacity 8 --rate 4 [--threshold 0.9]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v2-lite-16b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --device cpu --paged
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch xlstm-350m --device cpu [--paged]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch musicgen-medium --device cpu [--paged]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --device cpu [--paged]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch chatglm3-6b --device cpu --paged --draft chatglm3-6b \
        --spec-k 3

Serves the arch's ``.reduced()`` config with random weights from
``init_lm``, as the JAX launcher does, and reports throughput, latency
percentiles and the early-exit rate. ``--rate 0`` makes every request ready
at t=0 (closed loop). Runs on the card by default; ``--device cpu`` runs
the plain PyTorch path.

``--arch`` takes every arch the port registers (``list_archs()``): the
dense GQA archs (yi-9b; chatglm3-6b with partial rotary and QKV biases;
qwen1.5-32b; mistral-large-123b), the QK-normed qwen3-moe-30b-a3b (MoE on
every layer) and chameleon-34b, MLA + MoE, the hybrid, xLSTM and the
stub-frontend musicgen-medium.

``--paged`` serves through the paged KV engine: pages of ``--page-size``
positions from a pool of ``--num-pages``, admission by free pages. It
serves every arch: GQA K/V pages, MLA latent pages (deepseek-v2-lite-16b)
and, for archs with recurrent layers (prefilled at the exact prompt
length), attention pages beside slot-indexed Mamba state
(jamba-v0.1-52b), or no pool at all beside slot-indexed mLSTM and sLSTM
state (xlstm-350m: pages are accounted, nothing is stored in them).
``--draft ARCH --spec-k N`` turns on greedy speculative decoding: the
draft arch (reduced, random weights) proposes N tokens per live slot per
round and the target verifies them in one forward. Exit heads are stripped
from target and draft (verification scores every position with full-model
logits); ``--threshold`` is therefore rejected with ``--draft``.
``--draft`` is rejected for MLA archs and archs with recurrent layers, as
in the JAX package.

``--gated`` decodes through the gated early-exit path: on steps where
every live slot exits, the layers past the exit are skipped and their KV
filled by CALM propagation. It needs an attention-only arch with one exit
and the contiguous engine, and is refused with ``--paged`` or ``--draft``;
the JAX launcher turns ``--gated`` off on an arch with recurrent layers,
this one refuses it. ``--threshold 2`` makes every step exit (the
normalized entropy is at most 1), ``--threshold -1`` none.
``--temperature`` / ``--top-k`` / ``--top-p`` sample (also under
``--draft``: residual rejection sampling) through per-slot generators
seeded from ``--sample-seed``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --device cpu --gated --threshold 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --device cpu --temperature 0.7 --top-k 50 --top-p 0.9 \
        --sample-seed 1
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs.base import RunConfig, get_arch, list_archs
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig
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
    ap.add_argument("--paged", action="store_true",
                    help="store attention KV in fixed-size pages")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="page pool size incl. the scratch page (default: "
                         "the contiguous worst case + 1)")
    ap.add_argument("--draft", default=None,
                    help="draft arch for greedy speculative decoding")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft proposals per speculative round (default 4)")
    ap.add_argument("--gated", action="store_true",
                    help="skip the layers past the exit on steps where "
                         "every live slot exits (CALM KV propagation)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampled decode (0 = full)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus (top-p) truncation for sampled decode "
                         "(1.0 = full distribution)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="seed of the per-slot sampling generators")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prompt_len_max + args.new_tokens > args.max_len:
        ap.error("--max-len must fit --prompt-len-max + --new-tokens")
    # invalid flag combinations die here, before any model is built
    if not args.paged and (args.num_pages is not None
                           or args.page_size != 16):
        ap.error("--page-size/--num-pages require --paged")
    if args.paged and args.gated:
        ap.error("--paged cannot be combined with --gated: the gated "
                 "early-exit decode path is not page-aware (as in the JAX "
                 "package); drop one of the two flags")
    if args.gated:
        try:
            lm.check_gated(get_arch(args.arch))
        except ValueError as e:
            ap.error(f"--gated: {e}")
    if get_arch(args.arch).mla is not None and args.draft:
        ap.error(f"--arch {args.arch} is an MLA arch: speculative decoding "
                 f"needs a GQA target (verify is not defined for MLA, as "
                 f"in the JAX package)")
    if args.spec_k is not None and not args.draft:
        ap.error("--spec-k requires --draft: k counts DRAFT proposals per "
                 "speculative round — name the draft arch")
    if args.spec_k is not None and args.spec_k < 1:
        ap.error(f"--spec-k must be >= 1 (got {args.spec_k}): each round "
                 "proposes at least one draft token")
    if args.draft:
        if args.draft not in list_archs():
            ap.error(f"--draft {args.draft!r} is not a known arch "
                     f"(choices: {', '.join(list_archs())})")
        if get_arch(args.arch).recurrent or get_arch(args.draft).recurrent:
            ap.error(f"--draft: speculative decoding needs all-attention "
                     f"target and draft archs: {lm.SPEC_RECURRENT}")
        if args.gated:
            ap.error("--draft cannot be combined with --gated: verification "
                     "scores every position with the full model, so there "
                     "is no exit to gate on")
        if args.threshold is not None:
            ap.error("--draft cannot be combined with --threshold: "
                     "speculative serving strips the target's early-exit "
                     "heads, so an exit threshold would be silently ignored")

    cfg = get_arch(args.arch).reduced()
    spec = None
    if args.draft:
        draft_cfg = dataclasses.replace(get_arch(args.draft).reduced(),
                                        early_exit=None)
        if draft_cfg.vocab_size != cfg.vocab_size:
            ap.error(f"--draft {args.draft} has vocab_size "
                     f"{draft_cfg.vocab_size} but target {args.arch} has "
                     f"{cfg.vocab_size}: acceptance compares tokens of one "
                     f"vocabulary")
        cfg = dataclasses.replace(cfg, early_exit=None)
        spec = SpecConfig(draft_arch=draft_cfg, k=args.spec_k or 4)
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
                        device=args.device, paged=args.paged,
                        page_size=args.page_size, num_pages=args.num_pages,
                        spec=spec, gated=args.gated,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, sample_seed=args.sample_seed)
    report = serve(engine, params, requests, realtime=args.rate > 0)

    lat = report.latency_percentiles()
    ttft = report.ttft_percentiles()
    itl = report.itl_percentiles()
    print(f"arch={cfg.name} capacity={args.capacity} "
          f"requests={args.requests} rate={args.rate or 'inf'}/s "
          f"device={engine.device} paged={engine.paged} "
          f"spec_k={engine.spec_k} gated={engine.gated} "
          f"temperature={engine.temperature}")
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
    if engine.paged:
        print(f"  pages: peak {int(report.stats['peak_pages'])} of "
              f"{engine.num_pages - 1} usable ({engine.page_size} "
              f"positions each)")
    if spec is not None:
        print(f"  spec decode: k={spec.k} draft={args.draft} acceptance="
              f"{report.stats['spec_acceptance']:.2%}")
    return report


if __name__ == "__main__":
    main()
