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

``--prefix-sharing`` (with ``--paged``; all-attention GQA archs without
an MoE) admits a prompt at its fork point against the resident page
chains: matched pages are mapped read-only, a partial boundary page is
copied, and only the unshared suffix is prefilled. ``--shared-prefix-len
N`` opens every prompt with the same N tokens (a system prompt) to give
it something to share:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --device cpu --paged --prefix-sharing --shared-prefix-len 24

``--preemption`` / ``--priority N`` / ``--prefill-chunk C`` /
``--slo-ttft-ms T`` route the stream through the overload scheduler
(``serve/overload.py``): optimistic page admission whose growth preempts
(host-swaps or re-prefills) the lowest-priority victim instead of
rejecting new work, N aged priority classes, per-request TTFT sheds, and
long prompts admitted as C-token prefill chunks between decode chunks. One
``overload:`` line reports the scheduler's counts. ``--preemption`` and
``--prefill-chunk`` need ``--paged``; C must be a multiple of
``--page-size`` (exit 2 otherwise):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
        --device cpu --paged --num-pages 9 --capacity 3 --preemption \
        --priority 3 --prefill-chunk 16

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

``--autotune`` measures every backend of every op at the served arch's
dims (``core/autotune.py``, 2 iterations a backend, on ``--device``) and
writes the winning ``DispatchPolicy`` to ``--policy`` (default
``.xaif_policy_torch.json``), then serves under it. ``--policy PATH``
alone serves under the policy an earlier ``--autotune`` wrote there, and
refuses one measured on another device (a policy measured on the CPU
timed no kernel and has no rule). Without either flag the launcher
serves ``"auto"``; no file is read unasked. A ``dispatch:`` line reports
the policy's rules and the calls its ``supports`` fallbacks moved:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --device cpu --autotune --policy /tmp/yi.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --device cpu --policy /tmp/yi.json

``--inject-fault site=<s>,chunk=<n>`` is the chaos smoke: one fault at
the n-th call (0-based) of site s (``prefill``, ``decode``,
``page_alloc``, ``swap``, ``backend``; the last two need ``--paged``,
``backend`` routes rmsnorm through the ``chaos`` backend, in place of any
loaded or tuned policy). The launcher
serves a fault-free reference stream first, then the same requests under
the restart supervisor (``serve/resilient.py``: a snapshot every
``--snapshot-every`` chunks, at most ``--max-restarts`` restarts, a
``--watchdog-ms`` budget a chunk), prints a ``chaos:`` line and exits
non-zero unless the fault fired, every request completed and every token
equals the reference's. The supervisor drives the base FIFO scheduler
only, so the overload flags are refused with it:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \
        --device cpu --paged --inject-fault site=page_alloc,chunk=2
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses

import numpy as np

from repro_torch.configs.base import RunConfig, get_arch, list_archs
from repro_torch.core import autotune as autotune_mod
from repro_torch.core import xaif
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig
from repro_torch.serve.faults import SITES, FaultInjector, chaos_backends
from repro_torch.serve.overload import OverloadConfig
from repro_torch.serve.resilient import serve_resilient
from repro_torch.serve.scheduler import poisson_requests, serve


def _fault_spec(ap, spec: str):
    """``site=<name>,chunk=<n>`` -> (site, n), or a parse-time error."""
    kv = {}
    for part in spec.split(","):
        if "=" not in part:
            ap.error(f"--inject-fault {spec!r}: expected site=<name>,"
                     f"chunk=<n> (got segment {part!r})")
        k, v = part.split("=", 1)
        kv[k.strip()] = v.strip()
    site, chunk = kv.pop("site", None), kv.pop("chunk", None)
    if kv:
        ap.error(f"--inject-fault: unknown key(s) {sorted(kv)}; the spec is "
                 f"site=<name>,chunk=<n>")
    if site not in SITES:
        ap.error(f"--inject-fault site must be one of {SITES} (got {site!r})")
    try:
        chunk = int(chunk)
    except (TypeError, ValueError):
        ap.error(f"--inject-fault chunk must be an integer >= 0 (got "
                 f"{chunk!r})")
    if chunk < 0:
        ap.error(f"--inject-fault chunk must be >= 0 (got {chunk})")
    return site, chunk


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
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="radix-match prompts against resident KV page "
                         "chains; matched prefixes are mapped (refcounted, "
                         "copy-on-write boundary) and only the unshared "
                         "suffix is prefilled (requires --paged)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="give every request a common prompt prefix of "
                         "this many tokens (a workload for "
                         "--prefix-sharing)")
    ap.add_argument("--preemption", action="store_true",
                    help="overload control: optimistic page admission with "
                         "priority-aware preemption; victims are host-"
                         "swapped or re-prefilled instead of new arrivals "
                         "being rejected (requires --paged)")
    ap.add_argument("--priority", type=int, default=0, metavar="N",
                    help="number of priority classes: each request draws a "
                         "priority in [0, N) (higher = sooner; aged so "
                         "nothing starves); N <= 1 keeps one class. Routed "
                         "through the overload scheduler")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="chunked prefill: admit long prompts as C-token "
                         "prefill chunks between decode chunks (requires "
                         "--paged; C a multiple of --page-size)")
    ap.add_argument("--slo-ttft-ms", type=float, default=0.0,
                    help="stamp every request with this first-token SLO; "
                         "the overload scheduler sheds queued requests "
                         "that have already missed it (0 = off)")
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
    ap.add_argument("--inject-fault", default="", metavar="SPEC",
                    help="chaos smoke: SPEC is site=<name>,chunk=<n>: one "
                         "fault at the n-th call of that site (sites: "
                         "prefill, decode, page_alloc, swap, backend), the "
                         "stream served under the restart supervisor and "
                         "held to 100%% completion and the tokens of a "
                         "fault-free reference run")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="per-chunk watchdog budget of the restart "
                         "supervisor: a slower chunk is treated as a crash "
                         "and replayed from the latest snapshot (0 = off)")
    ap.add_argument("--snapshot-every", type=int, default=4,
                    help="supervisor snapshot cadence in decode chunks")
    ap.add_argument("--max-restarts", type=int, default=8,
                    help="supervisor restart budget before giving up")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="serve under the DispatchPolicy JSON that "
                         "--autotune wrote here on this device (with "
                         "--autotune: where to write it; default "
                         f"{autotune_mod.DEFAULT_POLICY_PATH})")
    ap.add_argument("--autotune", action="store_true",
                    help="measure every backend at this arch's serve-time "
                         "dims on --device, persist the winning policy to "
                         "--policy and serve under it")
    args = ap.parse_args(argv)
    if (args.shared_prefix_len + args.prompt_len_max + args.new_tokens
            > args.max_len):
        ap.error("--max-len must fit --shared-prefix-len + "
                 "--prompt-len-max + --new-tokens")
    # invalid flag combinations die here, before any model is built
    if not args.paged and (args.num_pages is not None
                           or args.page_size != 16):
        ap.error("--page-size/--num-pages require --paged")
    if args.paged and args.gated:
        ap.error("--paged cannot be combined with --gated: the gated "
                 "early-exit decode path is not page-aware (as in the JAX "
                 "package); drop one of the two flags")
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged: shared prefixes are "
                 "mapped as refcounted KV pages, which only exist in the "
                 "paged engine")
    if args.preemption and not args.paged:
        ap.error("--preemption requires --paged: optimistic admission and "
                 "the host-swap pool work on KV pages; add --paged")
    if args.prefill_chunk:
        if not args.paged:
            ap.error("--prefill-chunk requires --paged: chunk KV is written "
                     "page by page into the pool; add --paged")
        if args.prefill_chunk < 0 or args.prefill_chunk % args.page_size:
            ap.error(f"--prefill-chunk {args.prefill_chunk} must be a "
                     f"positive multiple of --page-size {args.page_size}: "
                     f"chunk boundaries must land on page boundaries")
        if args.draft:
            ap.error("--draft cannot be combined with --prefill-chunk: "
                     "chunked admission writes the target's KV page by "
                     "page and never prefills the draft's slot cache")
    if args.priority < 0:
        ap.error("--priority must be >= 0 (number of priority classes)")
    fault_spec = (_fault_spec(ap, args.inject_fault) if args.inject_fault
                  else None)
    if fault_spec is not None and fault_spec[0] in ("page_alloc", "swap") \
            and not args.paged:
        ap.error(f"--inject-fault site={fault_spec[0]} requires --paged: "
                 f"that site only exists on the paged KV path")
    if args.watchdog_ms < 0:
        ap.error("--watchdog-ms must be >= 0 (0 = off)")
    if args.snapshot_every < 1:
        ap.error("--snapshot-every must be >= 1")
    if args.max_restarts < 0:
        ap.error("--max-restarts must be >= 0")
    resilient = fault_spec is not None or args.watchdog_ms > 0
    if resilient and (args.preemption or args.priority > 1
                      or args.prefill_chunk or args.slo_ttft_ms > 0):
        ap.error("--inject-fault/--watchdog-ms run the restart supervisor, "
                 "which drives the base FIFO scheduler only: drop the "
                 "overload flags (--preemption/--priority/--prefill-chunk/"
                 "--slo-ttft-ms)")
    if args.prefix_sharing:
        try:
            lm.check_shared_prefill(get_arch(args.arch))
        except ValueError as e:
            ap.error(f"--prefix-sharing: {e}")
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
    if args.autotune:
        path = args.policy or autotune_mod.DEFAULT_POLICY_PATH
        print(f"autotuning XAIF backends at {args.arch} serve dims on "
              f"{args.device} -> {path}")
        result = autotune_mod.autotune(
            iters=2, arch=cfg, capacity=args.capacity, max_len=args.max_len,
            page_size=args.page_size, device=args.device, print_fn=print)
        result.persist(path)
        policy = result.policy
    elif args.policy is not None:
        try:
            policy = autotune_mod.load_policy(args.policy, args.device)
        except (OSError, ValueError) as exc:
            ap.error(f"--policy: {exc}")
        print(f"loaded dispatch policy from {args.policy} "
              f"({len(policy.rules)} rules)")
    else:
        policy = "auto"
    params = lm.init_lm(cfg, seed=0, device=args.device)
    overload = None
    if (args.preemption or args.priority > 1 or args.prefill_chunk
            or args.slo_ttft_ms > 0):
        overload = OverloadConfig(
            mode="preempt" if args.preemption else "reject",
            prefill_chunk=args.prefill_chunk)
    prio_spec = None
    if args.priority > 1:
        prio_spec = (np.arange(args.priority),
                     np.full(args.priority, 1.0 / args.priority))
    requests = poisson_requests(
        num=args.requests,
        rate_hz=(args.rate if args.rate > 0 else np.inf),
        prompt_lens=(args.prompt_len_min, args.prompt_len_max),
        max_new_tokens=args.new_tokens, vocab_size=cfg.vocab_size,
        seed=args.seed, priorities=prio_spec,
        slo_ttft_ms=args.slo_ttft_ms if args.slo_ttft_ms > 0 else None)
    if args.shared_prefix_len > 0:
        # every prompt opens with the same system-prompt-like prefix (the
        # JAX launcher's draw), a unique suffix after it
        common = np.random.default_rng(args.seed + 1).integers(
            0, cfg.vocab_size, (args.shared_prefix_len,), dtype=np.int32)
        for r in requests:
            r.prompt = np.concatenate([common, r.prompt])
    injector, chaos_ref = None, None
    with contextlib.ExitStack() as stack:
        if fault_spec is not None and fault_spec[0] == "backend":
            # route a row op through the chaos backend (its plain version
            # behind the injector's "backend" site) so that the site fires;
            # it replaces a loaded or tuned policy, as in JAX's launcher
            stack.enter_context(chaos_backends(("rmsnorm",)))
            policy = xaif.Policy({"rmsnorm": "chaos"})
        xaif.reset_launch_counts()
        engine = SlotEngine(RunConfig(arch=cfg, policy=policy),
                            capacity=args.capacity, max_len=args.max_len,
                            chunk=args.chunk, device=args.device,
                            paged=args.paged, page_size=args.page_size,
                            num_pages=args.num_pages, spec=spec,
                            gated=args.gated, temperature=args.temperature,
                            top_k=args.top_k, top_p=args.top_p,
                            sample_seed=args.sample_seed,
                            prefix_sharing=args.prefix_sharing)
        if resilient:
            # the fault-free reference first, on fresh request copies (the
            # scheduler fills in their lifecycle fields)
            chaos_ref = copy.deepcopy(requests)
            serve(engine, params, chaos_ref, realtime=args.rate > 0)
            if fault_spec is not None:
                injector = FaultInjector(schedule={fault_spec[0]:
                                                   [fault_spec[1]]},
                                         seed=args.seed)
            report = serve_resilient(
                engine, params, requests, realtime=args.rate > 0,
                snapshot_every=args.snapshot_every,
                max_restarts=args.max_restarts,
                watchdog_ms=args.watchdog_ms or None, injector=injector)
        else:
            report = serve(engine, params, requests, realtime=args.rate > 0,
                           overload=overload)

    lat = report.latency_percentiles()
    ttft = report.ttft_percentiles()
    itl = report.itl_percentiles()
    print(f"arch={cfg.name} capacity={args.capacity} "
          f"requests={args.requests} rate={args.rate or 'inf'}/s "
          f"device={engine.device} paged={engine.paged} "
          f"spec_k={engine.spec_k} gated={engine.gated} "
          f"prefix_sharing={engine.prefix_sharing} "
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
    if isinstance(policy, xaif.DispatchPolicy):
        print(f"  dispatch: {len(policy.rules)} rules, default "
              f"{policy.default}; supports fallbacks "
              f"{xaif.fallback_counts() or 'none'}")
    if engine.paged:
        print(f"  pages: peak {int(report.stats['peak_pages'])} of "
              f"{engine.num_pages - 1} usable ({engine.page_size} "
              f"positions each)")
    if engine.prefix_sharing:
        print(f"  sharing: {int(report.stats['shared_admissions'])} shared "
              f"admissions, {int(report.stats['shared_tokens'])} prompt "
              f"tokens served from resident pages (prefill pushed "
              f"{int(report.stats['prefill_tokens'])} bucketed tokens); "
              f"index {int(report.stats['index_pages'])} pages, "
              f"{int(report.stats['index_evictions'])} evicted")
    if overload is not None:
        st = report.stats
        print(f"  overload: mode={overload.mode} " + " ".join(
            f"{k}={int(v)}" for k, v in st.items()
            if k in ("preemptions", "swap_outs", "swap_resumes",
                     "recompute_resumes", "shed_ttft", "shed_deadline",
                     "chunked_admissions", "swap_bytes_peak"))
            + f" completion={report.completion_rate:.0%}")
    if spec is not None:
        print(f"  spec decode: k={spec.k} draft={args.draft} acceptance="
              f"{report.stats['spec_acceptance']:.2%}")
    if chaos_ref is not None:
        ref_toks = {r.rid: r.tokens for r in chaos_ref}
        mismatched = [r.rid for r in requests if r.tokens != ref_toks[r.rid]]
        what = (f"site={fault_spec[0]} chunk={fault_spec[1]}"
                if fault_spec else "watchdog-only")
        print(f"  chaos[{what}]: restarts={int(report.stats['restarts'])} "
              f"faults={int(report.stats['faults_injected'])} "
              f"recovery_max="
              f"{report.stats.get('recovery_s_max', 0.0) * 1e3:.1f}ms "
              f"completion={report.completion_rate:.0%} identical_tokens="
              f"{len(requests) - len(mismatched)}/{len(requests)}")
        if injector is not None and injector.fired < 1:
            # a fault that never fires makes the smoke vacuous
            raise SystemExit(
                f"--inject-fault {what} never fired: the stream made only "
                f"{injector.calls[fault_spec[0]]} {fault_spec[0]} calls; "
                f"raise --new-tokens / --requests or lower the index")
        if report.completion_rate < 1.0:
            raise SystemExit(f"chaos run shed requests: "
                             f"{[r.reject_reason for r in report.rejected]}")
        if mismatched:
            raise SystemExit(f"chaos run diverged from the fault-free "
                             f"reference: rids {mismatched}")
        print("  chaos: 100% completion, tokens identical to the fault-free "
              "run")
    return report


if __name__ == "__main__":
    main()
