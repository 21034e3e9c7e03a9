"""Serving engines (port of ``repro.serve.engine``): the slot-based
continuous-batching engine and the one-request reference loop
``generate``.

  * The cache's batch dimension is a fixed set of SLOTS (``capacity``). A
    request is admitted by a bucketed batch-1 prefill (exact-length for
    MoE and recurrent archs) written into a free slot row
    (``lm.fill_slot``: attention KV rows and, for recurrent layers, the
    whole state: Mamba conv window and SSM state, mLSTM and sLSTM cells);
    prompt
    length and occupancy are slot STATE (per-slot ``pos``/budget/done),
    never tensor shape. Decode masks dead slots out of MoE routing.
  * Decode runs in chunks of ``chunk`` steps over the whole slot batch:
    greedy argmax, the early-exit merge and the statistics stay on the
    device, and the scheduler fetches (tokens, slot state) to the host once
    per chunk.
  * Paged KV (``paged=True``): attention state (GQA K/V or MLA latents)
    lives in fixed-size pages from a pool of ``num_pages`` (page 0 is the
    scratch page, never allocated); one ``[capacity, max_pages]`` page
    table, shared by every attention layer, is rewritten by the host
    between chunks (``serve/paging.py``). Recurrent state stays
    slot-indexed; an arch with no attention layer (xLSTM) keeps no pool,
    and the host still accounts its pages.
  * Speculative decoding (``spec=SpecConfig(...)``): per round a draft
    model proposes ``k`` tokens per slot, ONE target ``forward_verify``
    scores all of them, and each slot accepts a variable-length prefix
    (greedy: proposals equal to the target's argmax; sampled: residual
    rejection sampling, ``spec_accept``).
  * Prefix sharing (``prefix_sharing=True``, paged engines of
    all-attention GQA archs without an MoE): the scheduler radix-matches a
    prompt against resident page chains (``serve/paging.py``), maps the
    matched pages read-only, copies a partial boundary page
    (``copy_page``) and prefills only the unshared suffix against them
    (``prefill_into_shared``). ``prefill_chunk`` runs one page-aligned
    chunk of a long prompt through the same fork-point prefill.
  * Preemption (the overload scheduler, ``serve/overload.py``):
    ``fetch_pages`` swaps a victim's pages out to host memory,
    ``deactivate_slot`` kills its slot, and a resume writes the pages
    back into fresh ids (``restore_pages``) and re-arms a slot at the
    victim's position, token, budget and generator (``restore_slot``).
    All of it runs between chunks: the decode step reads nothing on the
    host.
  * Gated early-exit decode (``gated=True``): ``lm.forward_decode_gated``
    skips the layers past the exit on steps where every live slot exits.
  * Sampling (``temperature > 0``, optional ``top_k`` / ``top_p``):
    ``make_sampler`` / ``make_probs``, drawn with Gumbel noise from one
    ``torch.Generator`` per slot (``DecodeState.rng``), seeded from
    ``(sample_seed, slot)`` or, at admission, from the request's own
    ``seed``; never from the global generator. Greedy touches none.
  * Faults and snapshots (the restart supervisor, ``serve/resilient.py``):
    ``injector`` (a ``serve/faults.py`` ``FaultInjector``) is checked at
    the entry of every admission (site ``prefill``), of ``decode``
    (``decode``) and of ``fetch_pages`` (``swap``). ``snapshot`` copies
    the device half of a stream to host memory owned by the snapshot and
    ``restore`` writes it back over the live buffers in place, bitwise,
    whatever a half-finished step wrote into them after it (K/V appends,
    recurrent state, generators).

Every step runs the same kernels on the same per-row data whatever the
other slots hold (per-slot cache positions; the GEMM reduces each row in
one fixed order), so the engine's greedy tokens equal ``generate``'s, the
paged engine's equal the contiguous engine's (when ``page_size`` divides
``max_len``), and speculative tokens equal plain greedy tokens. A seeded
sampled request draws from its own generator only, so it replays its
tokens whatever slot it lands in and whoever shares the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.core.early_exit import (gated_layer_fraction,
                                         merge_exit_logits)
from repro_torch.models import lm
from repro_torch.models.attention import SharedPrefillCtx


def _as_run(run: Union[RunConfig, ArchConfig]) -> RunConfig:
    return run if isinstance(run, RunConfig) else RunConfig(arch=run)


def _map_state(tree, fn):
    """``fn`` on every tensor of a cache or state tree (named tuples,
    tuples, lists); other leaves (None, the mixer names) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_state(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_state(v, fn) for v in tree)
    return tree


def _copy_state(dst, src) -> None:
    """Copy every tensor of the host tree ``src`` into its counterpart in
    the same-structured device tree ``dst``, in place."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"a snapshot tensor {tuple(src.shape)} "
                             f"{src.dtype} for a buffer {tuple(dst.shape)} "
                             f"{dst.dtype}")
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            _copy_state(d, s)


def _select(logits, exit_lgs, cfg: ArchConfig, policy: str):
    """Early-exit merge: (selected logits, exit index per row)."""
    if cfg.early_exit is not None and exit_lgs:
        return merge_exit_logits(logits, exit_lgs, cfg.early_exit, policy)
    return logits, None


@torch.inference_mode()
def generate(run: Union[RunConfig, ArchConfig], params, prompt,
             max_new_tokens: int, max_len: Optional[int] = None,
             device="cuda", gated: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy generation, one prompt batch at a time (the REFERENCE loop).
    prompt [B, T] ints. ``gated``: decode through
    ``lm.forward_decode_gated`` (``exit_rate`` is then the mean of its exit
    mask and ``gated_fraction`` stays 0, as in the JAX loop). Returns
    (tokens [B, max_new_tokens], stats); statistics stay on the device
    until one fetch at the end."""
    run = _as_run(run)
    cfg, policy = run.arch, run.policy
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = lm.init_cache(cfg, b, max_len, device=device)
    logits, cache = lm.forward_prefill(params, prompt, cfg, policy, cache)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    exit_rate, gated_frac = [], []
    for _ in range(max_new_tokens - 1):
        if gated:
            logits, exit_mask, cache = lm.forward_decode_gated(
                params, tok[:, None], cfg, policy, cache)
            exit_rate.append(exit_mask.float().mean())
        else:
            logits, exit_lgs, cache = lm.forward_decode(
                params, tok[:, None], cfg, policy, cache)
            logits, exit_idx = _select(logits, exit_lgs, cfg, policy)
            if exit_idx is not None:
                exit_rate.append((exit_idx < len(exit_lgs)).float().mean())
                gated_frac.append(gated_layer_fraction(
                    exit_idx, cfg.early_exit.exit_layers, cfg.num_layers))
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    stats = {k: (float(torch.stack(v).mean()) if v else 0.0)
             for k, v in (("exit_rate", exit_rate),
                          ("gated_fraction", gated_frac))}
    return torch.stack(out, dim=1), stats


# ---------------------------------------------------------------------------
# Slot engine: continuous batching over a fixed-capacity slot batch
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-slot decode state + on-device statistics accumulators.

    Empty slots are born ``done``; admission flips a slot live. The
    tensors are updated in place by admission and replaced step by step by
    the decode chunk. ``quarantined`` is the NaN/Inf logit guard's verdict:
    a live slot whose logits go non-finite is frozen (its token is not
    emitted), marked done and flagged here, so the host sheds exactly that
    request.
    """
    tokens: torch.Tensor       # [S] i32 — last token per slot (next input)
    done: torch.Tensor         # [S] bool
    generated: torch.Tensor    # [S] i32 — tokens produced (incl. prefill's)
    budget: torch.Tensor       # [S] i32 — max_new_tokens per slot
    exit_cnt: torch.Tensor     # f32 — sum over steps of exited live slots
    gated_layers: torch.Tensor  # f32 — sum of per-slot gated fractions
    live_cnt: torch.Tensor     # f32 — sum over steps of live slots
    quarantined: torch.Tensor  # [S] bool
    realized: torch.Tensor     # f32 — tokens emitted by decode chunks
    spec_prop: torch.Tensor    # f32 — draft tokens proposed (spec decode)
    spec_acc: torch.Tensor     # f32 — draft tokens accepted (spec decode)
    # one generator per slot on the engine's device (sampling only; None
    # on a greedy engine); admission replaces a slot's for a seeded request
    rng: Optional[List[torch.Generator]] = None


def init_decode_state(capacity: int, device,
                      rng: Optional[List[torch.Generator]] = None
                      ) -> DecodeState:
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return DecodeState(
        tokens=torch.zeros(capacity, **i32),
        done=torch.ones(capacity, dtype=torch.bool, device=device),
        generated=torch.zeros(capacity, **i32),
        budget=torch.zeros(capacity, **i32),
        exit_cnt=z(), gated_layers=z(), live_cnt=z(),
        quarantined=torch.zeros(capacity, dtype=torch.bool, device=device),
        realized=z(), spec_prop=z(), spec_acc=z(), rng=rng)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding for :class:`SlotEngine`.

    ``draft_arch`` (registry name or :class:`ArchConfig`) proposes ``k``
    tokens per live slot per round; the target scores all of them in ONE
    ``forward_verify`` and accepts a per-slot prefix. Greedy acceptance
    compares proposals with the target's own argmax rows, so the output
    equals plain greedy decoding whatever the draft: draft quality moves
    throughput only; sampled acceptance (``spec_accept``) keeps every
    emitted token distributed as the target's sampler. ``share_params=True``
    runs the draft with the target's weights (``draft_arch`` must equal the
    target arch): every proposal is accepted."""
    draft_arch: object                   # registry name or ArchConfig
    k: int = 4                           # proposals per round
    draft_seed: int = 0                  # draft init_lm seed
    share_params: bool = False           # tied self-draft


# ---------------------------------------------------------------------------
# Sampling: temperature, top-k, top-p; Gumbel noise from per-slot generators
# ---------------------------------------------------------------------------


def _truncated(logits: torch.Tensor, temperature: float, top_k: int,
               top_p: float) -> torch.Tensor:
    """fp32 logits [..., V] of the sampled distribution, in JAX's order:
    scaled by 1 / temperature (a true division), then top-k (keep
    ``lg >= the k-th largest``: ties at the k-th are kept), then the top-p
    nucleus (keep a token whose preceding mass in descending order is <
    ``top_p``: the top-1 always survives); the rest -inf. Computed on the
    rows flattened to 2-D, so a row's bits come from the same ops whatever
    its batch."""
    shape = logits.shape
    lg = logits.reshape(-1, shape[-1]).float()
    lg = lg / lg.new_full((), temperature)
    if top_k > 0:
        kth = torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        srt, order = torch.sort(lg, dim=-1, descending=True, stable=True)
        p = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(p, dim=-1) - p) < top_p
        lg = torch.full_like(lg, float("-inf")).scatter(
            -1, order, srt.masked_fill(~keep, float("-inf")))
    return lg.reshape(shape)


def make_probs(temperature: float, top_k: int = 0, top_p: float = 1.0
               ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """probs(logits [..., V]) -> fp32 [..., V]: the distribution
    :func:`make_sampler` draws from, as densities (sampled speculative
    decoding needs p and q themselves). None for greedy (temperature 0)."""
    if temperature <= 0.0:
        return None
    return lambda logits: torch.softmax(
        _truncated(logits, temperature, top_k, top_p), dim=-1)


def make_sampler(temperature: float, top_k: int = 0, top_p: float = 1.0
                 ) -> Optional[Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]]:
    """sample(logits [..., V], noise [..., V]) -> int32 [...]: the argmax
    of the truncated logits plus standard Gumbel ``noise``, as
    ``jax.random.categorical`` draws. None for greedy (temperature 0): the
    caller keeps the exact argmax path."""
    if temperature <= 0.0:
        return None
    return lambda logits, noise: (_truncated(logits, temperature, top_k,
                                             top_p) + noise).argmax(-1).to(
                                                 torch.int32)


def _generator(device, *entropy: int) -> torch.Generator:
    """A generator on ``device`` seeded from non-negative ints (numpy's
    SeedSequence mixes them into one 64-bit seed)."""
    seed = int(np.random.SeedSequence(entropy).generate_state(1,
                                                              np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def gumbel_noise(gens: List[torch.Generator], shape, device) -> torch.Tensor:
    """[len(gens), *shape] fp32 standard Gumbel noise, row s drawn from
    ``gens[s]`` alone (one draw a generator, as JAX's ``-log(-log(u))``
    with u in [tiny, 1))."""
    u = torch.stack([torch.rand(*shape, generator=g, device=device)
                     for g in gens])
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def spec_accept(p: torch.Tensor, q: torch.Tensor, drafts: torch.Tensor,
                uniforms: torch.Tensor, noise: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual rejection sampling of one speculative round, a pure
    function. p [S, k + 1, V]: the target's probabilities at the verify
    rows; q [S, k, V]: the draft's at its proposals; drafts [S, k]; u
    ``uniforms`` [S, k] in [0, 1); Gumbel ``noise`` [S, k + 1, V].

    Proposal d_j is accepted iff u_j * q_j(d_j) < p_j(d_j); row j's
    correction is drawn from the residual (p_j - q_j)+, or from p_j itself
    when the residual's mass is <= 1e-9; the bonus after k acceptances from
    p_k. Returns (accept [S, k] bool, emit [S, k + 1] int32: the draft
    where accepted, else the correction; the bonus last)."""
    k = drafts.shape[1]
    idx = drafts.long()[..., None]
    pd = p[:, :k].gather(2, idx)[..., 0]
    qd = q.gather(2, idx)[..., 0]
    acc = uniforms * qd < pd
    resid = (p[:, :k] - q).clamp_min(0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p[:, :k])
    corr = (torch.log(resid) + noise[:, :k]).argmax(-1).to(torch.int32)
    bonus = (torch.log(p[:, k]) + noise[:, k]).argmax(-1).to(torch.int32)
    emit = torch.cat([torch.where(acc, drafts, corr), bonus[:, None]], dim=1)
    return acc, emit


class SlotEngine:
    """Continuous batching over ``capacity`` slots of a ``max_len`` cache.

    ``prompt_bucket``: prompts are right-padded up to the next multiple of
    this for prefill (the pad is masked by the per-slot lengths), so the
    prefill shapes come from a small set of buckets. Only all-attention
    archs without an MoE pad, as in the JAX engine: MoE and recurrent
    archs prefill at the exact prompt length. Pad tokens would route into
    the experts (the capacity per group scales with the padded length, so
    padding would change which tokens drop), and a recurrent layer would
    fold them into its state.
    ``chunk``: decode steps
    (speculative rounds under ``spec``) per chunk between two host fetches.

    ``paged``: attention state in pages of ``page_size`` positions from a
    pool of ``num_pages`` (default: the contiguous worst case, capacity x
    ceil(max_len / page_size), + 1 scratch page; shrink it to trade
    worst-case headroom for admission concurrency), for every arch: GQA
    K/V pages, MLA latent pages (the precise mode of ``attn_decode_paged``)
    and, beside the attention pages, slot-indexed recurrent state (Mamba,
    mLSTM, sLSTM). An arch with no attention layer stores nothing in
    pages: admission and page accounting run as in JAX. An exact-length
    prefill books ceil(prompt / page_size) pages.

    ``spec``: speculative decoding. The target may carry no exit heads
    (verification scores every position with full-model logits) and the
    draft must share its vocabulary; both must be GQA archs (the JAX
    package refuses verify for MLA) without recurrent layers (JAX refuses
    those too).

    ``prefix_sharing``: admission at the fork point (paged engines of
    all-attention GQA archs without an MoE, as in JAX): only the suffix a
    prompt does not share with a resident chain is prefilled, attending
    the shared pages in place (``prefill_into_shared``); its first token
    comes from the JAX package's fp32 suffix attention, where a full
    prefill runs the flash kernel. ``persistent_prefix_index``: ``serve()``
    parks its pool, refcounts and index in ``resident`` and the next
    ``serve()`` resumes them, so a prefix seen in one stream is shared in
    the next.

    ``gated``: decode through ``lm.forward_decode_gated`` (attention-only
    archs with one exit; contiguous engine, no ``spec``, as in JAX). It
    reads one boolean on the host a step, which the ungated step never
    does.

    ``temperature`` / ``top_k`` / ``top_p`` / ``sample_seed``: sampled
    decode (and sampled speculative decoding) through per-slot generators
    seeded from ``(sample_seed, slot)``; ``prefill_into(..., seed=)``
    gives a request a generator of its own. A slot's generator draws once
    a step (a round under ``spec``) while the chunk runs, live or not: the
    host does not read which slots finished mid-chunk. Temperature 0 is
    greedy and creates no generator.
    """

    def __init__(self, run: Union[RunConfig, ArchConfig], capacity: int,
                 max_len: int, chunk: int = 8, prompt_bucket: int = 16,
                 device="cuda", paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, gated: bool = False,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, sample_seed: int = 0,
                 prefix_sharing: bool = False,
                 persistent_prefix_index: bool = False):
        self.run = _as_run(run)
        cfg = self.run.arch
        # the fork-point prefill: prefix sharing and chunked prefill
        self.shared_prefill_ok = lm.shared_prefill_ok(cfg)
        if prefix_sharing:
            if not paged:
                raise ValueError("prefix sharing requires the paged engine: "
                                 "shared prefixes are mapped as refcounted "
                                 "KV pages")
            lm.check_shared_prefill(cfg)
        if persistent_prefix_index and not prefix_sharing:
            raise ValueError("a persistent prefix index needs "
                             "prefix_sharing=True")
        self.prefix_sharing = prefix_sharing
        self.persistent_prefix_index = persistent_prefix_index
        # (cache, state, allocator) parked by the last serve() call when the
        # index is persistent; the next scheduler pops it before reuse
        self.resident = None
        if gated:
            lm.check_gated(cfg)
            if paged:
                raise ValueError("gated decode is not page-aware (as in the "
                                 "JAX package): use the contiguous engine")
            if spec is not None:
                raise ValueError("speculative decoding is incompatible with "
                                 "gated decode: verification runs the full "
                                 "depth, there is no exit to gate on")
        self.gated = gated
        self.temperature, self.sample_seed = temperature, sample_seed
        self._sampler = make_sampler(temperature, top_k, top_p)
        self._probs = make_probs(temperature, top_k, top_p)
        self.spec = spec
        self.draft_cfg: Optional[ArchConfig] = None
        if spec is not None:
            if spec.k < 1:
                raise ValueError(f"spec.k must be >= 1, got {spec.k}")
            if max_len <= spec.k:
                raise ValueError(f"max_len {max_len} cannot hold the "
                                 f"{spec.k + 1} rows of one verify")
            dcfg = spec.draft_arch
            if isinstance(dcfg, str):
                dcfg = get_arch(dcfg)
            if cfg.recurrent or dcfg.recurrent:
                raise ValueError(f"speculative decoding needs all-attention "
                                 f"target and draft archs: "
                                 f"{lm.SPEC_RECURRENT}")
            if cfg.mla is not None or dcfg.mla is not None:
                raise ValueError("speculative decoding needs GQA target and "
                                 "draft archs: verify is not defined for "
                                 "MLA (as in the JAX package)")
            if cfg.early_exit is not None:
                raise ValueError("speculative decoding skips the exit merge, "
                                 "so an early-exit target would change "
                                 "tokens: strip its exit heads")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab {dcfg.vocab_size} != target "
                                 f"vocab {cfg.vocab_size}")
            if spec.share_params and dcfg != cfg:
                raise ValueError("share_params ties the draft to the "
                                 "target's weights: the draft arch must "
                                 "equal the target arch")
            self.draft_cfg = dcfg
        self.spec_k = spec.k if spec is not None else 0
        self.capacity = capacity
        self.max_len = max_len
        self.chunk = chunk
        pad_safe = not cfg.recurrent and cfg.moe is None
        self.prompt_bucket = prompt_bucket if pad_safe else 1
        self.device = resolve_device(device)
        self.paged = paged
        self.page_size = page_size
        self.max_pages = -(-max_len // page_size)
        self.num_pages = (num_pages if num_pages is not None
                          else capacity * self.max_pages + 1)
        if paged and self.num_pages < self.max_pages + 1:
            raise ValueError(f"a pool of {self.num_pages} pages cannot hold "
                             f"one max-length request ({self.max_pages} "
                             f"pages + the scratch page)")
        self._bounds = None
        if cfg.early_exit is not None:
            # layers run per exit index (the last entry: ran to the end)
            self._bounds = torch.tensor(
                tuple(cfg.early_exit.exit_layers) + (cfg.num_layers,),
                dtype=torch.float32, device=self.device)
        self.decode_calls = 0
        self.prefill_calls = 0
        # bucketed tokens pushed through prefill (proportional to its FLOPs;
        # a shared admission counts its suffix bucket, a chunk its length)
        self.prefill_tokens = 0
        # the engine owns the draft's weights and its contiguous slot cache
        self.draft_params = None
        self._draft_cache: Optional[lm.LMCache] = None
        if spec is not None and not spec.share_params:
            self.draft_params = lm.init_lm(self.draft_cfg, seed=spec.draft_seed,
                                           device=self.device)
        # chaos hook (serve/faults.py), installed by the restart supervisor
        self.injector = None
        # a paged all-attention engine snapshots its allocated pages only;
        # any other engine snapshots its whole cache
        self._page_snapshot_ok = paged and all(
            cfg.layer_spec(i).mixer == "attn" for i in range(cfg.num_layers))

    # -- device state ------------------------------------------------------

    @torch.inference_mode()
    def init_state(self):
        """Fresh (cache, DecodeState); under ``spec`` also a fresh draft
        cache, held by the engine. The draft cache has ``k`` positions more
        than ``max_len``: a round's draft steps run up to k positions past
        a slot's pinned position, and those writes must land somewhere
        (the JAX scatter drops them)."""
        if self.spec is not None:
            self._draft_cache = lm.init_cache(
                self.draft_cfg, self.capacity, self.max_len + self.spec_k,
                device=self.device)
        cfg = self.run.arch
        if self.paged:
            cache = lm.init_paged_cache(cfg, self.capacity, self.max_len,
                                        self.page_size, self.num_pages,
                                        device=self.device)
        else:
            cache = lm.init_cache(cfg, self.capacity, self.max_len,
                                  device=self.device)
        rng = (None if self._sampler is None else
               [_generator(self.device, self.sample_seed, slot)
                for slot in range(self.capacity)])
        return cache, init_decode_state(self.capacity, self.device, rng)

    @property
    def tokens_per_chunk(self) -> int:
        """Most tokens one chunk can realize per slot: what the scheduler's
        page growth must cover (chunk rounds x k + 1 rows under spec)."""
        return self.chunk * (self.spec_k + 1)

    # -- chaos injection ---------------------------------------------------

    def _check_fault(self, site: str) -> None:
        if self.injector is not None:
            self.injector.check(site)

    # -- admission ---------------------------------------------------------

    def _bucket(self, t: int) -> int:
        b = self.prompt_bucket
        return min(-(-t // b) * b, self.max_len)

    @torch.inference_mode()
    def prefill_into(self, params, cache, st: DecodeState, prompt, slot: int,
                     max_new: int, page_ids=None, seed: Optional[int] = None):
        """Admit one request: bucketed batch-1 prefill into ``slot``.
        prompt: 1-D ints. A paged engine also takes the host-allocated
        ``page_ids`` (one per bucket page, in position order): the
        contiguous prefill's KV is scattered into them. ``seed`` (a
        non-negative int; sampled engines only, greedy ignores it): the
        slot's generator is replaced by one seeded from it, so the request
        draws the same tokens whatever slot it lands in. ``cache`` and
        ``st`` are updated in place. Returns (cache, st, first_token) with
        the token on the device."""
        self._check_fault("prefill")
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        t = int(prompt.shape[0])
        if t + max_new > self.max_len:
            raise ValueError(f"prompt ({t}) + max_new ({max_new}) exceeds "
                             f"max_len ({self.max_len})")
        if (page_ids is not None) != self.paged:
            raise ValueError("page_ids are required iff the engine is paged")
        cfg, policy = self.run.arch, self.run.policy
        bucket = self._bucket(t)
        if self.paged:
            ids = torch.as_tensor(np.asarray(page_ids, np.int32))
            n_bucket = -(-bucket // self.page_size)
            if ids.shape != (n_bucket,):
                raise ValueError(f"{tuple(ids.shape)} page ids for a bucket "
                                 f"of {n_bucket} pages")
        padded = self._padded(prompt, bucket)
        slot_cache = lm.init_cache(cfg, 1, bucket, device=self.device)
        lengths = torch.tensor([t], dtype=torch.int32, device=self.device)
        logits, slot_cache = lm.forward_prefill(params, padded, cfg, policy,
                                                slot_cache, lengths=lengths)
        if self.paged:
            lm.fill_slot_paged(cache, slot_cache, slot, t,
                               ids.to(self.device))
        else:
            lm.fill_slot(cache, slot_cache, slot, t)
        tok0 = self._admit_slot(st, logits, slot, max_new, seed)
        self.prefill_calls += 1
        self.prefill_tokens += bucket
        if self.spec is not None:
            self._admit_draft(params, padded, t, slot)
        return cache, st, tok0

    def _padded(self, tokens, length: int) -> torch.Tensor:
        """[1, length] int32 on the device: ``tokens`` right-padded with
        0 (the pad is masked by the true length)."""
        padded = torch.zeros(1, length, dtype=torch.int32)
        padded[0, :len(tokens)] = torch.as_tensor(np.asarray(tokens),
                                                  dtype=torch.int32)
        return padded.to(self.device)

    def _admit_slot(self, st: DecodeState, logits: torch.Tensor, slot: int,
                    max_new: int, seed: Optional[int]) -> torch.Tensor:
        """Flip ``slot`` live in ``st`` (in place) with its first token,
        drawn from the prefill's logits [1, V]; returns the token."""
        if self._sampler is None:
            tok0 = logits[0].argmax(-1).to(torch.int32)
        else:
            if seed is not None:
                st.rng[slot] = _generator(self.device, seed)
            noise = gumbel_noise([st.rng[slot]], logits.shape[-1:],
                                 self.device)
            tok0 = self._sampler(logits, noise)[0]
        st.tokens[slot] = tok0
        st.done[slot] = max_new <= 1
        st.generated[slot] = 1
        st.budget[slot] = max_new
        st.quarantined[slot] = False
        return tok0

    # -- prefix-sharing admission and chunked prefill ----------------------

    def _check_shared(self) -> None:
        if not self.paged:
            raise ValueError("the fork-point prefill needs the paged engine")
        lm.check_shared_prefill(self.run.arch)

    @torch.inference_mode()
    def copy_page(self, cache: lm.PagedLMCache, src: int, dst: int
                  ) -> lm.PagedLMCache:
        """Copy-on-write: duplicate pool page ``src`` into the slot's
        exclusive page ``dst`` in every attention layer (in place)."""
        if not self.paged:
            raise ValueError("copy_page on a contiguous engine")
        return lm.copy_pages(cache, int(src), int(dst))

    def _shared_ctx(self, prefix_ids, region_ids, start: int, n_prefix: int,
                    true_len: int):
        ids = [torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                               device=self.device)
               for a in (prefix_ids, region_ids)]
        return SharedPrefillCtx(ids[0], ids[1], start, n_prefix, true_len)

    @torch.inference_mode()
    def prefill_into_shared(self, params, cache, st: DecodeState, prompt,
                            start: int, slot: int, max_new: int, prefix_ids,
                            region_ids, row, seed: Optional[int] = None):
        """Admit one request at its FORK POINT: only ``prompt[start:]``
        (right-padded to its bucket) is prefilled; positions [0, start) are
        already resident in the shared ``prefix_ids`` pages plus the first
        ``start mod page_size`` rows of the COW page ``region_ids[0]``
        (copied by ``copy_page`` before this call). ``row`` is the slot's
        complete host mirror page-table row, written into the device table
        here. Under ``spec`` the draft's contiguous cache is filled from
        the WHOLE prompt (the draft keeps no index). Returns (cache, st,
        first_token) with the token on the device."""
        self._check_fault("prefill")
        self._check_shared()
        prompt = np.asarray(prompt, np.int32)
        t = int(prompt.shape[0])
        if not 0 < start < t or t + max_new > self.max_len:
            raise ValueError(f"fork point {start} of a {t}-token prompt "
                             f"(+ {max_new} new, max_len {self.max_len})")
        n_prefix = len(np.asarray(prefix_ids).reshape(-1)) * self.page_size
        if not n_prefix <= start < n_prefix + self.page_size:
            raise ValueError(f"fork point {start} is not in the page after "
                             f"the {n_prefix} shared positions")
        suffix_bucket = self._bucket(t - start)
        ctx = self._shared_ctx(prefix_ids, region_ids, start, n_prefix, t)
        logits, cache = lm.forward_prefill_shared(
            params, self._padded(prompt[start:], suffix_bucket),
            self.run.arch, self.run.policy, cache, slot, ctx, row)
        tok0 = self._admit_slot(st, logits, slot, max_new, seed)
        self.prefill_tokens += suffix_bucket
        if self.spec is not None:
            self._admit_draft(params, self._padded(prompt, self._bucket(t)),
                              t, slot)
        return cache, st, tok0

    @torch.inference_mode()
    def prefill_chunk(self, params, cache, chunk_tokens, start: int,
                      slot: int, prefix_ids, region_ids, row):
        """Run ONE intermediate chunk of a chunked prefill (no admission,
        no logits): ``chunk_tokens`` (C tokens, C a multiple of the page
        size, ``start`` a multiple of C) at absolute positions [start,
        start + C) against the slot's resident pages ``prefix_ids`` (all
        full: ``len(prefix_ids) * page_size == start``), written into the
        next ``region_ids`` (C / page_size pages). ``row`` is the slot's
        complete mirror page-table row. The prompt's last chunk goes
        through ``prefill_into_shared``, which admits the slot. Returns
        the cache."""
        self._check_fault("prefill")
        self._check_shared()
        chunk = np.asarray(chunk_tokens, np.int32).reshape(-1)
        c_len, ps = int(chunk.shape[0]), self.page_size
        n_full = len(np.asarray(prefix_ids).reshape(-1))
        n_region = len(np.asarray(region_ids).reshape(-1))
        if (c_len == 0 or c_len % ps or start % c_len or n_full * ps != start
                or n_region != c_len // ps):
            raise ValueError(f"a chunk of {c_len} tokens at {start} needs "
                             f"page-aligned bounds, {start // ps} resident "
                             f"pages and {c_len // ps} region pages (got "
                             f"{n_full} and {n_region})")
        ctx = self._shared_ctx(prefix_ids, region_ids, start, start,
                               start + c_len)
        _, cache = lm.forward_prefill_shared(
            params, self._padded(chunk, c_len), self.run.arch,
            self.run.policy, cache, slot, ctx, row, head=False)
        self.prefill_tokens += c_len
        return cache

    def _admit_draft(self, params, padded: torch.Tensor, t: int,
                     slot: int) -> None:
        """Prefill the full prompt into the draft's contiguous slot cache.
        Only its KV and the slot position matter: a round's first draft
        step starts from the target's last emitted token."""
        dcfg, policy = self.draft_cfg, self.run.policy
        dparams = params if self.spec.share_params else self.draft_params
        slot_cache = lm.init_cache(dcfg, 1, padded.shape[1],
                                   device=self.device)
        lengths = torch.tensor([t], dtype=torch.int32, device=self.device)
        _, slot_cache = lm.forward_prefill(dparams, padded, dcfg, policy,
                                           slot_cache, lengths=lengths)
        lm.fill_slot(self._draft_cache, slot_cache, slot, t)

    def set_draft_params(self, dparams) -> None:
        """Install other draft weights (e.g. a trained draft) of the
        configured draft arch's tree, shapes and dtypes."""
        if self.spec is None or self.spec.share_params:
            raise ValueError("the engine has no independent draft model")

        def same(a, b):
            if isinstance(a, dict):
                return (isinstance(b, dict) and a.keys() == b.keys()
                        and all(same(a[k], b[k]) for k in a))
            if isinstance(a, (tuple, list)):
                return (isinstance(b, (tuple, list)) and len(a) == len(b)
                        and all(same(x, y) for x, y in zip(a, b)))
            return (isinstance(b, torch.Tensor) and a.shape == b.shape
                    and a.dtype == b.dtype)

        if not same(self.draft_params, dparams):
            raise ValueError("draft parameters do not match the configured "
                             "draft arch")
        self.draft_params = dparams

    # -- paged page table --------------------------------------------------

    @torch.inference_mode()
    def set_page_table(self, cache: lm.PagedLMCache,
                       table: np.ndarray) -> lm.PagedLMCache:
        """Copy the host mirror of the page table into the device cache (in
        place, between chunks: the table is data, never shape)."""
        if not self.paged:
            raise ValueError("set_page_table on a contiguous engine")
        cache.page_table.copy_(torch.from_numpy(np.asarray(table, np.int32)))
        return cache

    @torch.inference_mode()
    def scrub_slot_kv(self, cache, slot: int, page_ids=None):
        """Zero a quarantined slot's KV (its row, or on a paged engine its
        ``page_ids`` in every attention pool, GQA or MLA) before it is
        reused: masked softmax weights are exactly 0 and 0 * NaN = NaN, so
        poisoned KV would leak into its next occupant. A paged slot's
        recurrent state is left to the next ``fill_slot_paged``, which
        rewrites it whole."""
        if not self.paged:
            return lm.reset_slot(cache, slot)
        ids = torch.as_tensor(list(page_ids or ()), dtype=torch.long,
                              device=self.device)
        for pool in cache.pools:
            pool[:, ids] = 0
        return cache

    # -- preemption: host swap and slot resume -----------------------------
    #
    # The JAX engine pads the page ids to a power of two so that swaps of
    # any page count share one jit trace; nothing here is traced, so the
    # port gathers and scatters the exact ids (a deliberate divergence: no
    # pad blocks ride along, and nothing is written to the scratch page).

    def _page_ids(self, page_ids) -> torch.Tensor:
        if not self.paged:
            raise ValueError("page swap on a contiguous engine")
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size == 0 or ids.size > self.max_pages or (ids < 1).any() \
                or (ids >= self.num_pages).any():
            raise ValueError(f"page ids {ids.tolist()} are not 1..."
                             f"{self.max_pages} pool pages of "
                             f"{self.num_pages}")
        return torch.as_tensor(ids, device=self.device)

    @torch.inference_mode()
    def fetch_pages(self, cache: lm.PagedLMCache, page_ids):
        """SWAP-OUT: gather the pool pages ``page_ids`` (position order)
        from every attention layer in one batched gather a pool on the
        device, then copy the blocks to host memory (pinned on a card) and
        wait for the copy. Returns the blocks (``lm.gather_pages``'s
        structure, on the host); None for an arch without a pool."""
        self._check_fault("swap")
        blocks = lm.gather_pages(cache, self._page_ids(page_ids))
        if blocks is None:
            return None
        host = _map_state(blocks, self._to_host)
        self._host_sync()
        return host

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` that aliases nothing (pinned on a card,
        asynchronous there: :meth:`_host_sync` before reading it)."""
        pin = self.device.type == "cuda"
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(
            t, non_blocking=pin)

    def _host_sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @torch.inference_mode()
    def restore_pages(self, cache: lm.PagedLMCache, page_ids, blocks
                      ) -> lm.PagedLMCache:
        """SWAP-IN: write ``blocks`` (a :meth:`fetch_pages` result) into
        the FRESH pool pages ``page_ids``, in place: the same position
        order, possibly other ids than at swap-out."""
        return lm.scatter_pages(cache, self._page_ids(page_ids), blocks)

    @torch.inference_mode()
    def restore_slot(self, cache, st: DecodeState, slot: int, token: int,
                     budget: int, pos: int, rng_state=None):
        """Re-arm ``slot`` after a swap-in, in place: the last generated
        ``token`` is the next decode input, ``budget`` tokens remain (the
        generated count restarts at 0), the cache position is the one KV
        row not yet written (the last token's), and with ``rng_state``
        (``torch.Generator.get_state()`` of the victim's generator, saved
        at swap-out) the slot draws from a generator set to it, so a
        sampled request goes on with its uninterrupted stream. Returns
        (cache, st)."""
        st.tokens[slot] = int(token)
        st.done[slot] = budget <= 0
        st.generated[slot] = 0
        st.budget[slot] = int(budget)
        st.quarantined[slot] = False
        if rng_state is not None:
            if st.rng is None:
                raise ValueError("a generator state for a greedy engine")
            st.rng[slot] = torch.Generator(device=self.device)
            st.rng[slot].set_state(rng_state)
        cache.pos[slot] = int(pos)
        return cache, st

    @torch.inference_mode()
    def deactivate_slot(self, st: DecodeState, slot: int) -> DecodeState:
        """Kill a preempted or stopped slot on the device: mark it done,
        so the next decode chunk freezes its token, pins its cache
        position and masks it out of MoE routing. On a paged engine its
        page-table row is cleared by the host (appends go to the scratch
        page); the next admission rewrites the rest."""
        st.done[slot] = True
        return st

    # -- decode ------------------------------------------------------------

    def _step(self, params, cache, st: DecodeState):
        cfg, policy = self.run.arch, self.run.policy
        live = ~st.done
        if self.gated:
            logits, exited, new_cache = lm.forward_decode_gated(
                params, st.tokens[:, None], cfg, policy, cache, live=live)
            # gated compute is credited only where the skip ran (every live
            # slot exited); otherwise the full depth ran and nothing saved
            skipped = (exited | ~live).all()
            saved = 1.0 - cfg.early_exit.exit_layers[0] / cfg.num_layers
            gated_frac = torch.where(exited & skipped, saved, 0.0)
        else:
            logits, exit_lgs, new_cache = lm.forward_decode(
                params, st.tokens[:, None], cfg, policy, cache, live=live)
            logits, exit_idx = _select(logits, exit_lgs, cfg, policy)
            if exit_idx is not None:
                exited = exit_idx < len(exit_lgs)
                gated_frac = (1.0 - self._bounds[exit_idx.long()]
                              / cfg.num_layers)
            else:
                exited = torch.zeros_like(st.done)
                gated_frac = torch.zeros(st.done.shape, device=self.device)
        if self._sampler is None:
            next_tok = logits.argmax(-1).to(torch.int32)
        else:
            next_tok = self._sampler(logits, gumbel_noise(
                st.rng, logits.shape[-1:], self.device))
        # NaN/Inf logit guard: a live slot whose logits went non-finite is
        # frozen, marked done and flagged — only that slot: rows never read
        # each other's KV, so co-batched requests are untouched
        bad = live & ~torch.isfinite(logits.float()).all(dim=-1)
        ok = live & ~bad
        next_tok = torch.where(ok, next_tok, st.tokens)
        # pin the positions of done/empty slots (their KV write lands one
        # past the valid prefix and is overwritten before it could be read)
        new_cache = new_cache._replace(
            pos=torch.where(live, new_cache.pos, cache.pos))
        generated = st.generated + ok.to(torch.int32)
        live_f = live.float()
        st = st._replace(
            tokens=next_tok,
            done=st.done | (generated >= st.budget) | bad,
            generated=generated,
            exit_cnt=st.exit_cnt + (exited.float() * live_f).sum(),
            gated_layers=st.gated_layers + (gated_frac * live_f).sum(),
            live_cnt=st.live_cnt + live_f.sum(),
            quarantined=st.quarantined | bad,
            realized=st.realized + ok.float().sum())
        return new_cache, st

    def _spec_round(self, params, dparams, cache, dcache: lm.LMCache,
                    st: DecodeState):
        """One speculative round over all slots, greedy or sampled. Returns
        (cache, dcache, st, emit [S, k + 1], n_real [S]): slot s emitted the
        first n_real[s] entries of its emit row."""
        cfg, dcfg, policy, k = (self.run.arch, self.draft_cfg,
                                self.run.policy, self.spec_k)
        live = ~st.done
        if self._sampler is not None:
            # each slot's draws of the round from its own generator, in one
            # order: Gumbel noise for the k proposals and the k + 1
            # correction / bonus rows, then the k acceptance uniforms
            noise = gumbel_noise(st.rng, (2 * k + 1, cfg.vocab_size),
                                 self.device)
            uniforms = torch.stack([torch.rand(k, generator=g,
                                               device=self.device)
                                    for g in st.rng])
        # the draft's positions are re-synced to the target's every round,
        # so a stale draft row can only lower acceptance, never the output.
        # k proposals from the last emitted token, then ONE more step that
        # only ingests d_k's KV: a fully accepted round moves the target
        # past d_k, and the next round's proposals must see its row
        dc = dcache._replace(pos=cache.pos)
        cur, props, qs = st.tokens, [], []
        for j in range(k + 1):
            dlg, _, dc = lm.forward_decode(dparams, cur[:, None], dcfg,
                                           policy, dc, with_exits=False)
            if j == k:
                break
            dlg = dlg.float()
            dlg = torch.where(torch.isfinite(dlg), dlg, -1e30)
            if self._sampler is None:
                cur = dlg.argmax(-1).to(torch.int32)
            else:
                qs.append(self._probs(dlg))
                cur = (torch.log(qs[-1]) + noise[:, j]).argmax(-1).to(
                    torch.int32)
            props.append(cur)
        dmat = torch.stack(props, dim=1)                     # [S, k]
        vtok = torch.cat([st.tokens[:, None], dmat], dim=1)  # [S, k + 1]
        vlg, cache = lm.forward_verify(params, vtok, cfg, policy, cache)
        vlg = vlg.float()
        finite = torch.isfinite(vlg).all(dim=-1)             # [S, k + 1]
        if self._sampler is None:
            emit = vlg.argmax(-1).to(torch.int32)
            acc = dmat == emit[:, :k]
        else:
            acc, emit = spec_accept(self._probs(vlg), torch.stack(qs, dim=1),
                                    dmat, uniforms, noise[:, k:])
        acc = finite[:, :k] & acc
        # a consecutive accepts, then one correction / bonus row (emitted
        # only if its logits are finite), clipped to the budget
        a = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1,
                                                        dtype=torch.int32)
        n_acc = a + finite.gather(1, a[:, None].long())[:, 0].to(torch.int32)
        n_real = torch.where(live, torch.minimum(n_acc, st.budget
                                                 - st.generated), 0)
        bad = live & (n_acc == 0)          # row 0 non-finite: quarantine
        ok = live & ~bad
        last = emit.gather(1, (n_real - 1).clamp(min=0)[:, None].long())[:, 0]
        # forward_verify leaves pos unchanged: advance accepted slots by
        # their realized count and pin everyone else
        pos = torch.where(ok, cache.pos + n_real, cache.pos)
        generated = st.generated + n_real
        okf = ok.float()
        st = st._replace(
            tokens=torch.where(ok, last, st.tokens),
            done=st.done | (generated >= st.budget) | bad,
            generated=generated,
            live_cnt=st.live_cnt + live.float().sum(),
            quarantined=st.quarantined | bad,
            realized=st.realized + n_real.float().sum(),
            spec_prop=st.spec_prop + k * okf.sum(),
            spec_acc=st.spec_acc + (a.float() * okf).sum())
        return (cache._replace(pos=pos), dc._replace(pos=pos), st, emit,
                n_real)

    @torch.inference_mode()
    def decode(self, params, cache, st: DecodeState):
        """Run one chunk of ``chunk`` decode steps (speculative rounds) over
        all slots. Returns (cache, st, tokens [S, tokens_per_chunk]) with
        everything on the device; slot s's valid tokens are the first
        (generated delta), left-packed in emission order."""
        self._check_fault("decode")
        self.decode_calls += 1
        if self.spec is None:
            toks = torch.empty(self.capacity, self.chunk, dtype=torch.int32,
                               device=self.device)
            for i in range(self.chunk):
                cache, st = self._step(params, cache, st)
                toks[:, i] = st.tokens
            return cache, st, toks
        dparams = params if self.spec.share_params else self.draft_params
        emits, nreal = [], []
        for _ in range(self.chunk):
            cache, self._draft_cache, st, emit, n_real = self._spec_round(
                params, dparams, cache, self._draft_cache, st)
            emits.append(emit)
            nreal.append(n_real)
        emits = torch.stack(emits, dim=1)                # [S, chunk, k + 1]
        k1 = emits.shape[2]
        valid = (torch.arange(k1, device=self.device)[None, None, :]
                 < torch.stack(nreal, dim=1)[:, :, None]).flatten(1)
        # left-pack the valid tokens in emission order (stable sort on the
        # invalid flag), so the scheduler reads toks[slot, :generated delta]
        order = torch.sort((~valid).to(torch.int8), dim=1, stable=True)[1]
        return cache, st, emits.flatten(1).gather(1, order)

    # -- snapshot / restore ------------------------------------------------

    @torch.inference_mode()
    def snapshot(self, cache, st: DecodeState, alloc=None) -> dict:
        """Copy the device half of a serve stream to host memory owned by
        the snapshot (call between chunks): every ``DecodeState`` tensor,
        each slot generator's ``get_state()``, the draft's contiguous
        cache on a speculative engine and the cache. A paged all-attention
        engine copies only the allocated pool pages (``sorted(alloc.refcnt)``:
        slot-owned and index-held alike) through ``fetch_pages``, in
        groups of ``max_pages`` (exact ids, no pow2 pad: see
        ``fetch_pages``), plus ``pos``; every other engine (contiguous
        rows, MLA latents, Mamba / mLSTM / sLSTM state, a hybrid's pages)
        copies its whole cache. Restorable any number of times."""
        state = {"tensors": _map_state(st._replace(rng=None), self._to_host),
                 "rng": (None if st.rng is None
                         else [g.get_state() for g in st.rng])}
        draft = (_map_state(self._draft_cache, self._to_host)
                 if self.spec is not None else None)
        if self._page_snapshot_ok and alloc is not None:
            pids = sorted(alloc.refcnt)
            groups = [pids[i:i + self.max_pages]
                      for i in range(0, len(pids), self.max_pages)]
            snap = {"kind": "paged", "pos": self._to_host(cache.pos),
                    "pages": [(g, self.fetch_pages(cache, g))
                              for g in groups]}
        else:
            snap = {"kind": "full", "cache": _map_state(cache, self._to_host)}
        self._host_sync()
        return dict(snap, state=state, draft=draft)

    @torch.inference_mode()
    def restore(self, snap: dict, cache, alloc=None):
        """Write a :meth:`snapshot` back over the live ``cache`` (and the
        draft's) IN PLACE, so recovery allocates no second cache: every
        buffer the next chunk reads is bitwise the captured one, whatever
        a half-finished step wrote after the snapshot, and the resumed
        stream replays the uninterrupted run's tokens (greedy and sampled:
        the generators come back with ``set_state``). A paged snapshot
        zeroes the pool pages it does not hold (a page freed since may
        hold a quarantined slot's NaN, which a masked read would still
        spread), writes its own pages back and pushes ``alloc``'s mirror
        table to the device. Returns (cache, a fresh DecodeState: a few
        scalars a slot). Nothing of the snapshot is aliased."""
        rng = None
        if snap["state"]["rng"] is not None:
            rng = []
            for s in snap["state"]["rng"]:
                g = torch.Generator(device=self.device)
                g.set_state(s)
                rng.append(g)
        st = _map_state(snap["state"]["tensors"],
                        lambda t: t.to(self.device, copy=True))
        st = st._replace(rng=rng)
        if self.spec is not None and snap["draft"] is not None:
            _copy_state(self._draft_cache, snap["draft"])
        if snap["kind"] == "paged":
            if alloc is None:
                raise ValueError("a paged restore needs the allocator")
            held = {p for group, _ in snap["pages"] for p in group}
            unheld = torch.as_tensor(
                [p for p in range(self.num_pages) if p not in held],
                dtype=torch.long, device=self.device)
            for pool in cache.pools:
                pool.index_fill_(1, unheld, 0)
            for group, blocks in snap["pages"]:
                self.restore_pages(cache, group, blocks)
            self.set_page_table(cache, alloc.table)
            cache.pos.copy_(snap["pos"])
        else:
            _copy_state(cache, snap["cache"])
        return cache, st

    @staticmethod
    def stats(st: DecodeState) -> Dict[str, float]:
        """One host fetch of the on-device accumulators."""
        n = max(float(st.live_cnt), 1.0)
        prop = float(st.spec_prop)
        return {"exit_rate": float(st.exit_cnt) / n,
                "gated_fraction": float(st.gated_layers) / n,
                "decode_slot_steps": float(st.live_cnt),
                "realized_tokens": float(st.realized),
                "spec_proposed": prop,
                "spec_accepted": float(st.spec_acc),
                "spec_acceptance": float(st.spec_acc) / max(prop, 1.0)}
