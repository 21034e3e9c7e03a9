"""Overload control (port of ``repro.serve.overload``): priority-aware
preemptive scheduling over the slot engine, with a host-swap page pool and
chunked prefill.

The base :class:`repro_torch.serve.scheduler.SlotScheduler` degrades hard
under overload: admission reserves every request's WORST-CASE page count,
so a saturated pool turns new arrivals away (FULL) even though most
admitted requests never grow near their reservation. This module degrades
gracefully instead, with three mechanisms in one subclass:

1. OPTIMISTIC ADMISSION + PREEMPTION (``mode="preempt"``): the allocator
   admits on the pages mapped RIGHT NOW (``PageAllocator(optimistic=True)``)
   and on-demand growth may run dry (:class:`PoolExhausted`). Then a
   :class:`PreemptionPolicy` picks a victim (lowest priority first, then
   most pages: frees the most, then least progress: wastes the least),
   whose pages are released or SWAPPED to host memory
   (:class:`HostSwapPool`; one batched gather a pool and one copy to the
   host per victim) and whose request is re-queued with its generated
   tokens kept. A resumed request either has its swapped pages written
   back into fresh pool pages and its slot re-armed (same generator
   state, same cache position: the continuation is the uninterrupted one,
   sampled too), or, when the swap budget is spent or the arch keeps
   recurrent state, re-prefills ``prompt ++ generated`` through the
   ordinary (prefix-sharing-aware) admission with the REMAINING budget,
   which gives the same continuation under greedy decoding.

2. PRIORITY CLASSES + PER-REQUEST SLOs: admission is a priority queue over
   fresh arrivals and preempted re-queues, ordered by EFFECTIVE priority
   ``priority + queue_time / AGING_S`` (aging: a starved low-priority
   request eventually outranks fresh high-priority work). A high-priority
   arrival that finds the batch full may preempt a victim of STRICTLY lower
   raw priority. Requests with ``slo_ttft_ms`` / ``deadline_ms`` are shed
   from the queue the moment the SLO is already missed or provably
   infeasible (an EWMA of the decode time a token); every shed sets
   ``Request.reject_reason``.

3. CHUNKED PREFILL (``prefill_chunk=C``, page-aligned): a long prompt is
   admitted as C-token prefill chunks interleaved with the decode chunks
   of the running requests, so a long prompt stalls its neighbours by one
   chunk, not by its whole prefill. Intermediate chunks run
   ``SlotEngine.prefill_chunk`` (no LM head); the last suffix goes
   through ``prefill_into_shared``, which gives the first token and
   activates the slot.

``mode="reject"`` keeps the worst-case reservation and never preempts: the
reject-only comparator, with the same priority queue and sheds, so a
comparison isolates preemption itself.

Swap, re-arm and chunked admission all run between decode chunks (in the
admission round and in ``_grow_pages``); the decode step reads nothing on
the host.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve.paging import PoolExhausted
from repro_torch.serve.scheduler import (ADMITTED, FULL, REASON_DEADLINE,
                                         REASON_SHED, REASON_TOO_LONG,
                                         REASON_TTFT, REJECTED, Request,
                                         SlotScheduler, reject_reason)


# Fixed policy values. The JAX package exposes each as an OverloadConfig
# field, but nothing sets any of them to another value, so the port keeps
# one value each.
SWAP_BYTES = 256 << 20      # host budget for swapped page blocks
AGING_S = 2.0               # queue seconds per +1 effective priority
MAX_PREEMPTIONS = 3         # per-request churn bound


@dataclass(frozen=True)
class OverloadConfig:
    """Knobs of the overload-control subsystem (see the module docstring)."""
    mode: str = "preempt"           # "preempt" | "reject" (baseline)
    swap: bool = True               # host-swap victims (else re-prefill)
    prefill_chunk: int = 0          # 0 = off; else page-aligned chunk C

    def __post_init__(self):
        if self.mode not in ("preempt", "reject"):
            raise ValueError(f"overload mode {self.mode!r}: 'preempt' or "
                             f"'reject'")
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk {self.prefill_chunk} must be "
                             f">= 0")


class PreemptionPolicy:
    """Victim ranking: lowest priority first, then most pages owned (one
    preemption frees the most), then fewest generated tokens (the least
    work is thrown away or swapped)."""

    def pick(self, candidates: List[Tuple[int, Request, int, int]]
             ) -> Optional[int]:
        """candidates: (slot, request, pages owned, generated). Returns the
        victim slot, or None."""
        if not candidates:
            return None
        return min(candidates,
                   key=lambda c: (c[1].priority, -c[2], c[3], c[0]))[0]


@dataclass
class _SwapRecord:
    page_ids: List[int]     # position order at swap-out (the count matters;
                            # a resume maps fresh ids)
    blocks: object          # host blocks from SlotEngine.fetch_pages
    # the victim's torch.Generator state (sampling engines; None greedy):
    # JAX saves the slot's u32[2] PRNG row here
    rng_state: Optional[torch.Tensor]
    nbytes: int


class HostSwapPool:
    """Budget-bounded host store of swapped-out page blocks. ``put``
    refuses (-> recompute resume) rather than evicting: a dropped record
    would silently change a sampled request's continuation."""

    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self.used = 0
        self.peak = 0
        self._recs: Dict[int, _SwapRecord] = {}

    def put(self, rid: int, rec: _SwapRecord) -> bool:
        if self.used + rec.nbytes > self.budget:
            return False
        self._recs[rid] = rec
        self.used += rec.nbytes
        self.peak = max(self.peak, self.used)
        return True

    def pop(self, rid: int) -> Optional[_SwapRecord]:
        rec = self._recs.pop(rid, None)
        if rec is not None:
            self.used -= rec.nbytes
        return rec

    def __len__(self) -> int:
        return len(self._recs)


@dataclass
class _Resume:
    """A preempted (or chunk-preempted) request waiting to re-enter."""
    req: Request
    resume_prompt: np.ndarray   # original prompt ++ every generated token
    remaining: int              # budget left (max_new - len(tokens))
    swap: Optional[_SwapRecord] = None


@dataclass
class _Prefill:
    """A slot part-way through a chunked prefill (not yet decoding)."""
    req: Request
    done: int                   # prompt tokens whose KV is resident


def _nbytes(blocks) -> int:
    return sum(t.numel() * t.element_size() for t in blocks or ())


class OverloadScheduler(SlotScheduler):
    """Priority-aware preemptive scheduler (see the module docstring)."""

    def __init__(self, engine, params, cfg: OverloadConfig):
        # the instance attribute shadows the class flag BEFORE
        # super().__init__ builds the allocator
        self._optimistic = cfg.mode == "preempt" and engine.paged
        super().__init__(engine, params)
        self.cfg = cfg
        self.policy = PreemptionPolicy()
        self.requeued: deque = deque()          # _Resume entries
        self.prefilling: Dict[int, _Prefill] = {}
        self.swap_pool = HostSwapPool(SWAP_BYTES)
        # swap needs every per-slot state in pages: attention KV is, a
        # recurrent mixer's state is not, so those archs resume by
        # re-prefilling instead
        self._swap_ok = (cfg.swap and engine.paged
                         and all(b.mixer == "attn"
                                 for b in engine.run.arch.block_pattern))
        self._chunk_ok = (cfg.prefill_chunk > 0 and engine.paged
                          and engine.shared_prefill_ok)
        if cfg.prefill_chunk % engine.page_size:
            raise ValueError(f"prefill_chunk {cfg.prefill_chunk} is not a "
                             f"multiple of the page size {engine.page_size}")
        self._tok_s: Optional[float] = None     # EWMA decode s / token
        self.n_preempted = 0
        self.n_swap_outs = 0
        self.n_swap_resumes = 0
        self.n_recompute_resumes = 0
        self.n_shed_ttft = 0
        self.n_shed_deadline = 0
        self.n_chunked = 0

    # -- priority queue ----------------------------------------------------

    def _eff_priority(self, req: Request, now: float) -> float:
        return req.priority + max(0.0, now - req.arrival) / AGING_S

    def _shed(self, waiting: deque, now: float) -> bool:
        progressed = False
        for req in [r for r in waiting
                    if r.slo_ttft_ms is not None
                    and (now - r.arrival) * 1e3 > r.slo_ttft_ms]:
            req.reject_reason = reject_reason(
                REASON_TTFT,
                f"TTFT SLO {req.slo_ttft_ms:.0f} ms already missed "
                f"after {(now - req.arrival) * 1e3:.0f} ms in queue")
            waiting.remove(req)
            self.n_shed_ttft += 1
            progressed = True
        if self._tok_s is not None:
            def infeasible(req, todo):
                if req.deadline_ms is None:
                    return False
                est = (now - req.arrival) + todo * self._tok_s
                return est * 1e3 > req.deadline_ms
            for req in [r for r in waiting
                        if infeasible(r, r.max_new_tokens)]:
                req.reject_reason = reject_reason(
                    REASON_DEADLINE,
                    f"deadline {req.deadline_ms:.0f} ms infeasible "
                    f"({req.max_new_tokens} tokens to go at "
                    f"{self._tok_s * 1e3:.1f} ms/token)")
                waiting.remove(req)
                self.n_shed_deadline += 1
                progressed = True
            for ent in [e for e in self.requeued
                        if infeasible(e.req, e.remaining)]:
                ent.req.reject_reason = reject_reason(
                    REASON_DEADLINE,
                    f"deadline {ent.req.deadline_ms:.0f} ms infeasible "
                    f"after preemption ({ent.remaining} tokens to go at "
                    f"{self._tok_s * 1e3:.1f} ms/token)")
                self.requeued.remove(ent)
                self.swap_pool.pop(ent.req.rid)
                self.n_shed_deadline += 1
                progressed = True
        return progressed

    def admission_round(self, waiting: deque, now: float,
                        realtime: bool) -> bool:
        progressed = self._shed(waiting, now)
        cands: List[tuple] = []
        for req in waiting:
            if realtime and req.arrival > now:
                continue
            # (effective priority desc, resumes before fresh at a tie,
            # FIFO, stable)
            cands.append((-self._eff_priority(req, now), 1, req.arrival,
                          req.rid, None, req))
        for ent in self.requeued:
            cands.append((-self._eff_priority(ent.req, now), 0,
                          ent.req.arrival, ent.req.rid, ent, ent.req))
        cands.sort(key=lambda c: c[:4])
        for _, _, _, _, ent, req in cands:
            if ent is None:
                res = self._admit_or_preempt(
                    lambda: self._admit_fresh(req, now), req, now)
            else:
                res = self._admit_or_preempt(
                    lambda: self._resume(ent, now), req, now)
            if res == FULL and not self.occupant and not self.prefilling \
                    and self.free:
                # an idle batch offers every page there is: FULL is forever
                req.reject_reason = reject_reason(
                    REASON_SHED, "unservable: needs more pages than an "
                    "idle pool can provide")
                res = REJECTED
            if res != FULL:
                if ent is None:
                    waiting.remove(req)
                else:
                    self.requeued.remove(ent)
                    if res == REJECTED:
                        self.swap_pool.pop(req.rid)
                progressed = True
        return progressed

    def _admit_or_preempt(self, admit_fn, req: Request, now: float) -> str:
        res = admit_fn()
        if res == FULL and self.cfg.mode == "preempt":
            victim = self._pick_victim(max_priority=req.priority)
            if victim is not None:
                self._preempt(victim, now)
                res = admit_fn()
        return res

    # -- admission ---------------------------------------------------------

    def _admit_fresh(self, req: Request, now: float) -> str:
        t = int(len(req.prompt))
        if self._chunk_ok and t > self.cfg.prefill_chunk \
                and self._want_chunked(req, t):
            if self._headroom_short(self.cfg.prefill_chunk):
                return FULL
            return self._start_chunked(req, now, t)
        if self._headroom_short(t):
            return FULL
        return self.admit(req, max(now, req.arrival))

    def _headroom_short(self, first_tokens: int) -> bool:
        """Growth-headroom gate for FRESH optimistic admissions: defer
        (without preempting) unless the pool holds the request's first
        prefill region PLUS one growth page per in-flight request. An idle
        pool needs no headroom, so the unservable guard is unaffected;
        resumes are exempt (blocking a victim's return only lengthens the
        churn this gate is there to stop). Every occupant wants another
        page within one page of decode, so admitting into that reserve
        turns straight into forced-preemption churn."""
        if not (self.alloc is not None and self.alloc.optimistic):
            return False
        need = self.alloc.pages_for(
            min(self.engine._bucket(first_tokens), self.engine.max_len))
        headroom = len(self.occupant) + len(self.prefilling)
        return self.alloc.available < need + headroom

    def _want_chunked(self, req: Request, t: int) -> bool:
        """Chunk only when the prefix index cannot already absorb most of
        the prompt: a fork-point admission prefills just the suffix, which
        bounds the stall better AND keeps the sharing."""
        if self.alloc is None or self.alloc.index is None:
            return True
        pages, boundary, rem = self.alloc.match(np.asarray(req.prompt))
        if boundary is None:
            rem = 0
        start = len(pages) * self.engine.page_size + rem
        return t - start > self.cfg.prefill_chunk

    def _start_chunked(self, req: Request, now: float, t: int) -> str:
        C = self.cfg.prefill_chunk
        if t + req.max_new_tokens > self.engine.max_len:
            req.reject_reason = reject_reason(
                REASON_TOO_LONG,
                f"prompt ({t}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds engine max_len ({self.engine.max_len})")
            return REJECTED
        if not self.free:
            return FULL
        # the last suffix prefills a BUCKET-padded region, which can
        # overshoot pages_for(t + max_new): the worst case a chunked slot
        # must reserve (growth must never outrun a reservation)
        ps = self.engine.page_size
        final_start = ((t - 1) // C) * C
        last = min(final_start + self.engine._bucket(t - final_start),
                   self.engine.max_len)
        need = max(self.alloc.pages_for(C),
                   self.alloc.pages_for(t + req.max_new_tokens),
                   final_start // ps + self.alloc.pages_for(
                       last - final_start))
        if self.alloc.optimistic:
            if not self.alloc.can_admit(C, t, req.max_new_tokens):
                return FULL
        elif need > self.alloc.available:
            return FULL
        slot = self.free.popleft()
        ids = self.alloc.admit(slot, C, t, req.max_new_tokens)
        if not self.alloc.optimistic:
            self.alloc.reserved[slot] = need      # checked against available
        prompt = np.asarray(req.prompt)
        self.cache = self.engine.prefill_chunk(
            self.params, self.cache, prompt[:C], 0, slot,
            np.zeros((0,), np.int32), ids, self.alloc.table[slot])
        if req.t_admitted is None:
            req.t_admitted = now
        self.prefilling[slot] = _Prefill(req, C)
        self.n_chunked += 1
        self.max_concurrency = max(
            self.max_concurrency, len(self.occupant) + len(self.prefilling))
        return ADMITTED

    def _advance_prefills(self, now: float) -> None:
        """Run at most ONE prefill chunk per prefilling slot, between the
        decode chunks: the chunked-prefill scheduling loop."""
        ps = self.engine.page_size
        C = self.cfg.prefill_chunk
        for slot in list(self.prefilling):
            if slot not in self.prefilling:
                continue                      # preempted by an earlier slot
            prog = self.prefilling[slot]
            prompt = np.asarray(prog.req.prompt)
            t = int(prompt.shape[0])
            final_start = ((t - 1) // C) * C  # leaves a 1..C token suffix
            start = prog.done
            if start < final_start:
                if not self._ensure_preempting(slot, start + C - 1, now):
                    continue                  # the slot itself was preempted
                owned = self.alloc.owned[slot]
                self.cache = self.engine.prefill_chunk(
                    self.params, self.cache, prompt[start:start + C],
                    start, slot, np.asarray(owned[:start // ps], np.int32),
                    np.asarray(owned[start // ps:(start + C) // ps],
                               np.int32),
                    self.alloc.table[slot])
                prog.done += C
                continue
            # the last suffix: the ordinary fork-point entry gives the
            # first token and the slot goes live
            sb = self.engine._bucket(t - start)
            last = min(start + sb, self.engine.max_len) - 1
            if not self._ensure_preempting(slot, last, now):
                continue
            owned = self.alloc.owned[slot]
            n_region = self.alloc.pages_for(last + 1 - start)
            region = np.zeros(self.alloc.pages_for(sb), np.int32)
            # where max_len cuts the bucket, the pad rows past the region
            # go to the scratch page (JAX's scatter drops them)
            region[:n_region] = owned[start // ps:start // ps + n_region]
            self.cache, self.state, tok0 = self.engine.prefill_into_shared(
                self.params, self.cache, self.state, prompt, start, slot,
                prog.req.max_new_tokens,
                np.asarray(owned[:start // ps], np.int32), region,
                self.alloc.table[slot], seed=prog.req.seed)
            del self.prefilling[slot]
            if self.alloc.index is not None:
                self.alloc.register(prompt, slot)
            self._finish_admit(prog.req, slot, tok0, now, t,
                               prog.req.max_new_tokens)

    # -- resume ------------------------------------------------------------

    def _resume(self, ent: _Resume, now: float) -> str:
        if ent.swap is not None:
            return self._resume_swapped(ent, now)
        res = self.admit(ent.req, now, prompt=ent.resume_prompt,
                         budget=ent.remaining)
        if res == ADMITTED:
            self.n_recompute_resumes += 1
        return res

    def _resume_swapped(self, ent: _Resume, now: float) -> str:
        """Map fresh pool pages, write the swapped blocks back and re-arm
        the slot: same cache position, same generator state, same
        next-input token, so the continuation is the uninterrupted one."""
        req = ent.req
        t_ = int(ent.resume_prompt.shape[0])
        n_keep = len(ent.swap.page_ids)
        ps = self.engine.page_size
        if not self.free or not self.alloc.can_admit(n_keep * ps, t_,
                                                     ent.remaining):
            return FULL
        slot = self.free.popleft()
        ids = self.alloc.admit(slot, n_keep * ps, t_, ent.remaining)
        self.cache = self.engine.restore_pages(self.cache, ids,
                                               ent.swap.blocks)
        self.cache, self.state = self.engine.restore_slot(
            self.cache, self.state, slot, token=req.tokens[-1],
            budget=ent.remaining, pos=t_ - 1, rng_state=ent.swap.rng_state)
        if self.alloc.index is not None:
            # KV is resident through position t_ - 2 (the last token's
            # row is written by the next decode step), so the chain that
            # may be shared stops before that token. (The JAX package
            # registers all t_ tokens here, which can index a full page
            # whose last row is not written yet: a deliberate fix.)
            self.alloc.register(ent.resume_prompt[:-1], slot)
        self.swap_pool.pop(req.rid)
        self.occupant[slot] = req
        self._gen_seen[slot] = 0            # generated restarts at 0
        self._true_len[slot] = t_
        self._budget[slot] = ent.remaining
        self._t_last[slot] = self._now(now)
        self.n_swap_resumes += 1
        self.max_concurrency = max(
            self.max_concurrency, len(self.occupant) + len(self.prefilling))
        return ADMITTED

    # -- preemption --------------------------------------------------------

    def _pick_victim(self, max_priority: Optional[int] = None,
                     force: bool = False) -> Optional[int]:
        """Victim slot by the policy. ``max_priority``: only slots of
        STRICTLY lower raw priority (admission never preempts an equal).
        ``force``: ignore the per-request ``MAX_PREEMPTIONS`` bound (page
        growth MUST make progress)."""
        cands = []
        for slot, req in self.occupant.items():
            if max_priority is not None and req.priority >= max_priority:
                continue
            cands.append((slot, req, len(self.alloc.owned[slot])
                          if self.alloc is not None else 0,
                          self._gen_seen[slot]))
        for slot, prog in self.prefilling.items():
            if max_priority is not None \
                    and prog.req.priority >= max_priority:
                continue
            cands.append((slot, prog.req, len(self.alloc.owned[slot]), 0))
        eligible = [c for c in cands
                    if c[1].preemptions < MAX_PREEMPTIONS]
        pool = eligible if eligible else (cands if force else [])
        return self.policy.pick(pool)

    def _preempt(self, slot: int, now: float) -> None:
        """Evict ``slot``: swap or drop its pages, kill it on the device,
        and re-queue its request with every generated token kept."""
        self.n_preempted += 1
        if slot in self.prefilling:
            # mid-prefill: no decode state to kill and no tokens yet; the
            # partial KV is dropped and the request re-admitted whole
            prog = self.prefilling.pop(slot)
            prog.req.preemptions += 1
            self.alloc.release(slot)
            self.free.append(slot)
            self.requeued.append(_Resume(
                prog.req, np.asarray(prog.req.prompt, np.int32),
                prog.req.max_new_tokens))
            return
        req = self.occupant.pop(slot)
        gen = self._gen_seen.pop(slot)
        true_len = self._true_len.pop(slot)
        del self._budget[slot]
        self._t_last.pop(slot, None)
        req.preemptions += 1
        remaining = req.max_new_tokens - len(req.tokens)
        if remaining <= 0:
            raise AssertionError("done slots are retired, never preempted")
        resume_prompt = np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.tokens, np.int32)])
        rec = None
        if self._swap_ok:
            # KV is resident through position pos - 1; the last token's
            # row is written by the resumed decode step itself
            pos = true_len + gen - 1
            n_keep = self.alloc.pages_for(pos)
            page_ids = list(self.alloc.owned[slot][:n_keep])
            blocks = self.engine.fetch_pages(self.cache, page_ids)
            rng = self.state.rng
            rec = _SwapRecord(page_ids, blocks,
                              None if rng is None else rng[slot].get_state(),
                              _nbytes(blocks))
            if self.swap_pool.put(req.rid, rec):
                self.n_swap_outs += 1
            else:
                rec = None                   # budget: resume by recompute
        if self.alloc is not None:
            self.alloc.release(slot)
        # kill the slot on the device: a released but live slot would go
        # on decoding into pages that now belong to someone else
        self.state = self.engine.deactivate_slot(self.state, slot)
        self.free.append(slot)
        self.requeued.append(_Resume(req, resume_prompt, remaining, rec))

    def _ensure_preempting(self, slot: int, last_pos: int,
                           now: float) -> bool:
        """``alloc.ensure`` with preemption on :class:`PoolExhausted`.
        Returns False if ``slot`` itself was the victim (the caller must
        stop touching it). Terminates: every preemption removes one
        occupant, and the growing slot is always a candidate."""
        while True:
            try:
                self.alloc.ensure(slot, last_pos)
                return True
            except PoolExhausted:
                if not self.alloc.optimistic:
                    raise                    # a broken reservation
                victim = self._pick_victim(force=True)
                if victim is None:
                    raise
                self._preempt(victim, now)
                if victim == slot:
                    return False

    # -- decode ------------------------------------------------------------

    def _grow_pages(self) -> None:
        chunk = self.engine.tokens_per_chunk
        now = self._now(0.0)
        for slot in list(self.occupant):
            if slot not in self.occupant:
                continue                     # victim of an earlier growth
            gen = self._gen_seen[slot]
            live_steps = min(chunk, self._budget[slot] - gen)
            if live_steps <= 0:
                continue
            pos_now = self._true_len[slot] + gen - 1
            self._ensure_preempting(slot, pos_now + live_steps - 1, now)
        self._push_table()

    def step_chunk(self, now: float) -> int:
        self._advance_prefills(now)
        if not self.occupant:
            return 0
        t0 = self._now(now)
        produced = super().step_chunk(now)
        if produced > 0:
            # EWMA decode seconds a token: feeds the deadline sheds
            dt = max(self._now(now) - t0, 0.0) / produced
            self._tok_s = (dt if self._tok_s is None
                           else 0.8 * self._tok_s + 0.2 * dt)
        return produced

    @property
    def busy(self) -> bool:
        return bool(self.occupant or self.prefilling or self.requeued)

    def extra_stats(self) -> Dict[str, float]:
        return {
            "preemptions": float(self.n_preempted),
            "swap_outs": float(self.n_swap_outs),
            "swap_resumes": float(self.n_swap_resumes),
            "recompute_resumes": float(self.n_recompute_resumes),
            "shed_ttft": float(self.n_shed_ttft),
            "shed_deadline": float(self.n_shed_deadline),
            "chunked_admissions": float(self.n_chunked),
            "swap_bytes_peak": float(self.swap_pool.peak),
        }
