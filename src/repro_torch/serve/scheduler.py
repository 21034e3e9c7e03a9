"""Continuous-batching scheduler: fixed-capacity slots over the SlotEngine
(port of ``repro.serve.scheduler``, FIFO mode).

Requests queue, get admitted into free slots (one bucketed prefill each),
decode advances ALL occupied slots in chunks, and finished slots are
retired and backfilled. The host's per-chunk work is ONE fetch of (tokens,
slot state) and the bookkeeping; token validity is reconstructed from the
per-slot generated counts. On a paged engine admission is bounded by free
pages as well as free slots, pages grow on demand before each chunk (the
page table goes to the device only when it changed) and return to the pool
at retire.

With prefix sharing on (``SlotEngine(prefix_sharing=True)``) admission
first radix-matches the prompt against resident page chains and, when a
full page matches and the copy-on-write / suffix region can be reserved,
admits at the fork point: the matched pages are mapped read-only, a
partial boundary page is copied, and only the suffix is prefilled.
Otherwise (no match, or a region that does not fit now) it falls through
to the standard prefill. Every admission registers the prompt's full pages
in the index and every retirement the chain whose KV was written, so later
requests share them; a quarantined slot's chain is never registered.

Prompts that cannot fit (``len(prompt) + max_new_tokens > max_len``) are
REJECTED — ``Request.reject_reason`` is set and the request comes back
unserved, never silently truncated. A request with a ``stop_token``
retires at its first emission of it (kept, the rest of the chunk's rows
dropped): ``max_new_tokens`` is then a cap, not the realized length.

OVERLOAD CONTROL: ``serve(..., overload=OverloadConfig(...))`` runs the
stream through :class:`repro_torch.serve.overload.OverloadScheduler`
instead: priority-aged admission, optimistic paging with preemption (host
swap or re-prefill resume), SLO sheds and chunked prefill. This base
scheduler keeps the worst-case reservation and is the reject-only
baseline.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.paging import PageAllocator


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [t] int32
    max_new_tokens: int
    arrival: float = 0.0               # seconds from stream start
    # optional per-request sample seed: a seeded request replays the same
    # tokens whatever slot it lands in (sampled engines; greedy ignores it)
    seed: Optional[int] = None
    # optional early stop: retire at the FIRST emission of this token id
    # (kept), so ``max_new_tokens`` is a reservation cap
    stop_token: Optional[int] = None
    # -- overload control (all optional) -----------------------------------
    priority: int = 0                     # higher = more important
    deadline_ms: Optional[float] = None   # complete within this, or shed
    slo_ttft_ms: Optional[float] = None   # first token within this, or shed

    # lifecycle (filled by the scheduler)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    reject_reason: Optional[str] = None
    preemptions: int = 0
    tokens: List[int] = field(default_factory=list)
    itl: List[float] = field(default_factory=list)  # inter-token gaps (s)

    @property
    def latency(self) -> float:
        return self.t_finished - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival


def _pctiles(vals) -> Dict[str, float]:
    a = np.asarray(vals, np.float64)
    if a.size == 0:
        nan = float("nan")
        return {"p50": nan, "p99": nan, "mean": nan, "max": nan}
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(np.mean(a)), "max": float(np.max(a))}


@dataclass
class ServeReport:
    requests: List[Request]
    wall_s: float
    decode_tokens: int
    stats: Dict[str, float]

    @property
    def served(self) -> List[Request]:
        return [r for r in self.requests if r.reject_reason is None]

    @property
    def rejected(self) -> List[Request]:
        return [r for r in self.requests if r.reject_reason is not None]

    @property
    def tokens_per_s(self) -> float:
        return self.decode_tokens / max(self.wall_s, 1e-9)

    @property
    def completion_rate(self) -> float:
        return len(self.served) / max(len(self.requests), 1)

    def latency_percentiles(self) -> Dict[str, float]:
        return _pctiles([r.latency for r in self.served])

    def ttft_percentiles(self, min_priority: Optional[int] = None
                         ) -> Dict[str, float]:
        """Time-to-first-token percentiles over served requests (with
        ``min_priority``: only those of ``priority >= min_priority``)."""
        return _pctiles([r.ttft for r in self.served if r.ttft is not None
                         and (min_priority is None
                              or r.priority >= min_priority)])

    def itl_percentiles(self) -> Dict[str, float]:
        """Inter-token gaps pooled over served requests (chunk-granular:
        a chunk's wall time is spread over the tokens it produced)."""
        return _pctiles([g for r in self.served for g in r.itl])

    def breakdown(self) -> Dict[str, float]:
        """Mean time a request spends queued (arrival -> admission), in
        prefill (admission -> first token) and in decode (first token ->
        done)."""
        done = [r for r in self.served if r.t_finished is not None
                and r.t_first_token is not None and r.t_admitted is not None]
        if not done:
            nan = float("nan")
            return {"queue_s": nan, "prefill_s": nan, "decode_s": nan}
        return {
            "queue_s": float(np.mean(
                [max(r.t_admitted - r.arrival, 0.0) for r in done])),
            "prefill_s": float(np.mean(
                [max(r.t_first_token - r.t_admitted, 0.0) for r in done])),
            "decode_s": float(np.mean(
                [max(r.t_finished - r.t_first_token, 0.0) for r in done])),
        }


# admit() outcomes
ADMITTED = "admitted"
FULL = "full"          # retry when a slot / pages free up
REJECTED = "rejected"  # can never be served by this engine

# every reject_reason is "<code>: <detail>" with <code> one of these
REASON_SHED = "shed"              # load shedding / unservable by this pool
REASON_DEADLINE = "deadline"      # completion deadline infeasible
REASON_TTFT = "ttft-slo"          # first-token SLO already missed
REASON_TOO_LONG = "too-long"      # prompt + budget exceeds max_len
REASON_NAN = "nan-quarantined"    # non-finite logits: slot quarantined
REJECT_REASONS = (REASON_SHED, REASON_DEADLINE, REASON_TTFT,
                  REASON_TOO_LONG, REASON_NAN)


def reject_reason(code: str, detail: str) -> str:
    if code not in REJECT_REASONS:
        raise ValueError(f"unknown reject code {code!r}")
    return f"{code}: {detail}"


class SlotScheduler:
    """Admission / retirement / backfill over a SlotEngine's slot batch."""

    # the overload subclass sets this before ``__init__`` builds the
    # allocator: admission then asks for the pages mapped now and growth
    # raises PoolExhausted when the pool runs dry
    _optimistic = False

    def __init__(self, engine: SlotEngine, params):
        self.engine = engine
        self.params = params
        self.alloc: Optional[PageAllocator] = None
        if engine.persistent_prefix_index and engine.resident is not None:
            # resume the previous serve() call's pool: index, refcounts and
            # the device cache stay warm, so recurring prefixes hit in the
            # next stream. Popped, so the engine holds no second handle.
            self.cache, self.state, self.alloc = engine.resident
            engine.resident = None
            self.alloc.optimistic = self._optimistic
        else:
            self.cache, self.state = engine.init_state()
            if engine.paged:
                self.alloc = PageAllocator(engine.num_pages, engine.capacity,
                                           engine.max_pages, engine.page_size,
                                           sharing=engine.prefix_sharing,
                                           optimistic=self._optimistic)
        if self.alloc is not None:
            # chaos: the engine's injector also covers host page allocation
            self.alloc.injector = engine.injector
        self.free: deque = deque(range(engine.capacity))
        self.occupant: Dict[int, Request] = {}       # slot -> request
        self._gen_seen: Dict[int, int] = {}          # slot -> tokens recorded
        self._true_len: Dict[int, int] = {}          # slot -> prompt length
        self._budget: Dict[int, int] = {}            # slot -> admission budget
        self._t_last: Dict[int, float] = {}          # slot -> last token time
        self.clock: Optional[Callable[[], float]] = None   # set by serve()
        self.max_concurrency = 0
        self.shared_tokens = 0              # prompt tokens NOT prefilled
        self.shared_admissions = 0          # fork-point admissions

    def _now(self, fallback: float) -> float:
        return self.clock() if self.clock is not None else fallback

    # -- admission ---------------------------------------------------------

    def admit(self, req: Request, now: float,
              prompt: Optional[np.ndarray] = None,
              budget: Optional[int] = None) -> str:
        """Prefill ``req`` into a free slot: ADMITTED, FULL (retry later)
        or REJECTED (impossible — ``reject_reason`` set). ``prompt`` /
        ``budget`` override the request's own: the overload scheduler
        resumes a preempted request by admitting its prompt ++ generated
        tokens with the REMAINING budget."""
        prompt = np.asarray(req.prompt if prompt is None else prompt)
        budget = req.max_new_tokens if budget is None else budget
        t = int(len(prompt))
        if t + budget > self.engine.max_len:
            req.reject_reason = reject_reason(
                REASON_TOO_LONG,
                f"prompt ({t}) + max_new_tokens ({budget}) "
                f"exceeds engine max_len ({self.engine.max_len})")
            return REJECTED
        if not self.free:
            return FULL
        sharing = self.alloc is not None and self.alloc.index is not None
        if sharing and self._admit_shared(req, now, prompt, budget, t):
            return ADMITTED
        page_ids = None
        if self.alloc is not None:
            bucket = self.engine._bucket(t)
            if not self.alloc.can_admit(bucket, t, budget):
                return FULL                          # admission by free pages
            slot = self.free.popleft()
            page_ids = self.alloc.admit(slot, bucket, t, budget)
        else:
            slot = self.free.popleft()
        # (the prefill writes this slot's device table row; other pending
        # mirror changes, e.g. rows cleared by release(), keep alloc.dirty
        # set and reach the device before the next chunk)
        self.cache, self.state, tok0 = self.engine.prefill_into(
            self.params, self.cache, self.state, prompt, slot, budget,
            page_ids=page_ids, seed=req.seed)
        if sharing:
            # index the prompt's full pages (written above, before any
            # reader's prefill: one device stream)
            self.alloc.register(prompt, slot)
        self._finish_admit(req, slot, tok0, now, t, budget)
        return ADMITTED

    def _admit_shared(self, req: Request, now: float, prompt: np.ndarray,
                      budget: int, t: int) -> bool:
        """Fork-point admission against the prefix index. False when no
        full page matches, or when the COW / suffix region cannot be
        reserved now: bucket rounding can make the shared reservation
        LARGER than the standard one (rem + bucket(t - start) may exceed
        bucket(t)), so the caller falls through to the standard path
        rather than reporting FULL."""
        pages, boundary, rem = self.alloc.match(prompt)
        if not pages:
            return False                             # min share: 1 full page
        if boundary is None:
            rem = 0
        start = len(pages) * self.engine.page_size + rem
        suffix_bucket = self.engine._bucket(t - start)
        if not self.alloc.can_admit_shared(pages, boundary, rem,
                                           suffix_bucket, t, budget):
            return False
        slot = self.free.popleft()
        prefix_ids, region_ids = self.alloc.admit_shared(
            slot, pages, boundary, rem, suffix_bucket, t, budget)
        if rem > 0:
            # copy-on-write: the boundary page is duplicated BEFORE the
            # suffix prefill writes into it; the donor page is never
            # written by this slot
            self.cache = self.engine.copy_page(self.cache, int(boundary),
                                               int(region_ids[0]))
        self.cache, self.state, tok0 = self.engine.prefill_into_shared(
            self.params, self.cache, self.state, prompt, start, slot,
            budget, prefix_ids, region_ids, self.alloc.table[slot],
            seed=req.seed)
        self.alloc.register(prompt, slot)
        self.shared_tokens += start
        self.shared_admissions += 1
        self._finish_admit(req, slot, tok0, now, t, budget)
        return True

    def _finish_admit(self, req: Request, slot: int, tok0, now: float,
                      t: int, budget: int) -> None:
        tok_i = int(tok0)                            # host sync: prefill done
        t_tok = max(self._now(now), req.arrival)
        # a resumed request keeps its first admission and first token
        if req.t_admitted is None:
            req.t_admitted = now
        if req.t_first_token is None:
            req.t_first_token = t_tok
        req.tokens.append(tok_i)
        self.occupant[slot] = req
        self._gen_seen[slot] = 1
        self._true_len[slot] = t
        self._budget[slot] = budget
        self._t_last[slot] = t_tok
        self.max_concurrency = max(self.max_concurrency, len(self.occupant))

    def admission_round(self, waiting: deque, now: float,
                        realtime: bool) -> bool:
        """Admit everything currently admissible, FIFO in arrival order.
        Returns True if any request left the queue."""
        progressed = False
        while waiting and self.free:
            if realtime and waiting[0].arrival > now:
                break
            req = waiting[0]
            if self.admit(req, max(now, req.arrival)) == FULL:
                break
            progressed = True
            waiting.popleft()                        # ADMITTED or REJECTED
        return progressed

    # -- decode + retire ---------------------------------------------------

    def _grow_pages(self) -> None:
        """On-demand page allocation before a chunk: every live slot gets
        pages for the positions this chunk can accept (``tokens_per_chunk``
        per slot; reservation-backed, so the pops cannot fail). Verify rows
        past the covered positions go to the scratch page and are never
        part of an accepted prefix this chunk."""
        chunk = self.engine.tokens_per_chunk
        for slot in self.occupant:
            gen = self._gen_seen[slot]
            steps = min(chunk, self._budget[slot] - gen)
            if steps > 0:
                self.alloc.ensure(slot, self._true_len[slot] + gen - 1
                                  + steps - 1)
        self._push_table()

    def _push_table(self) -> None:
        if self.alloc.dirty:
            self.cache = self.engine.set_page_table(self.cache,
                                                    self.alloc.table)
            self.alloc.dirty = False

    def _retire(self, slot: int, req: Request,
                register: bool = True) -> None:
        """Return a finished slot to the pool (host bookkeeping only).
        With sharing on, its chain is indexed first (``register=False``
        for a quarantined slot: its KV must never be shared): KV is
        resident through position t + len(tokens) - 2 (the last token was
        never fed back), hence ``tokens[:-1]``. That holds after a
        preemption too: a resumed request's chain is its ORIGINAL prompt
        ++ every generated token."""
        del self.occupant[slot]
        del self._gen_seen[slot]
        del self._true_len[slot]
        del self._budget[slot]
        self._t_last.pop(slot, None)
        if self.alloc is not None:
            if register and self.alloc.index is not None:
                chain = np.concatenate([np.asarray(req.prompt, np.int64),
                                        np.asarray(req.tokens[:-1],
                                                   np.int64)])
                self.alloc.register(chain, slot)
            self.alloc.release(slot)                 # pages -> free list
        self.free.append(slot)                       # backfill: host-only

    def step_chunk(self, now: float) -> int:
        """One decode chunk + ONE host fetch; retire finished slots.
        Returns the number of valid tokens produced this chunk."""
        if self.alloc is not None:
            self._grow_pages()
        self.cache, self.state, toks = self.engine.decode(
            self.params, self.cache, self.state)
        st = self.state
        host = torch.cat([toks, st.generated[:, None],
                          st.done[:, None].to(torch.int32),
                          st.quarantined[:, None].to(torch.int32)],
                         dim=1).cpu().numpy()        # the single transfer
        chunk = toks.shape[1]
        gen_np, done_np, quar_np = (host[:, chunk], host[:, chunk + 1],
                                    host[:, chunk + 2])
        t_tok = self._now(now)
        produced = 0
        for slot, req in list(self.occupant.items()):
            fresh = int(gen_np[slot]) - self._gen_seen[slot]
            req.tokens.extend(int(t) for t in host[slot, :fresh])
            self._gen_seen[slot] += fresh
            produced += fresh
            if fresh > 0:
                gap = max(t_tok - self._t_last.get(slot, t_tok), 0.0) / fresh
                req.itl.extend([gap] * fresh)
                self._t_last[slot] = t_tok
            if quar_np[slot]:
                # non-finite logits: shed ONLY this request and zero its
                # KV (row or pages) before the slot or pages are reused;
                # only the pages it alone holds (refcount 1): a shared
                # prefix page holds a donor's KV, which others still read
                pages = None
                if self.alloc is not None:
                    pages = [p for p in self.alloc.owned[slot]
                             if self.alloc.refcnt.get(p) == 1]
                self.cache = self.engine.scrub_slot_kv(self.cache, slot,
                                                       pages)
                req.reject_reason = reject_reason(
                    REASON_NAN, "non-finite logits: slot quarantined, "
                    f"{len(req.tokens)} tokens salvaged")
                req.t_finished = max(now, req.arrival)
                self._retire(slot, req, register=False)
                continue
            if req.stop_token is not None and req.stop_token in req.tokens:
                # host-side early stop: keep up to the first stop token
                # (inclusive) and retire; the rows the chunk decoded past
                # it are dropped and not counted as produced. The slot is
                # killed on the device too, so it stops decoding and
                # drawing until its next admission (the JAX package leaves
                # it live: a deliberate divergence)
                k = req.tokens.index(req.stop_token)
                produced -= min(len(req.tokens) - (k + 1), fresh)
                del req.tokens[k + 1:]
                del req.itl[max(k, 0):]
                req.t_finished = max(now, req.arrival)
                self.state = self.engine.deactivate_slot(self.state, slot)
                self._retire(slot, req)
                continue
            if done_np[slot]:
                req.t_finished = max(now, req.arrival)
                self._retire(slot, req)
        return produced

    @property
    def busy(self) -> bool:
        return bool(self.occupant)

    def extra_stats(self) -> Dict[str, float]:
        return {}


def serve(engine: SlotEngine, params, requests: List[Request],
          realtime: bool = False, overload=None) -> ServeReport:
    """Drive a request stream to completion on ``engine``.

    ``realtime=False`` admits requests as soon as a slot frees up (arrival
    times still charge queueing delay through the serve clock);
    ``realtime=True`` waits for wall-clock arrivals. Requests the engine
    can never serve come back with ``reject_reason`` set.

    ``overload``: an :class:`repro_torch.serve.overload.OverloadConfig`:
    the stream runs through the priority-aware preemptive scheduler
    instead of this FIFO reject-only one."""
    waiting = deque(sorted(requests, key=lambda r: r.arrival))
    t0 = time.perf_counter()
    if overload is not None:
        from repro_torch.serve.overload import OverloadScheduler
        sched = OverloadScheduler(engine, params, overload)
    else:
        sched = SlotScheduler(engine, params)
    decode_tokens = 0

    def now() -> float:
        return time.perf_counter() - t0

    sched.clock = now
    while waiting or sched.busy:
        progressed = sched.admission_round(waiting, now(), realtime)
        if not sched.busy:
            if realtime and waiting:
                time.sleep(max(waiting[0].arrival - now(), 0.0))
                continue
            if not progressed:
                break        # nothing running, nothing admissible: done
            continue
        decode_tokens += sched.step_chunk(now())
    for req in waiting:
        # admission stalled with an idle batch: these can never be served
        if req.reject_reason is None:
            req.reject_reason = reject_reason(
                REASON_SHED, "unservable: needs more pages than an idle "
                "pool can provide")
    wall = now()
    # prefill-produced first tokens count toward throughput too
    total = decode_tokens + sum(1 for r in requests if r.tokens)
    stats = SlotEngine.stats(sched.state)
    stats["max_concurrency"] = float(sched.max_concurrency)
    stats["prefill_tokens"] = float(engine.prefill_tokens)   # cumulative
    if sched.alloc is not None:
        stats["peak_pages"] = float(sched.alloc.peak_pages)
        if sched.alloc.index is not None:
            stats["shared_tokens"] = float(sched.shared_tokens)
            stats["shared_admissions"] = float(sched.shared_admissions)
            stats["index_pages"] = float(len(sched.alloc.index))
            stats["index_evictions"] = float(sched.alloc.index.evictions)
    stats.update(sched.extra_stats())
    if engine.persistent_prefix_index:
        # park the warm pool for the next serve() call (popped before reuse)
        engine.resident = (sched.cache, sched.state, sched.alloc)
    return ServeReport(requests=requests, wall_s=wall, decode_tokens=total,
                       stats=stats)


def poisson_requests(num: int, rate_hz: float, prompt_lens, max_new_tokens,
                     vocab_size: int, seed: int = 0, priorities=None,
                     slo_ttft_ms: Optional[float] = None) -> List[Request]:
    """Synthetic open-loop workload: exponential inter-arrival gaps at
    ``rate_hz``, prompt lengths and budgets drawn from (min, max) ranges;
    ``priorities``: an optional (values, probabilities) pair drawn per
    request; ``slo_ttft_ms`` stamps every request with one first-token
    SLO. The same draws as the JAX package's ``poisson_requests``."""
    rng = np.random.default_rng(seed)
    lo, hi = prompt_lens
    nlo, nhi = ((max_new_tokens, max_new_tokens)
                if np.isscalar(max_new_tokens) else max_new_tokens)
    gaps = (rng.exponential(1.0 / rate_hz, num) if np.isfinite(rate_hz)
            else np.zeros(num))
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(num):
        t = int(rng.integers(lo, hi + 1))
        prio = 0
        if priorities is not None:
            vals, probs = priorities
            prio = int(rng.choice(vals, p=probs))
        out.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab_size, (t,), dtype=np.int32),
            max_new_tokens=int(rng.integers(nlo, nhi + 1)),
            arrival=float(arrivals[i]), priority=prio,
            slo_ttft_ms=slo_ttft_ms))
    return out
