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

Prompts that cannot fit (``len(prompt) + max_new_tokens > max_len``) are
REJECTED — ``Request.reject_reason`` is set and the request comes back
unserved, never silently truncated.
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

    # lifecycle (filled by the scheduler)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    reject_reason: Optional[str] = None
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

    def ttft_percentiles(self) -> Dict[str, float]:
        return _pctiles([r.ttft for r in self.served if r.ttft is not None])

    def itl_percentiles(self) -> Dict[str, float]:
        """Inter-token gaps pooled over served requests (chunk-granular:
        a chunk's wall time is spread over the tokens it produced)."""
        return _pctiles([g for r in self.served for g in r.itl])


# admit() outcomes
ADMITTED = "admitted"
FULL = "full"          # retry when a slot / pages free up
REJECTED = "rejected"  # can never be served by this engine

# every reject_reason is "<code>: <detail>" with <code> one of these
REASON_SHED = "shed"
REASON_TOO_LONG = "too-long"
REASON_NAN = "nan-quarantined"
REJECT_REASONS = (REASON_SHED, REASON_TOO_LONG, REASON_NAN)


def reject_reason(code: str, detail: str) -> str:
    if code not in REJECT_REASONS:
        raise ValueError(f"unknown reject code {code!r}")
    return f"{code}: {detail}"


class SlotScheduler:
    """Admission / retirement / backfill over a SlotEngine's slot batch."""

    def __init__(self, engine: SlotEngine, params):
        self.engine = engine
        self.params = params
        self.cache, self.state = engine.init_state()
        self.alloc: Optional[PageAllocator] = None
        if engine.paged:
            self.alloc = PageAllocator(engine.num_pages, engine.capacity,
                                       engine.max_pages, engine.page_size)
        self.free: deque = deque(range(engine.capacity))
        self.occupant: Dict[int, Request] = {}       # slot -> request
        self._gen_seen: Dict[int, int] = {}          # slot -> tokens recorded
        self._true_len: Dict[int, int] = {}          # slot -> prompt length
        self._t_last: Dict[int, float] = {}          # slot -> last token time
        self.clock: Optional[Callable[[], float]] = None   # set by serve()
        self.max_concurrency = 0

    def _now(self, fallback: float) -> float:
        return self.clock() if self.clock is not None else fallback

    # -- admission ---------------------------------------------------------

    def admit(self, req: Request, now: float) -> str:
        """Prefill ``req`` into a free slot: ADMITTED, FULL (retry later)
        or REJECTED (impossible — ``reject_reason`` set)."""
        t = int(len(req.prompt))
        if t + req.max_new_tokens > self.engine.max_len:
            req.reject_reason = reject_reason(
                REASON_TOO_LONG,
                f"prompt ({t}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds engine max_len ({self.engine.max_len})")
            return REJECTED
        if not self.free:
            return FULL
        page_ids = None
        if self.alloc is not None:
            bucket = self.engine._bucket(t)
            if not self.alloc.can_admit(bucket, t, req.max_new_tokens):
                return FULL                          # admission by free pages
            slot = self.free.popleft()
            page_ids = self.alloc.admit(slot, bucket, t, req.max_new_tokens)
        else:
            slot = self.free.popleft()
        # (the prefill writes this slot's device table row; other pending
        # mirror changes, e.g. rows cleared by release(), keep alloc.dirty
        # set and reach the device before the next chunk)
        self.cache, self.state, tok0 = self.engine.prefill_into(
            self.params, self.cache, self.state, req.prompt, slot,
            req.max_new_tokens, page_ids=page_ids, seed=req.seed)
        tok_i = int(tok0)                            # host sync: prefill done
        t_tok = max(self._now(now), req.arrival)
        req.t_admitted = now
        req.t_first_token = t_tok
        req.tokens.append(tok_i)
        self.occupant[slot] = req
        self._gen_seen[slot] = 1
        self._true_len[slot] = t
        self._t_last[slot] = t_tok
        self.max_concurrency = max(self.max_concurrency, len(self.occupant))
        return ADMITTED

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
        for slot, req in self.occupant.items():
            gen = self._gen_seen[slot]
            steps = min(chunk, req.max_new_tokens - gen)
            if steps > 0:
                self.alloc.ensure(slot, self._true_len[slot] + gen - 1
                                  + steps - 1)
        self._push_table()

    def _push_table(self) -> None:
        if self.alloc.dirty:
            self.cache = self.engine.set_page_table(self.cache,
                                                    self.alloc.table)
            self.alloc.dirty = False

    def _retire(self, slot: int) -> None:
        del self.occupant[slot]
        del self._gen_seen[slot]
        del self._true_len[slot]
        self._t_last.pop(slot, None)
        if self.alloc is not None:
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
                # KV (row or pages) before the slot or pages are reused
                pages = (self.alloc.owned[slot] if self.alloc is not None
                         else None)
                self.cache = self.engine.scrub_slot_kv(self.cache, slot,
                                                       pages)
                req.reject_reason = reject_reason(
                    REASON_NAN, "non-finite logits: slot quarantined, "
                    f"{len(req.tokens)} tokens salvaged")
                req.t_finished = max(now, req.arrival)
                self._retire(slot)
            elif done_np[slot]:
                req.t_finished = max(now, req.arrival)
                self._retire(slot)
        return produced

    @property
    def busy(self) -> bool:
        return bool(self.occupant)


def serve(engine: SlotEngine, params, requests: List[Request],
          realtime: bool = False) -> ServeReport:
    """Drive a request stream to completion on ``engine``.

    ``realtime=False`` admits requests as soon as a slot frees up (arrival
    times still charge queueing delay through the serve clock);
    ``realtime=True`` waits for wall-clock arrivals. Requests the engine
    can never serve come back with ``reject_reason`` set."""
    waiting = deque(sorted(requests, key=lambda r: r.arrival))
    t0 = time.perf_counter()
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
    return ServeReport(requests=requests, wall_s=wall, decode_tokens=total,
                       stats=stats)


def poisson_requests(num: int, rate_hz: float, prompt_lens, max_new_tokens,
                     vocab_size: int, seed: int = 0) -> List[Request]:
    """Synthetic open-loop workload: exponential inter-arrival gaps at
    ``rate_hz``, prompt lengths and budgets drawn from (min, max) ranges.
    The same draws as the JAX package's ``poisson_requests``."""
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
        out.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab_size, (t,), dtype=np.int32),
            max_new_tokens=int(rng.integers(nlo, nhi + 1)),
            arrival=float(arrivals[i])))
    return out
