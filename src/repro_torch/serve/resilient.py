"""Fault-tolerant serving supervisor: snapshot, restore, deterministic
replay (port of ``repro.serve.resilient``).

The supervisor owns the stream's lifecycle; the scheduler and engine may
crash, and recovery loses no request in flight. Every ``snapshot_every``
chunks it captures a :class:`StreamSnapshot`:

* the DEVICE half through :meth:`SlotEngine.snapshot`: the whole
  ``DecodeState`` with each slot generator's state, the draft's cache on
  a speculative engine, and the attention state (the allocated pool
  pages of a paged all-attention engine, else the whole cache), copied to
  host memory the snapshot owns;
* the HOST half: an allocator clone, the free slots, the slot -> request
  maps, each request's progress (token / gap list lengths and lifecycle
  stamps), the queue order and the engine's counters.

On ANY exception out of a serve step (an injected fault, a watchdog
timeout, a real crash) the supervisor restores the snapshot and drives
the loop again. The port's engine writes K/V, recurrent state and
generators IN PLACE, so a half-finished step has already written into the
live buffers: ``restore`` writes the host copy back over them (in place:
no second cache is allocated), and request progress is rolled back by
truncation. The replayed chunks
then compute exactly the tokens of the uninterrupted run, greedy and
seeded sampling.

Guard rails riding along:

* WATCHDOG: a chunk slower than ``watchdog_ms`` of wall clock raises
  :class:`WatchdogTimeout`, handled like any crash (bounded retries and
  an optional backoff). The injector's ``stalls`` are its test vector.
* NaN QUARANTINE: below the supervisor (the decode step's guard and the
  scheduler): a poisoned slot is shed with ``nan-quarantined``;
  co-batched requests never notice.
* CIRCUIT BREAKER: ``breaker`` installs a
  :class:`repro_torch.core.xaif.CircuitBreaker` for the stream: a
  ``chaos`` backend that raises an injected fault inside a call is pinned
  to its op's plain version instead of crashing the stream. Every trip is
  counted in ``stats["breaker_trips"]``. Any other error out of a call (a
  kernel that fails on the card) is a crash, restored and replayed.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import xaif
from repro_torch.dist.fault import FaultEvent
from repro_torch.serve import faults as faults_mod
from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.scheduler import (REASON_SHED, Request, ServeReport,
                                         SlotScheduler, reject_reason)


class WatchdogTimeout(RuntimeError):
    """A serve chunk exceeded the per-chunk watchdog budget."""


# a request's rollback record: list LENGTHS (tokens and gaps only grow
# between a snapshot and a fault, so truncation restores them exactly)
# and the lifecycle scalars
_ReqState = Tuple[int, int, Optional[float], Optional[float],
                  Optional[float], Optional[str], int]


def _req_state(r: Request) -> _ReqState:
    return (len(r.tokens), len(r.itl), r.t_admitted, r.t_first_token,
            r.t_finished, r.reject_reason, r.preemptions)


def _rollback_req(r: Request, s: _ReqState) -> None:
    ntok, nitl, t_adm, t_ft, t_fin, reason, preempt = s
    del r.tokens[ntok:]
    del r.itl[nitl:]
    r.t_admitted, r.t_first_token, r.t_finished = t_adm, t_ft, t_fin
    r.reject_reason, r.preemptions = reason, preempt


@dataclass
class StreamSnapshot:
    """Everything needed to rebuild a serve stream at a chunk boundary."""

    device: dict                          # SlotEngine.snapshot() result
    alloc: Optional[object]               # PageAllocator clone (or None)
    free: Tuple[int, ...]
    occupant: Dict[int, int]              # slot -> rid
    gen_seen: Dict[int, int]
    true_len: Dict[int, int]
    budget: Dict[int, int]
    t_last: Dict[int, float]
    max_concurrency: int
    shared_tokens: int
    shared_admissions: int
    prefill_tokens: int                   # the engine's cumulative counter
    decode_tokens: int                    # the stream's, at the boundary
    waiting: Tuple[int, ...]              # rids, in queue order
    req_state: Dict[int, _ReqState]       # rid -> rollback record


def _take_snapshot(engine: SlotEngine, sched: SlotScheduler,
                   waiting: deque, requests: List[Request],
                   decode_tokens: int) -> StreamSnapshot:
    return StreamSnapshot(
        device=engine.snapshot(sched.cache, sched.state, sched.alloc),
        alloc=sched.alloc.clone() if sched.alloc is not None else None,
        free=tuple(sched.free),
        occupant={slot: req.rid for slot, req in sched.occupant.items()},
        gen_seen=dict(sched._gen_seen),
        true_len=dict(sched._true_len),
        budget=dict(sched._budget),
        t_last=dict(sched._t_last),
        max_concurrency=sched.max_concurrency,
        shared_tokens=sched.shared_tokens,
        shared_admissions=sched.shared_admissions,
        prefill_tokens=engine.prefill_tokens,
        decode_tokens=decode_tokens,
        waiting=tuple(r.rid for r in waiting),
        req_state={r.rid: _req_state(r) for r in requests})


def _restore_snapshot(engine: SlotEngine, sched: SlotScheduler,
                      snap: StreamSnapshot, requests: List[Request]
                      ) -> Tuple[deque, int]:
    """Overwrite ``sched`` in place from ``snap``; returns the rebuilt
    waiting queue and the stream's decode-token counter."""
    by_rid = {r.rid: r for r in requests}
    alloc = None
    if snap.alloc is not None:
        # a clone of the stored clone: the snapshot stays pristine, so a
        # second fault can restore from it again
        alloc = snap.alloc.clone()
        alloc.injector = engine.injector
    sched.cache, sched.state = engine.restore(snap.device, sched.cache,
                                              alloc)
    if alloc is not None and snap.device["kind"] == "paged":
        alloc.dirty = False            # restore() pushed the table already
    sched.alloc = alloc
    sched.free = deque(snap.free)
    sched.occupant = {slot: by_rid[rid]
                      for slot, rid in snap.occupant.items()}
    sched._gen_seen = dict(snap.gen_seen)
    sched._true_len = dict(snap.true_len)
    sched._budget = dict(snap.budget)
    sched._t_last = dict(snap.t_last)
    sched.max_concurrency = snap.max_concurrency
    sched.shared_tokens = snap.shared_tokens
    sched.shared_admissions = snap.shared_admissions
    engine.prefill_tokens = snap.prefill_tokens
    for r in requests:
        _rollback_req(r, snap.req_state[r.rid])
    return deque(by_rid[rid] for rid in snap.waiting), snap.decode_tokens


def serve_resilient(engine: SlotEngine, params, requests: List[Request],
                    realtime: bool = False, snapshot_every: int = 4,
                    max_restarts: int = 8, watchdog_ms: Optional[float] = None,
                    backoff_s: float = 0.0,
                    injector: Optional[faults_mod.FaultInjector] = None,
                    breaker: Optional[xaif.CircuitBreaker] = None
                    ) -> ServeReport:
    """Drive a request stream to completion under a restart supervisor.

    Mirrors :func:`repro_torch.serve.scheduler.serve` with the base FIFO
    scheduler only (overload control has its own swap machinery and is out
    of scope, as in JAX), adding a snapshot every ``snapshot_every`` chunks
    and crash recovery: any exception out of admission, decode or a
    snapshot restores the latest snapshot and replays, up to
    ``max_restarts`` times (the next one is raised). ``injector`` is
    installed on the engine and armed process-wide (for the chaos
    backends) while the stream runs; ``breaker`` is installed as the
    process's circuit breaker; both are put back after it, whatever
    happens. Extra ``report.stats`` keys: ``restarts``,
    ``faults_injected``, ``breaker_trips``, ``recovery_s_mean`` / ``_max``
    (seconds a restore took)."""
    if engine.persistent_prefix_index:
        raise ValueError("serve_resilient owns the stream's state; a "
                         "persistent prefix index is not supported")
    if snapshot_every < 1 or max_restarts < 0:
        raise ValueError(f"snapshot_every {snapshot_every} must be >= 1 and "
                         f"max_restarts {max_restarts} >= 0")
    waiting = deque(sorted(requests, key=lambda r: r.arrival))
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    prev_engine_inj = engine.injector
    engine.injector = injector
    prev_armed = faults_mod.arm(injector)
    prev_breaker = (xaif.install_breaker(breaker) if breaker is not None
                    else None)
    restarts = 0
    recoveries: List[float] = []
    decode_tokens = 0
    chunk_i = 0
    try:
        sched = SlotScheduler(engine, params)
        sched.clock = now
        # the pristine stream (no allocated page, so the gather cannot
        # fault): the floor every recovery can fall back to
        snap = _take_snapshot(engine, sched, waiting, requests,
                              decode_tokens)
        while waiting or sched.busy:
            try:
                progressed = sched.admission_round(waiting, now(), realtime)
                if not sched.busy:
                    if realtime and waiting:
                        time.sleep(max(waiting[0].arrival - now(), 0.0))
                        continue
                    if not progressed:
                        break
                    continue
                t_chunk = time.perf_counter()
                decode_tokens += sched.step_chunk(now())
                if watchdog_ms is not None:
                    dt_ms = (time.perf_counter() - t_chunk) * 1e3
                    if dt_ms > watchdog_ms:
                        raise WatchdogTimeout(
                            f"chunk took {dt_ms:.0f} ms "
                            f"(budget {watchdog_ms:.0f} ms)")
                chunk_i += 1
                if chunk_i % snapshot_every == 0:
                    # a fault DURING the gather lands in the handler below
                    # and recovery falls back to the previous snapshot
                    snap = _take_snapshot(engine, sched, waiting, requests,
                                          decode_tokens)
            except Exception as exc:   # noqa: BLE001 — the supervisor's job
                if restarts >= max_restarts:
                    raise
                restarts += 1
                if injector is not None:
                    injector.events.append(FaultEvent(
                        "restart", restarts,
                        f"{type(exc).__name__}: {exc}"))
                if backoff_s > 0.0:
                    time.sleep(backoff_s)
                t_rec = time.perf_counter()
                waiting, decode_tokens = _restore_snapshot(
                    engine, sched, snap, requests)
                recoveries.append(time.perf_counter() - t_rec)
        for req in waiting:
            if req.reject_reason is None:
                req.reject_reason = reject_reason(
                    REASON_SHED, "unservable: needs more pages than an "
                    "idle pool can provide")
        wall = now()
        total = decode_tokens + sum(1 for r in requests if r.tokens)
        stats = SlotEngine.stats(sched.state)
        stats["max_concurrency"] = float(sched.max_concurrency)
        stats["prefill_tokens"] = float(engine.prefill_tokens)
        if sched.alloc is not None:
            stats["peak_pages"] = float(sched.alloc.peak_pages)
        stats["restarts"] = float(restarts)
        stats["faults_injected"] = float(injector.fired if injector else 0)
        stats["breaker_trips"] = float(breaker.trips if breaker else 0)
        if recoveries:
            stats["recovery_s_mean"] = float(sum(recoveries)
                                             / len(recoveries))
            stats["recovery_s_max"] = float(max(recoveries))
        return ServeReport(requests=requests, wall_s=wall,
                           decode_tokens=total, stats=stats)
    finally:
        engine.injector = prev_engine_inj
        faults_mod.arm(prev_armed)
        if breaker is not None:
            xaif.install_breaker(prev_breaker)
