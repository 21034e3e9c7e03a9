"""Deterministic chaos injection for the serving layer (port of
``repro.serve.faults``).

A seeded :class:`FaultInjector` with NAMED INJECTION SITES threaded
through the serve path, so every failure the supervisor
(``serve/resilient.py``) must survive can be triggered the same way in
every run. Sites (:data:`SITES`):

* ``prefill``    — entry of every admission (``SlotEngine.prefill_into``,
  ``prefill_into_shared``, ``prefill_chunk``): a crashed prompt ingest;
* ``decode``     — entry of ``SlotEngine.decode``: a crashed decode chunk;
* ``page_alloc`` — inside ``PageAllocator._pop_free``: a host allocator
  failure mid-admission or mid-growth, with the allocator half mutated
  (restore rebuilds it from the snapshot);
* ``swap``       — entry of ``SlotEngine.fetch_pages``: a failed device ->
  host page gather (the overload scheduler's swap-out and the snapshot
  itself both go through it);
* ``backend``    — inside a dispatched XAIF call of a ``chaos`` backend
  (below): a kernel that raises at launch, the case the circuit breaker
  of ``core/xaif.py`` degrades around. JAX checks it when a jitted
  function is traced; the port runs eagerly, so it checks at every call.

Faults are addressed by PER-SITE CALL INDEX: ``schedule={"decode": [3]}``
raises on the 4th decode chunk of the stream, every run. The counters are
GLOBAL ACROSS RESTARTS (the injector outlives the crash), so a scheduled
fault fires once and the replayed calls after a restore do not fire it
again. ``rates`` adds seeded Bernoulli faults, decided by (seed, site,
call index) alone with JAX's numpy draw, so a port injector fires where
JAX's does. Every fault is logged as a
:class:`repro_torch.dist.fault.FaultEvent`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Iterator, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.dist.fault import FaultEvent, InjectedFault  # noqa: F401

SITES = ("prefill", "decode", "page_alloc", "swap", "backend")


class FaultInjector:
    """Deterministic, seeded fault source for the serve path.

    ``schedule``: {site: 0-based call indices}, exact firing points.
    ``rates``: {site: probability}, a seeded Bernoulli draw a call.
    ``stalls``: {site: {index: seconds}}: instead of raising, ``check``
    SLEEPS (the watchdog's test vector: the chunk completes, too late).
    ``max_faults`` bounds the faults raised, so that a rate sweep cannot
    starve a stream. The supervisor keeps one injector across restarts:
    the per-site counters keep advancing, and a consumed fault never fires
    again during replay."""

    def __init__(self, schedule: Optional[Mapping[str, Iterable[int]]] = None,
                 rates: Optional[Mapping[str, float]] = None,
                 stalls: Optional[Mapping[str, Mapping[int, float]]] = None,
                 seed: int = 0, max_faults: Optional[int] = None,
                 events: Optional[List[FaultEvent]] = None):
        for m in (schedule, rates, stalls):
            for site in (m or ()):
                if site not in SITES:
                    raise ValueError(f"unknown fault site {site!r}; sites: "
                                     f"{SITES}")
        self.schedule = {s: frozenset(int(i) for i in idx)
                         for s, idx in dict(schedule or {}).items()}
        self.rates = {s: float(p) for s, p in dict(rates or {}).items()}
        self.stalls = {s: {int(i): float(d) for i, d in dict(m).items()}
                       for s, m in dict(stalls or {}).items()}
        self.seed = seed
        self.max_faults = max_faults
        self.calls: Dict[str, int] = {s: 0 for s in SITES}
        self.fired = 0
        self.stalled = 0
        self.events: List[FaultEvent] = events if events is not None else []

    def _bernoulli(self, site: str, index: int) -> bool:
        p = self.rates.get(site, 0.0)
        if p <= 0.0:
            return False
        # a pure function of (seed, site, index), as in JAX
        rng = np.random.default_rng([self.seed, SITES.index(site), index])
        return bool(rng.random() < p)

    def check(self, site: str) -> None:
        """Count one call at ``site``; stall or raise if armed for it."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        index = self.calls[site]
        self.calls[site] = index + 1
        stall = self.stalls.get(site, {}).get(index)
        if stall is not None:
            self.stalled += 1
            self.events.append(FaultEvent(
                "inject-stall", index, f"site={site} sleep={stall:.3f}s"))
            time.sleep(stall)
            return
        fire = (index in self.schedule.get(site, ())
                or self._bernoulli(site, index))
        if fire and (self.max_faults is None
                     or self.fired < self.max_faults):
            self.fired += 1
            self.events.append(FaultEvent(
                "inject", index, f"site={site} call={index}"))
            raise InjectedFault(site, index)


# ---------------------------------------------------------------------------
# Arming: one process-wide injector, consulted by the chaos backends (which
# have no reference to the engine)
# ---------------------------------------------------------------------------

_ARMED: Optional[FaultInjector] = None


def arm(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Make ``injector`` the process-wide armed injector (None disarms).
    Returns the one armed before, so that callers can put it back."""
    global _ARMED
    prev, _ARMED = _ARMED, injector
    return prev


def armed() -> Optional[FaultInjector]:
    return _ARMED


# ---------------------------------------------------------------------------
# Chaos backends: an XAIF backend named "chaos" per op that checks the
# armed injector's "backend" site and then runs the op's PLAIN version (on
# the CPU and on the card alike), as JAX's delegates to ``ref``. A breaker
# that pins the op to its plain version therefore gives the same bits.
# ---------------------------------------------------------------------------


def _chaos_backend(plain):
    def chaos(*args, **kwargs):
        inj = armed()
        if inj is not None:
            inj.check("backend")
        return plain(*args, **kwargs)
    chaos.launches = 0          # it launches no kernel: never counted
    return chaos


@contextlib.contextmanager
def chaos_backends(ops: Iterable[str]) -> Iterator[List[str]]:
    """Register a ``chaos`` backend for each op of ``ops`` while the block
    runs (a ``Policy({op: "chaos"})`` routes an op there), and remove them
    after it, so that neither the registry nor ``launch_counts()`` keeps a
    trace (JAX's ``register_chaos_backends`` leaves them registered). An
    op that already has one keeps it. Yields the ops."""
    from repro_torch.core import xaif
    added = []
    try:
        for op in ops:
            try:
                xaif.entry(op, "chaos")
            except ValueError:
                fn = _chaos_backend(xaif.entry(op).plain)
                xaif.register(op, fn, fn, backend="chaos")
                added.append(op)
        yield list(ops)
    finally:
        for op in added:
            xaif.unregister(op, "chaos")


# ---------------------------------------------------------------------------
# KV poisoning: the NaN guard's test vector, a corrupted resident page
# ---------------------------------------------------------------------------


@torch.inference_mode()
def poison_slot(engine, cache, slot: int, alloc=None):
    """Overwrite ``slot``'s resident attention state with NaN in place,
    in every attention layer: on a paged engine the slot's FIRST owned
    pool page (``alloc`` required), on a contiguous one the slot's row.
    Only the poisoned slot's logits go non-finite: rows never read each
    other's pages or rows. Call between chunks. Returns the cache."""
    nan = float("nan")
    if engine.paged:
        if alloc is None or not alloc.owned.get(slot):
            raise ValueError("paged poisoning needs the slot's page ids")
        pid = int(alloc.owned[slot][0])
        for pool in cache.pools:             # [La, P, ...]
            pool[:, pid] = nan
    else:
        for t in cache.states:               # [La, B, ...]
            t[:, slot] = nan
    return cache
