"""Fault records (port of ``repro.dist.fault``'s ``FaultEvent``).

One event type for every supervisor's post-mortem: the serving layer's
injected faults, restarts and circuit-breaker trips
(``serve/faults.py``, ``serve/resilient.py``, ``core/xaif.py``) all log
it. ``InjectedFault`` (JAX keeps it in ``repro.serve.faults``, which
re-exports it here) lives beside it, so that the XAIF registry's circuit
breaker can tell an injected fault from a real one without importing the
serving layer. The training loop's ``ResilientLoop`` and
``run_with_restarts`` are not ported yet: they belong to LM training.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FaultEvent:
    kind: str       # "inject" | "inject-stall" | "restart" | "circuit-breaker"
    step: int
    info: str = ""
    t: float = field(default_factory=time.time)


class InjectedFault(RuntimeError):
    """Raised by ``serve.faults.FaultInjector.check`` at an armed site."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected fault at site {site!r} call #{index}")
        self.site = site
        self.index = index
