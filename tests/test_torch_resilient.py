"""The port's fault-tolerant serving (``repro_torch.serve.faults``,
``serve.resilient``, ``SlotEngine.snapshot`` / ``restore``,
``PageAllocator.clone``, ``core.xaif.CircuitBreaker``) against the JAX
package's.

JAX's ``world`` fixture (``tests/test_resilient_serving.py``) in fp32: the
reduced chatglm3-6b with JAX's parameters (QKV biases and norm scales
drawn away from 0 / 1, which would hide a missing bias or scale) on both
sides, 8 requests (prompts of 4-20 tokens, budgets 6-12), 3 slots of 64
positions, chunks of 4 steps, pages of 8. A greedy supervised stream with
one fault at any site, on the contiguous, paged and prefix-sharing
engines, gives JAX's ``serve_resilient`` tokens, restarts, fault counts
and event log, and the port's uninterrupted run's tokens. Seeded sampled
streams replay the port's uninterrupted run bitwise (the generators are
not JAX's). The port's engine writes K/V, recurrent state and generators
in place, so a fault in the middle of a decode chunk leaves the live
buffers half advanced: the restore must not read them. Everything runs
the plain fp32 path on the CPU, so tokens are held exactly.
"""
import dataclasses
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro.serve.faults import InjectedFault as JaxInjectedFault
from repro.serve.paging import PageAllocator as JaxPageAllocator
from repro.serve.resilient import serve_resilient as jax_serve_resilient
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import RunConfig as PortRunConfig
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import xaif
from repro_torch.dist.fault import FaultEvent
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig
from repro_torch.serve.faults import (SITES, FaultInjector, InjectedFault,
                                      arm, armed, chaos_backends,
                                      poison_slot)
from repro_torch.serve.paging import PageAllocator
from repro_torch.serve.resilient import (WatchdogTimeout, _restore_snapshot,
                                         _take_snapshot, serve_resilient)
from repro_torch.serve.scheduler import (REASON_NAN, Request, SlotScheduler,
                                         serve)

ARCH = "chatglm3-6b"
ENGINE = dict(capacity=3, max_len=64, chunk=4)
ENGINE_KW = {
    "contig": dict(paged=False),
    "paged": dict(paged=True, page_size=8),
    "prefix": dict(paged=True, page_size=8, prefix_sharing=True),
}
# host page allocation and the swap gather exist on the paged path only
SITES_FOR = {
    "contig": ("prefill", "decode"),
    "paged": ("prefill", "decode", "page_alloc", "swap"),
    "prefix": ("prefill", "decode", "page_alloc", "swap"),
}
CASES = [(kind, site) for kind, sites in SITES_FOR.items() for site in sites]
SAMPLING = dict(temperature=0.8, top_k=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are thousands of small ops: one intra-op
    thread each (restored after the module). Under the suite's parallel
    workers, threads that wait for a core slow such runs tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """QKV biases N(0, 0.5^2) and norm scales 1 + U(-0.5, 0.5) in place of
    JAX's zero / one init."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        a = np.asarray(node)
        if key in ("bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key == "scale":
            return (1 + rng.uniform(-0.5, 0.5, a.shape)).astype(a.dtype)
        return a
    return walk(tree)


@pytest.fixture(scope="module")
def world():
    jcfg = get_arch(ARCH).reduced(dtype="float32")
    pcfg = port_arch(ARCH).reduced(dtype="float32")
    host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    host = _perturb(host, np.random.default_rng(3))
    rng = np.random.default_rng(11)
    protos = []
    for i in range(8):
        t = int(rng.integers(4, 21))
        protos.append(dict(
            rid=i, prompt=rng.integers(0, jcfg.vocab_size, (t,),
                                       dtype=np.int32),
            max_new_tokens=int(rng.integers(6, 13))))

    def requests(make=Request, seeded=False):
        out = [make(**p) for p in protos]
        if seeded:
            for r in out:
                r.seed = 100 + r.rid
        return out

    return dict(jcfg=jcfg, pcfg=pcfg,
                jparams=jax.tree_util.tree_map(jnp.asarray, host),
                params=params_from_jax(host, device="cpu"),
                requests=requests, engines={})


def _engine(world, kind, sampled=False, run=None, **kw):
    """One port engine per (kind, sampled) for the default policy (its
    state lives in the scheduler, so streams can share it)."""
    key = (kind, sampled)
    if run is not None or kw or key not in world["engines"]:
        eng = SlotEngine(run if run is not None else world["pcfg"],
                         device="cpu", **ENGINE, **ENGINE_KW[kind],
                         **(SAMPLING if sampled else {}), **kw)
        if run is not None or kw:
            return eng
        world["engines"][key] = eng
    return world["engines"][key]


def _tokens(report):
    return {r.rid: list(r.tokens) for r in report.requests}


def _events(inj):
    return [(e.kind, e.step, e.info) for e in inj.events]


@pytest.fixture(scope="module")
def jax_runs(world):
    """JAX's uninterrupted serve and its supervised stream at each (kind,
    site) of ``CASES`` (one fault at the site's call 1), on one JAX engine
    a kind (its traces are built once)."""
    out = {}
    for kind in ENGINE_KW:
        run = RunConfig(arch=world["jcfg"], shape=SHAPES_BY_NAME["decode_32k"],
                        accel=AccelConfig())
        eng = JaxSlotEngine(run, **ENGINE, **ENGINE_KW[kind])
        ref = jax_serve(eng, world["jparams"], world["requests"](JaxRequest))
        out[kind] = _tokens(ref)
        for site in SITES_FOR[kind]:
            inj = JaxFaultInjector(schedule={site: [1]})
            rep = jax_serve_resilient(eng, world["jparams"],
                                      world["requests"](JaxRequest),
                                      snapshot_every=2, injector=inj)
            out[kind, site] = (_tokens(rep), rep.stats, _events(inj),
                               dict(inj.calls))
    return out


# ---------------------------------------------------------------------------
# Kill and resume: one fault at every site of every engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,site", CASES,
                         ids=[f"{k}-{s}" for k, s in CASES])
def test_kill_and_resume_matches_jax(world, jax_runs, kind, site):
    eng = _engine(world, kind)
    ref = serve(eng, world["params"], world["requests"]())
    assert not ref.rejected
    assert _tokens(ref) == jax_runs[kind]
    inj = FaultInjector(schedule={site: [1]})
    rep = serve_resilient(eng, world["params"], world["requests"](),
                          snapshot_every=2, injector=inj)
    jtoks, jstats, jevents, jcalls = jax_runs[kind, site]
    assert inj.fired == 1 and rep.stats["restarts"] >= 1, site
    assert rep.completion_rate == 1.0
    assert _tokens(rep) == _tokens(ref) == jtoks
    for key in ("restarts", "faults_injected", "breaker_trips"):
        assert rep.stats[key] == jstats[key], key
    assert _events(inj) == jevents
    assert inj.calls == jcalls
    # the supervisor disarms the injector after the stream
    assert eng.injector is None and armed() is None


@pytest.mark.parametrize("kind", list(ENGINE_KW))
def test_kill_and_resume_seeded_sampling_replays_bitwise(world, kind):
    """Seeded sampled streams: each site's fault, and then one fault at
    every site in one stream, replay the uninterrupted run bitwise (the
    slots' generators come back with their states)."""
    eng = _engine(world, kind, sampled=True)
    ref = serve(eng, world["params"], world["requests"](seeded=True))
    greedy = serve(_engine(world, kind), world["params"],
                   world["requests"]())
    assert _tokens(ref) != _tokens(greedy)
    schedules = [{site: [1]} for site in SITES_FOR[kind]]
    schedules.append({site: [1] for site in SITES_FOR[kind]})
    for schedule in schedules:
        inj = FaultInjector(schedule=schedule)
        rep = serve_resilient(eng, world["params"],
                              world["requests"](seeded=True),
                              snapshot_every=2, injector=inj)
        assert inj.fired == len(schedule), schedule
        assert rep.stats["restarts"] == len(schedule)
        assert rep.completion_rate == 1.0
        assert _tokens(rep) == _tokens(ref), schedule


def test_repeated_faults_and_restart_budget(world):
    """Several faults across sites in one stream: bounded restarts absorb
    them; an exhausted budget raises, and the supervisor still puts the
    injector and the breaker back."""
    eng = _engine(world, "paged")
    ref = serve(eng, world["params"], world["requests"]())
    inj = FaultInjector(schedule={"decode": [1, 3], "prefill": [4]})
    rep = serve_resilient(eng, world["params"], world["requests"](),
                          snapshot_every=2, injector=inj)
    assert inj.fired == 3 and rep.stats["restarts"] == 3
    assert rep.completion_rate == 1.0 and _tokens(rep) == _tokens(ref)
    assert rep.stats["recovery_s_max"] >= rep.stats["recovery_s_mean"] > 0
    with pytest.raises(InjectedFault):
        serve_resilient(eng, world["params"], world["requests"](),
                        snapshot_every=2, max_restarts=0,
                        breaker=xaif.CircuitBreaker(),
                        injector=FaultInjector(schedule={"decode": [1]}))
    assert eng.injector is None and armed() is None
    assert xaif.active_breaker() is None


# ---------------------------------------------------------------------------
# A fault in the middle of a decode chunk: the live buffers are half
# advanced, the restore must come from the host copy alone
# ---------------------------------------------------------------------------


class _DecodeSpy:
    """Wraps an engine's ``decode`` and ``restore`` on the instance: the
    injector's ``backend`` count at each decode's entry and exit, and at
    each restore whether the buffers the failed chunk ran on differ from
    what they held at its entry (K/V rows written, generators drawn)."""

    def __init__(self, eng, inj):
        self.eng, self.inj = eng, inj
        self.bounds, self.moved = [], []
        self._live = None
        decode, restore = eng.decode, eng.restore

        def spy_decode(params, cache, st):
            states = cache.states if not eng.paged else tuple(cache.pools)
            entry = ([t.clone() for t in states],
                     None if st.rng is None else
                     [g.get_state() for g in st.rng])
            self._live = (states, st, entry)
            start = inj.calls["backend"]
            out = decode(params, cache, st)
            self.bounds.append((start, inj.calls["backend"]))
            return out

        def spy_restore(snap, cache, alloc=None):
            states, st, (kv0, rng0) = self._live
            kv_moved = any(not torch.equal(a, b) for a, b in zip(states, kv0))
            rng_moved = rng0 is not None and any(
                not torch.equal(g.get_state(), s)
                for g, s in zip(st.rng, rng0))
            self.moved.append((kv_moved, rng_moved))
            return restore(snap, cache, alloc)

        eng.decode, eng.restore = spy_decode, spy_restore


@pytest.mark.parametrize("kind", ["contig", "paged"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_mid_step_backend_fault_replays_bitwise(world, kind, sampled):
    with chaos_backends(("rmsnorm",)):
        run = PortRunConfig(arch=world["pcfg"],
                            policy=xaif.Policy({"rmsnorm": "chaos"}))
        eng = _engine(world, kind, sampled, run=run)
        ref = serve(_engine(world, kind, sampled), world["params"],
                    world["requests"](seeded=sampled))
        probe = FaultInjector()
        spy = _DecodeSpy(eng, probe)
        clean = serve_resilient(eng, world["params"],
                                world["requests"](seeded=sampled),
                                snapshot_every=2, injector=probe)
        assert _tokens(clean) == _tokens(ref) and not spy.moved
        # the middle of the third chunk: after the snapshot of chunk 2
        lo, hi = spy.bounds[2]
        inj = FaultInjector(schedule={"backend": [(lo + hi) // 2]})
        spy = _DecodeSpy(eng, inj)
        rep = serve_resilient(eng, world["params"],
                              world["requests"](seeded=sampled),
                              snapshot_every=2, injector=inj)
    assert rep.stats["restarts"] == 1 and inj.fired == 1
    assert spy.moved == [(True, sampled)]
    assert rep.completion_rate == 1.0
    assert _tokens(rep) == _tokens(ref)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------


def test_circuit_breaker_pins_the_op_and_matches_plain(world):
    ops_before = dict(xaif._NAMED)
    counters_before = set(xaif.launch_counts())
    with chaos_backends(("rmsnorm", "gemm")):
        run = PortRunConfig(arch=world["pcfg"],
                            policy=xaif.Policy({"rmsnorm": "chaos"}))
        ref = serve(_engine(world, "contig", run=run), world["params"],
                    world["requests"]())
        for kind in ("contig", "paged"):
            eng = _engine(world, kind, run=run)
            inj = FaultInjector(schedule={"backend": [0]})
            breaker = xaif.CircuitBreaker(events=inj.events)
            rep = serve_resilient(eng, world["params"], world["requests"](),
                                  injector=inj, breaker=breaker)
            # the breaker absorbed the raise inside the call: no restart
            assert rep.stats["restarts"] == 0
            assert rep.stats["breaker_trips"] == breaker.trips == 1
            # a Policy has no buckets: the whole op is pinned (JAX's "*")
            assert breaker.pinned == {("rmsnorm", "*"): "ref"}
            assert [e.kind for e in inj.events] == ["inject",
                                                    "circuit-breaker"]
            assert "op=rmsnorm" in inj.events[1].info
            assert rep.completion_rate == 1.0
            assert _tokens(rep) == _tokens(ref), kind
            assert xaif.active_breaker() is None
            # without a breaker the same fault is a crash and a restart
            inj = FaultInjector(schedule={"backend": [0]})
            rep = serve_resilient(eng, world["params"], world["requests"](),
                                  snapshot_every=2, injector=inj)
            assert rep.stats["restarts"] == 1
            assert rep.stats["breaker_trips"] == 0
            assert _tokens(rep) == _tokens(ref), kind
    assert dict(xaif._NAMED) == ops_before
    assert set(xaif.launch_counts()) == counters_before
    with pytest.raises(ValueError):
        xaif.Policy({"rmsnorm": "chaos"})


def test_breaker_is_the_only_fallback_and_counts_every_trip():
    x = torch.randn(2, 8)
    scale = torch.rand(8) + 0.5
    want = xaif.entry("rmsnorm").plain(x, scale)
    with chaos_backends(("rmsnorm",)):
        policy = xaif.Policy({"rmsnorm": "chaos"})
        prev = arm(FaultInjector(schedule={"backend": [0, 1]}))
        try:
            with pytest.raises(InjectedFault):     # no breaker: it raises
                xaif.call("rmsnorm", policy, x, scale)
            b = xaif.CircuitBreaker()
            assert xaif.install_breaker(b) is None
            try:
                got = xaif.call("rmsnorm", policy, x, scale)
                assert torch.equal(got, want) and b.trips == 1
                # pinned: the chaos backend is not called again
                assert torch.equal(xaif.call("rmsnorm", policy, x, scale),
                                   want)
                assert armed().calls["backend"] == 2 and b.trips == 1
                # the default plain version raising is not degraded around
                bad = torch.randn(2, 8)
                with pytest.raises(Exception):
                    xaif.call("rmsnorm", "auto", bad, torch.rand(7))
                assert b.trips == 1
            finally:
                assert xaif.install_breaker(None) is b
        finally:
            arm(prev)
    (ev,) = b.events
    assert isinstance(ev, FaultEvent) and ev.kind == "circuit-breaker"
    assert "InjectedFault" in ev.info and "-> plain" in ev.info


def test_breaker_pins_one_bucket_under_a_dispatch_policy():
    """Under a DispatchPolicy the breaker pins the (op, bucket) cell that
    raised, as JAX's does: the decode-sized rows go to the plain version
    from then on, while the prefill-sized rows keep their own rule."""
    small, scale = torch.randn(2, 8), torch.rand(8) + 0.5
    large = torch.randn(64, 8)
    plain = xaif.entry("rmsnorm").plain
    with chaos_backends(("rmsnorm",)):
        policy = xaif.DispatchPolicy.make({("rmsnorm", "rows_s"): "chaos",
                                           ("rmsnorm", "rows_m"): "chaos"})
        prev = arm(FaultInjector(schedule={"backend": [0]}))
        b = xaif.CircuitBreaker()
        xaif.install_breaker(b)
        try:
            assert torch.equal(xaif.call("rmsnorm", policy, small, scale),
                               plain(small, scale))
            assert b.pinned == {("rmsnorm", "rows_s"): "ref"}
            # rows_m still runs its rule's backend (the chaos site counts)
            assert torch.equal(xaif.call("rmsnorm", policy, large, scale),
                               plain(large, scale))
            assert armed().calls["backend"] == 2
            # rows_s is pinned: the chaos backend is not called again
            xaif.call("rmsnorm", policy, small, scale)
            assert armed().calls["backend"] == 2 and b.trips == 1
        finally:
            xaif.install_breaker(None)
            arm(prev)
    (ev,) = b.events
    assert "op=rmsnorm bucket=rows_s backend=chaos" in ev.info


def test_breaker_lets_a_real_backend_error_through():
    """Only an injected fault trips the breaker: a backend that fails for
    any other reason (a kernel that does not build or launch on the card)
    raises through an installed breaker, and nothing is pinned."""
    x, w = torch.randn(2, 8), torch.randn(8, 4)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    xaif.register("gemm", broken, broken, backend="broken")
    try:
        policy = xaif.Policy({"gemm": "broken"})
        b = xaif.CircuitBreaker()
        prev = xaif.install_breaker(b)
        try:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                xaif.call("gemm", policy, x, w)
        finally:
            xaif.install_breaker(prev)
    finally:
        xaif.unregister("gemm", "broken")
    assert b.trips == 0 and not b.pinned and not b.events


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------


def test_watchdog_stall_recovery(world):
    """A stalled chunk (it completes, too late) trips the watchdog; the
    replay from the snapshot gives the same tokens."""
    eng = _engine(world, "contig")
    ref = serve(eng, world["params"], world["requests"]())
    inj = FaultInjector(stalls={"decode": {2: 1.5}})
    rep = serve_resilient(eng, world["params"], world["requests"](),
                          snapshot_every=2, watchdog_ms=1000.0,
                          injector=inj)
    assert inj.stalled == 1 and inj.fired == 0
    assert rep.stats["restarts"] >= 1
    assert any(e.kind == "restart" and WatchdogTimeout.__name__ in e.info
               for e in inj.events)
    assert rep.completion_rate == 1.0 and _tokens(rep) == _tokens(ref)


# ---------------------------------------------------------------------------
# NaN quarantine: shed exactly the poisoned request, scrub its KV
# ---------------------------------------------------------------------------


def _drain(sched, waiting):
    while waiting or sched.busy:
        progressed = sched.admission_round(waiting, 0.0, False)
        if not sched.busy:
            if not progressed:
                break
            continue
        sched.step_chunk(0.0)


@pytest.mark.parametrize("kind", ["contig", "paged"])
def test_nan_quarantine_sheds_only_poisoned_request(world, kind):
    eng = _engine(world, kind)

    def reqs():
        return [Request(rid=i, prompt=np.arange(5 + i, dtype=np.int32) + 1,
                        max_new_tokens=10) for i in range(3)]

    ref = _tokens(serve(eng, world["params"], reqs()))
    sched = SlotScheduler(eng, world["params"])
    waiting = deque(reqs := reqs())
    sched.admission_round(waiting, 0.0, False)
    assert len(sched.occupant) == 3
    victim = sched.occupant[1]
    sched.step_chunk(0.0)                      # a few clean tokens first
    salvaged = len(victim.tokens)
    sched.cache = poison_slot(eng, sched.cache, 1, sched.alloc)
    _drain(sched, waiting)
    assert victim.reject_reason.startswith(REASON_NAN + ":")
    assert len(victim.tokens) == salvaged      # nothing emitted past it
    for r in reqs:
        if r is not victim:
            assert r.reject_reason is None, r.reject_reason
            assert list(r.tokens) == ref[r.rid], r.rid


def test_nan_quarantine_scrubs_pages_for_reuse(world):
    """After a quarantine the poisoned pages go back to the pool: the
    requests admitted into them must decode clean (0 x NaN = NaN survives
    read-time masking, so the scrub is load-bearing)."""
    eng = _engine(world, "paged")
    protos = [dict(rid=i, prompt=np.arange(5 + (i % 3), dtype=np.int32) + 1,
                   max_new_tokens=8) for i in range(6)]
    ref = _tokens(serve(eng, world["params"], [Request(**p)
                                               for p in protos]))
    reqs = [Request(**p) for p in protos]
    sched = SlotScheduler(eng, world["params"])
    waiting = deque(reqs)
    sched.admission_round(waiting, 0.0, False)   # fills the 3 slots
    victim = sched.occupant[0]
    poisoned = list(sched.alloc.owned[0])
    sched.step_chunk(0.0)
    sched.cache = poison_slot(eng, sched.cache, 0, sched.alloc)
    _drain(sched, waiting)
    assert [r for r in reqs if r.reject_reason is not None] == [victim]
    assert poisoned[0] in sched.alloc.free
    for r in reqs:
        if r is not victim:
            assert list(r.tokens) == ref[r.rid], r.rid
    for pool in sched.cache.pools:
        assert torch.isfinite(pool[:, 1:]).all()


# ---------------------------------------------------------------------------
# Snapshot / restore: allocator clones, a restore into a fresh scheduler,
# the draft's cache, a hybrid's recurrent state
# ---------------------------------------------------------------------------


def _alloc_state(al):
    return (al.table.tolist(), list(al.free), dict(al.refcnt),
            {s: list(p) for s, p in al.owned.items()}, dict(al.reserved),
            al.peak_pages, al.dirty,
            None if al.index is None else
            sorted((pid, n.stamp, n.edge) for pid, n in al.index.pages.items()),
            None if al.index is None else al.index._clock)


def test_allocator_clone_is_independent_and_matches_jax():
    inj = FaultInjector()
    allocs = [cls(9, 3, 4, 4, sharing=True) for cls in (PageAllocator,
                                                        JaxPageAllocator)]
    for al in allocs:
        al.injector = inj if isinstance(al, PageAllocator) else None
        p = np.arange(1, 11, dtype=np.int32)
        al.admit(0, 12, 10, 4)
        al.register(p, 0)
        al.ensure(0, 12)
        al.admit(1, 8, 6, 2)
    port, jax_al = allocs
    assert _alloc_state(port) == _alloc_state(jax_al)
    dups = [al.clone() for al in allocs]
    assert dups[0].injector is inj and dups[0] is not port
    assert _alloc_state(dups[0]) == _alloc_state(port)
    before = _alloc_state(dups[0])
    for al in allocs:               # mutate the originals ...
        al.release(0)
        al.release(1)
        al.match(np.arange(1, 11, dtype=np.int32))
    assert _alloc_state(dups[0]) == before      # ... the clones keep theirs
    assert _alloc_state(port) == _alloc_state(jax_al)
    for d in dups:                  # and the other way round
        d.release(1)
    assert _alloc_state(dups[0]) == _alloc_state(dups[1])
    assert _alloc_state(port) != _alloc_state(dups[0])
    assert inj.calls["page_alloc"] == 6      # 3 + 1 + 2 pops


def _check_alloc_invariants(alloc, capacity):
    for slot in range(capacity):
        owned = alloc.owned.get(slot, [])
        assert list(alloc.table[slot, :len(owned)]) == owned
        assert (alloc.table[slot, len(owned):] == -1).all()
    expect = {}
    for pages in alloc.owned.values():
        for p in pages:
            expect[p] = expect.get(p, 0) + 1
    if alloc.index is not None:
        for p in alloc.index.pages:
            expect[p] = expect.get(p, 0) + 1
    assert expect == alloc.refcnt
    assert set(alloc.free) | set(alloc.refcnt) == set(range(1,
                                                            alloc.num_pages))
    assert not set(alloc.free) & set(alloc.refcnt)


@pytest.mark.parametrize("seed,snap_at,sharing", [
    (0, 1, False), (1, 3, False), (2, 2, True), (3, 4, True)])
def test_snapshot_restore_into_a_fresh_scheduler(world, seed, snap_at,
                                                 sharing):
    """JAX's fixed-boundary case: snapshot at a chunk boundary under
    backfill churn, restore into a fresh scheduler, finish: the tokens of
    the uninterrupted run, the allocator's invariants intact."""
    eng = _engine(world, "prefix" if sharing else "paged")
    rng = np.random.default_rng(seed)
    vocab = world["pcfg"].vocab_size
    shared = rng.integers(0, vocab, (8,), dtype=np.int32)
    reqs = []
    for i in range(6):
        t = int(rng.integers(3, 14))
        p = rng.integers(0, vocab, (t,), dtype=np.int32)
        if sharing and rng.random() < 0.5:
            p = np.concatenate([shared, p])
        reqs.append(Request(rid=i, prompt=p,
                            max_new_tokens=int(rng.integers(4, 10))))
    sched = SlotScheduler(eng, world["params"])
    waiting = deque(reqs)
    snap, chunks, decode_tokens = None, 0, 0
    while waiting or sched.busy:
        progressed = sched.admission_round(waiting, 0.0, False)
        if not sched.busy:
            if not progressed:
                break
            continue
        decode_tokens += sched.step_chunk(0.0)
        chunks += 1
        if chunks == snap_at:
            snap = _take_snapshot(eng, sched, waiting, reqs, decode_tokens)
    assert snap is not None and all(r.reject_reason is None for r in reqs)
    ref = {r.rid: list(r.tokens) for r in reqs}
    for _ in range(2):              # the snapshot restores more than once
        sched2 = SlotScheduler(eng, world["params"])
        waiting2, _ = _restore_snapshot(eng, sched2, snap, reqs)
        _drain(sched2, waiting2)
        assert {r.rid: list(r.tokens) for r in reqs} == ref
        _check_alloc_invariants(sched2.alloc, eng.capacity)
        if not sharing:
            assert not sched2.alloc.owned and not sched2.alloc.reserved


def test_speculative_snapshot_carries_the_draft_cache(world):
    """A sampled speculative stream's proposals feed its acceptance rule,
    so the draft's contiguous cache is part of the snapshot: a restore
    brings it back bitwise over a draft cache filled with garbage, and a
    faulted stream replays the uninterrupted one."""
    draft = dataclasses.replace(world["pcfg"], name="draft-1l", num_layers=1,
                                early_exit=None)
    cfg = dataclasses.replace(world["pcfg"], early_exit=None)
    eng = SlotEngine(cfg, device="cpu", **ENGINE, paged=True, page_size=8,
                     spec=SpecConfig(draft_arch=draft, k=2, draft_seed=1),
                     **SAMPLING)
    ref = serve(eng, world["params"], world["requests"](seeded=True))
    sched = SlotScheduler(eng, world["params"])
    sched.admission_round(deque(world["requests"](seeded=True)), 0.0, False)
    sched.step_chunk(0.0)
    snap = eng.snapshot(sched.cache, sched.state, sched.alloc)
    want = [t.clone() for t in eng._draft_cache.states]
    with torch.inference_mode():
        for t in eng._draft_cache.states:
            t.fill_(float("nan"))
        eng._draft_cache.pos.fill_(7)
    eng.restore(snap, sched.cache, sched.alloc.clone())
    assert all(torch.equal(a, b) for a, b in
               zip(eng._draft_cache.states, want))
    inj = FaultInjector(schedule={"decode": [2], "swap": [1]})
    rep = serve_resilient(eng, world["params"],
                          world["requests"](seeded=True), snapshot_every=2,
                          injector=inj)
    assert rep.stats["restarts"] == 2 and rep.completion_rate == 1.0
    assert _tokens(rep) == _tokens(ref)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_hybrid_snapshot_restores_state_written_in_place(paged):
    """Reduced jamba: the decode step writes the Mamba conv window and SSM
    state in place, so a snapshot that kept references would restore the
    advanced state. A restore after another chunk gives back the captured
    bytes of every cache tensor, and a supervised stream with a decode
    fault replays the uninterrupted run."""
    cfg = port_arch("jamba-v0.1-52b").reduced(dtype="float32")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = SlotEngine(cfg, device="cpu", capacity=3, max_len=48, chunk=4,
                     **kw)
    rng = np.random.default_rng(5)
    protos = [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, (t,),
                                              dtype=np.int32),
                   max_new_tokens=n)
              for i, (t, n) in enumerate([(9, 10), (6, 7), (11, 9), (5, 8)])]
    ref = serve(eng, params, [Request(**p) for p in protos])
    sched = SlotScheduler(eng, params)
    sched.admission_round(deque(Request(**p) for p in protos), 0.0, False)
    sched.step_chunk(0.0)
    snap = eng.snapshot(sched.cache, sched.state, sched.alloc)
    assert snap["kind"] == "full"
    want = [t.clone() for t in lm._leaves(list(sched.cache.recurrent))
            + list(sched.cache.pools if paged else sched.cache.states)]
    conv = sched.cache.conv
    sched.step_chunk(0.0)                     # writes the state in place
    assert sched.cache.conv is conv and not torch.equal(conv, want[0])
    cache, _ = eng.restore(snap, sched.cache,
                           sched.alloc.clone() if paged else None)
    got = lm._leaves(list(cache.recurrent)) + list(
        cache.pools if paged else cache.states)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0] is conv          # written back in place: no second cache
    inj = FaultInjector(schedule={"decode": [2]})
    rep = serve_resilient(eng, params, [Request(**p) for p in protos],
                          snapshot_every=2, injector=inj)
    assert rep.stats["restarts"] == 1 and rep.completion_rate == 1.0
    assert _tokens(rep) == _tokens(ref)


# ---------------------------------------------------------------------------
# Injector units, the supervisor's refusals, the launcher
# ---------------------------------------------------------------------------


def test_injector_fires_where_jax_fires():
    ev = []
    sides = [FaultInjector(rates={"decode": 0.5, "swap": 0.2}, seed=3,
                           max_faults=4, events=ev),
             JaxFaultInjector(rates={"decode": 0.5, "swap": 0.2}, seed=3,
                              max_faults=4)]
    fires = [[], []]
    for i in range(40):
        for site in ("decode", "swap"):
            for inj, out, exc in zip(sides, fires,
                                     (InjectedFault, JaxInjectedFault)):
                try:
                    inj.check(site)
                except exc as e:
                    out.append((site, i, e.index))
    assert fires[0] == fires[1] and len(fires[0]) == 4
    assert sides[0].fired == 4 and len(ev) == 4
    assert sides[0].calls == sides[1].calls
    assert [(e.kind, e.step, e.info) for e in ev] == \
        [(e.kind, e.step, e.info) for e in sides[1].events]
    with pytest.raises(ValueError):
        FaultInjector(schedule={"nope": [0]})
    assert SITES == ("prefill", "decode", "page_alloc", "swap", "backend")
    prev = arm(sides[0])
    try:
        assert armed() is sides[0]
    finally:
        assert arm(prev) is sides[0]


def test_supervisor_refuses_persistent_index(world):
    eng = SlotEngine(world["pcfg"], device="cpu", **ENGINE, paged=True,
                     page_size=8, prefix_sharing=True,
                     persistent_prefix_index=True)
    with pytest.raises(ValueError, match="persistent"):
        serve_resilient(eng, world["params"], world["requests"]())
    with pytest.raises(ValueError):
        serve_resilient(_engine(world, "contig"), world["params"],
                        world["requests"](), snapshot_every=0)


def test_cli_chaos_line_and_refusals(capsys):
    report = launch_serve.main([
        "--arch", ARCH, "--device", "cpu", "--paged", "--requests", "8",
        "--inject-fault", "site=page_alloc,chunk=2"])
    out = capsys.readouterr().out
    assert "chaos[site=page_alloc chunk=2]: restarts=1 faults=1" in out
    assert "tokens identical to the fault-free run" in out
    assert report.stats["restarts"] == 1 and not report.rejected
    for argv in (["--inject-fault", "site=swap,chunk=0"],
                 ["--inject-fault", "site=page_alloc,chunk=0"],
                 ["--inject-fault", "site=nope,chunk=0"],
                 ["--inject-fault", "site=decode"],
                 ["--inject-fault", "site=decode,chunk=-1"],
                 ["--inject-fault", "decode"],
                 ["--paged", "--preemption", "--inject-fault",
                  "site=decode,chunk=1"],
                 ["--priority", "3", "--watchdog-ms", "100"],
                 ["--paged", "--prefill-chunk", "16", "--watchdog-ms", "9"],
                 ["--watchdog-ms", "-1"], ["--snapshot-every", "0"],
                 ["--max-restarts", "-1"]):
        with pytest.raises(SystemExit) as e:
            launch_serve.main(["--arch", ARCH, "--device", "cpu"] + argv)
        assert e.value.code == 2, argv
    with pytest.raises(SystemExit, match="never fired"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                           "2", "--inject-fault", "site=decode,chunk=999"])
