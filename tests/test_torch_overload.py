"""The port's overload control (``repro_torch.serve.overload``: optimistic
paging, preemption with host swap or recompute resume, priorities with
aging, SLO sheds, chunked admission) against the JAX package's.

Host side: the port's optimistic ``PageAllocator`` keeps every invariant
over 300 steps of admit / grow / preempt-swap-resume churn and replays the
same call sequence as JAX's allocator (free lists, tables, refcounts and
the steps that run dry). Model side: ``lm.gather_pages`` /
``scatter_pages`` give JAX's blocks and pools on GQA, MLA and hybrid
paged caches. Serving, on the reduced chatglm3-6b (QKV biases, half
rotary; the biases and norm scales drawn away from JAX's 0 / 1 init) with
JAX's parameters carried across: every request served under overload
(swap-resumed, recompute-resumed, chunk-admitted) gives the tokens of
JAX's UNCONTENDED run; with the clock pinned, the port's scheduler makes
JAX's decisions (preemptions, swaps, resumes, chunked admissions, each
request's preemptions and reject reason); a sampled stream's swap resumes
continue each seeded request's uncontended stream bitwise (the victim's
generator state is restored); reduced deepseek (MLA latent pages) swaps
and reduced jamba (Mamba state is not paged) resumes by recompute only,
both making JAX's decisions and giving JAX's tokens. Everything runs the plain
fp32 path on the CPU, so tokens are held exactly. JAX's tests
(``tests/test_overload.py``) run the same scenarios on JAX alone.
"""
import dataclasses
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.engine import generate as jax_generate
from repro.serve.overload import OverloadConfig as JaxOverloadConfig
from repro.serve.overload import OverloadScheduler as JaxOverloadScheduler
from repro.serve.paging import PageAllocator as JaxPageAllocator
from repro.serve.paging import PoolExhausted as JaxPoolExhausted
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import poisson_requests as jax_poisson
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve import overload as overload_mod
from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.overload import (HostSwapPool, OverloadConfig,
                                        OverloadScheduler, PreemptionPolicy,
                                        _SwapRecord)
from repro_torch.serve.paging import PageAllocator, PoolExhausted
from repro_torch.serve.scheduler import (Request, ServeReport,
                                         SlotScheduler, poisson_requests,
                                         serve)

POLICY = AccelConfig()            # the JAX package's all-ref policy
ARCH = "chatglm3-6b"
# JAX's test geometry: 3 slots of 64 positions, chunks of 4 steps, pages
# of 8; 14 pages (13 usable) is under half the worst case of 3 x 8 + 1
ENGINE = dict(capacity=3, max_len=64, chunk=4, paged=True, page_size=8)
SMALL_POOL = 14
EXHAUSTED = (PoolExhausted, JaxPoolExhausted)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are thousands of small ops: one intra-op
    thread each (restored after the module). Under the suite's parallel
    workers, threads that wait for a core slow such runs tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(jcfg):
    return RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                     accel=POLICY)


def _perturb(tree, rng):
    """QKV biases N(0, 0.5^2) and norm scales 1 + U(-0.5, 0.5) in place of
    JAX's zero / one init, which would hide a missing bias or scale."""
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


# ---------------------------------------------------------------------------
# Allocator: 300-step churn under optimistic admission, on both
# ---------------------------------------------------------------------------


def _check_alloc_invariants(alloc, capacity: int):
    """Re-derive every allocator invariant from scratch (JAX's check)."""
    for slot in range(capacity):
        owned = alloc.owned.get(slot, [])
        assert list(alloc.table[slot, :len(owned)]) == owned, slot
        assert (alloc.table[slot, len(owned):] == -1).all(), slot
    all_owned = [p for pages in alloc.owned.values() for p in pages]
    assert len(all_owned) == len(set(all_owned))
    expect = {}
    for pages in alloc.owned.values():
        for p in pages:
            expect[p] = expect.get(p, 0) + 1
    if alloc.index is not None:
        for p in alloc.index.pages:
            expect[p] = expect.get(p, 0) + 1
    assert expect == alloc.refcnt
    free, held = set(alloc.free), set(alloc.refcnt)
    assert not (free & held)
    assert free | held == set(range(1, alloc.num_pages))
    assert 0 not in free and 0 not in held      # scratch never circulates


def _state(al):
    return (al.table.tolist(), list(al.free), dict(al.refcnt),
            {s: list(p) for s, p in al.owned.items()}, dict(al.reserved),
            al.available, al.peak_pages, sorted(al.index.pages))


def _churn(classes):
    """JAX's 300-step churn (``tests/test_overload.py``) on one allocator
    of each class in lockstep: the same random ops, each call on all of
    them. A growth that runs dry models preempt -> swap: the victim's
    pages are released and its resume later re-admits pages_for(pos)
    pages with the remaining budget. Asserts the invariants and the same
    state on all after every step; returns (steps that ran dry, resumes)."""
    rng = np.random.default_rng(7)
    ps, cap, num_pages, max_pages = 4, 6, 14, 16
    allocs = [cls(num_pages, cap, max_pages, ps, sharing=True,
                  optimistic=True) for cls in classes]
    first = allocs[0]

    def each(name, *a):
        outs = [getattr(al, name)(*a) for al in allocs]
        for o in outs[1:]:
            np.testing.assert_array_equal(np.asarray(o), np.asarray(outs[0]))
        return outs[0]

    live, resumable, dry, resumes = {}, [], [], 0
    for step in range(300):
        op = rng.choice(["admit", "admit", "grow", "grow", "grow",
                         "release", "resume"])
        free_slots = [s for s in range(cap) if s not in live]
        if op == "resume" and resumable and free_slots:
            t_, remaining, n_keep = resumable.pop()
            if not each("can_admit", n_keep * ps, t_, remaining):
                continue
            slot = free_slots[0]
            each("admit", slot, n_keep * ps, t_, remaining)
            live[slot] = [t_, remaining, t_ - 1]
            resumes += 1
        elif op == "admit" and free_slots:
            t = int(rng.integers(1, 24))
            mn = int(rng.integers(4, 20))
            if t + mn > max_pages * ps:
                continue
            bucket = -(-t // 4) * 4
            if not each("can_admit", bucket, t, mn):
                continue
            slot = free_slots[0]
            each("admit", slot, bucket, t, mn)
            each("register", rng.integers(0, 999, (t,)), slot)
            live[slot] = [t, mn, t - 1]
        elif op == "grow" and live:
            slot = int(rng.choice(sorted(live)))
            t, mn, covered = live[slot]
            target = min(covered + int(rng.integers(1, 6)), t + mn - 1)
            raised = []
            for al in allocs:
                try:
                    al.ensure(slot, target)
                    raised.append(False)
                except EXHAUSTED:
                    raised.append(True)
            assert len(set(raised)) == 1, (step, raised)
            if not raised[0]:
                live[slot][2] = target
            else:
                dry.append(step)
                victim = int(rng.choice(sorted(live)))
                vt, vmn, vcov = live.pop(victim)
                gen = max(vcov + 1 - vt, 1)
                if vmn - gen > 0:
                    resumable.append((vt + gen, vmn - gen,
                                      first.pages_for(vcov + 1)))
                each("release", victim)
        elif op == "release" and live:
            slot = int(rng.choice(sorted(live)))
            del live[slot]
            each("release", slot)
        for al in allocs:
            _check_alloc_invariants(al, cap)
            assert _state(al) == _state(first), step
    return dry, resumes


def test_optimistic_allocator_invariants_under_churn():
    """The port's allocator alone: every invariant after every one of 300
    steps, and the churn reaches the pool running dry and resumes."""
    dry, resumes = _churn([PageAllocator])
    assert len(dry) >= 3 and resumes >= 3, (dry, resumes)


def test_optimistic_allocator_replays_jax_churn():
    """The same 300-step call sequence through JAX's and the port's
    optimistic allocators: equal free lists, tables, refcounts,
    reservations and index pages after every step, and PoolExhausted
    raised at the same steps."""
    dry, resumes = _churn([PageAllocator, JaxPageAllocator])
    assert len(dry) >= 3 and resumes >= 3, (dry, resumes)


def test_optimistic_admission_asks_only_for_the_pages_mapped_now():
    """Optimistic admission needs the bucket's pages (or the COW + suffix
    region), not the worst case; growth follows ownership; a dry pool
    raises PoolExhausted; as JAX's allocator answers."""
    for cls in (PageAllocator, JaxPageAllocator):
        al = cls(6, 2, 8, 4, sharing=True, optimistic=True)
        assert al.can_admit(8, 8, 20)                  # 2 pages, not 7
        al.admit(0, 8, 8, 20)
        assert al.reserved[0] == 2 and al.available == 3
        al.ensure(0, 15)
        assert al.reserved[0] == 4 and len(al.owned[0]) == 4
        al.register(np.arange(8), 0)
        pages, boundary, rem = al.match(np.concatenate([np.arange(8),
                                                        [9, 9, 9]]))
        assert al.can_admit_shared(pages, boundary, rem, 4, 11, 30)
        al.admit_shared(1, pages, boundary, rem, 4, 11, 30)
        assert al.reserved[1] == 3
        with pytest.raises(EXHAUSTED):
            al.ensure(1, 20)
        # the failed growth left the mirror as it was
        assert al.owned[1] == [1, 2, 5] and al.reserved[1] == 6
        assert al.table[1].tolist() == [1, 2, 5, -1, -1, -1, -1, -1]
        assert al.refcnt[1] == al.refcnt[2] == 3 and not al.free


# ---------------------------------------------------------------------------
# gather_pages / scatter_pages against JAX's
# ---------------------------------------------------------------------------


def _attn_layers(cfg):
    return [i for i in range(cfg.num_layers)
            if cfg.layer_spec(i).mixer == "attn"]


def _jax_layer_pool(jcache, cfg, i):
    """JAX's pool state of absolute layer i: a prefix layer's own, or row
    sb of pattern slot j's stack."""
    kd, period = cfg.first_k_dense, cfg.period
    if i < kd:
        return jcache.prefix[i], None
    sb, j = divmod(i - kd, period)
    return jcache.slots[j], sb


def _jax_layer_block(blocks, cfg, i):
    kd, period = cfg.first_k_dense, cfg.period
    pre, slo = blocks
    if i < kd:
        return pre[i]
    sb, j = divmod(i - kd, period)
    return type(slo[j])(*(a[sb] for a in slo[j]))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b"])
def test_gather_scatter_pages_match_jax(arch):
    """From the same random pools (GQA K / V, MLA latent / rotary key; a
    dense prefix layer on deepseek, Mamba layers between jamba's attention
    layers), ``gather_pages`` gives JAX's blocks layer by layer, bitwise,
    and ``scatter_pages`` of those blocks into OTHER page ids gives JAX's
    pools, in place; JAX's recurrent layers give None, as the port keeps
    no block for them."""
    jcfg, pcfg = (get_arch(arch).reduced(dtype="float32"),
                  port_arch(arch).reduced(dtype="float32"))
    n_pool, ps = 12, 4
    rng = np.random.default_rng(11)
    jcache = jlm.init_paged_cache(jcfg, 2, 32, ps, n_pool)

    def rand(a):
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))

    def fill(state):
        if isinstance(state, (jattn.PagedKVCache, jattn.PagedMLACache)):
            return type(state)(*(rand(a) for a in state))
        return state
    jcache = jcache._replace(prefix=tuple(fill(c) for c in jcache.prefix),
                             slots=tuple(fill(c) for c in jcache.slots))
    cache = lm.init_paged_cache(pcfg, 2, 32, ps, n_pool, device="cpu")
    layers = _attn_layers(pcfg)
    for f, pool in enumerate(cache.pools):
        for a, i in enumerate(layers):
            state, sb = _jax_layer_pool(jcache, jcfg, i)
            src = state[f] if sb is None else state[f][sb]
            pool[a].copy_(torch.from_numpy(np.array(src)))
    ids, fresh = [5, 2, 7], [3, 9, 1]
    jblocks = jlm.gather_pages(jcache, jnp.asarray(ids, jnp.int32))
    blocks = lm.gather_pages(cache, torch.tensor(ids))
    assert type(blocks) is type(cache.pools)
    for f, blk in enumerate(blocks):
        assert blk.shape == (len(layers), len(ids)) + cache.pools[f].shape[2:]
        for a, i in enumerate(layers):
            want = np.asarray(_jax_layer_block(jblocks, jcfg, i)[f])
            assert np.array_equal(blk[a].numpy(), want), (f, i)
    for j, spec in enumerate(jcfg.block_pattern):
        if spec.mixer != "attn":
            assert jblocks[1][j] is None
    jnew = jlm.scatter_pages(jcache, jnp.asarray(fresh, jnp.int32), jblocks)
    before = [p.clone() for p in cache.pools]
    out = lm.scatter_pages(cache, torch.tensor(fresh), blocks)
    assert out is cache
    for f, pool in enumerate(cache.pools):
        for a, i in enumerate(layers):
            state, sb = _jax_layer_pool(jnew, jcfg, i)
            want = np.asarray(state[f] if sb is None else state[f][sb])
            assert np.array_equal(pool[a].numpy(), want), (f, i)
        kept = [p for p in range(n_pool) if p not in fresh]
        assert torch.equal(pool[:, kept], before[f][:, kept])
        assert torch.equal(pool[:, fresh], blocks[f])
    with pytest.raises(ValueError):
        lm.scatter_pages(cache, torch.tensor(fresh[:2]), blocks)


def test_swap_methods_round_trip_on_the_engine():
    """``fetch_pages`` copies the blocks off the device (host tensors that
    later pool writes do not touch), ``restore_pages`` writes them into
    fresh ids, ``restore_slot`` re-arms a slot (token, done, generated,
    budget, position, generator state) and ``deactivate_slot`` marks it
    done; page ids outside the pool and swaps on a contiguous engine
    raise."""
    pcfg = port_arch(ARCH).reduced(dtype="float32")
    engine = SlotEngine(pcfg, device="cpu", temperature=0.7, **ENGINE)
    cache, st = engine.init_state()
    with torch.inference_mode():    # the engine's tensors are inference's
        for pool in cache.pools:
            pool.copy_(torch.randn(pool.shape, generator=torch.Generator()
                                   .manual_seed(1)))
    blocks = engine.fetch_pages(cache, [4, 6])
    want = [b.clone() for b in blocks]
    with torch.inference_mode():
        for pool in cache.pools:
            pool.zero_()
    assert all(torch.equal(b, w) for b, w in zip(blocks, want))
    engine.restore_pages(cache, [2, 3], blocks)
    assert all(torch.equal(pool[:, [2, 3]], w)
               for pool, w in zip(cache.pools, want))
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    state = gen.get_state()
    cache, st = engine.restore_slot(cache, st, 1, token=17, budget=4, pos=9,
                                    rng_state=state)
    assert (int(st.tokens[1]), bool(st.done[1]), int(st.generated[1]),
            int(st.budget[1]), int(cache.pos[1])) == (17, False, 0, 4, 9)
    assert torch.equal(torch.rand(4, generator=st.rng[1]),
                       torch.rand(4, generator=gen))
    st = engine.deactivate_slot(st, 1)
    assert bool(st.done[1])
    for bad in ([0], [engine.num_pages], []):
        with pytest.raises(ValueError):
            engine.fetch_pages(cache, bad)
    flat = SlotEngine(pcfg, device="cpu", capacity=2, max_len=32)
    with pytest.raises(ValueError):
        flat.fetch_pages(flat.init_state()[0], [1])


# ---------------------------------------------------------------------------
# End to end on chatglm3-6b, against JAX's uncontended tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """JAX's fixture (``tests/test_overload.py``) in fp32: the reduced
    chatglm3-6b with JAX's parameters (biases and scales perturbed) on
    both sides, 10 requests (prompts of 5-40 tokens, budgets 4-11,
    priorities 0-2) and JAX's uncontended paged serve."""
    jcfg = get_arch(ARCH).reduced(dtype="float32")
    pcfg = port_arch(ARCH).reduced(dtype="float32")
    host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    host = _perturb(host, np.random.default_rng(3))
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    rng = np.random.default_rng(3)
    protos = []
    for i in range(10):
        t = int(rng.integers(5, 41))       # some prompts > a chunk of 16
        protos.append(dict(
            rid=i, prompt=rng.integers(0, jcfg.vocab_size, (t,),
                                       dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 12)),
            priority=int(rng.integers(0, 3))))

    def requests(make=Request):
        return [make(**p) for p in protos]

    ref = jax_serve(JaxSlotEngine(_run(jcfg), **ENGINE), jparams,
                    requests(JaxRequest))
    assert not ref.rejected
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jparams,
                params=params_from_jax(host, device="cpu"),
                requests=requests,
                ref_tokens={r.rid: list(r.tokens) for r in ref.served})


def _engine(served, **kw):
    return SlotEngine(served["pcfg"], device="cpu", **{**ENGINE, **kw})


class _Keep:
    """Keeps the overload scheduler ``serve()`` builds (the module's class
    replaced by a subclass that records its instances)."""

    def __init__(self, monkeypatch):
        self.scheds = []
        keep = self

        class Kept(OverloadScheduler):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                keep.scheds.append(self)

        monkeypatch.setattr(overload_mod, "OverloadScheduler", Kept)


def _drained(alloc):
    """After a drained stream every page is free or index-held."""
    assert not alloc.owned and not alloc.reserved
    _check_alloc_invariants(alloc, alloc.table.shape[0])


def test_preempt_swap_resume_token_identity(served, monkeypatch):
    """A pool under half the worst case, preemption with host swap:
    everything completes, swaps happen, and every request's tokens equal
    JAX's uncontended run; the pool drains clean; the report's TTFT, ITL
    and breakdown are filled."""
    keep = _Keep(monkeypatch)
    rep = serve(_engine(served, num_pages=SMALL_POOL), served["params"],
                served["requests"](), overload=OverloadConfig())
    assert not rep.rejected, [r.reject_reason for r in rep.rejected]
    assert rep.stats["preemptions"] >= 1
    assert rep.stats["swap_resumes"] >= 1
    assert rep.stats["swap_outs"] == rep.stats["swap_resumes"]
    assert rep.stats["peak_pages"] <= SMALL_POOL - 1
    for r in rep.served:
        assert r.tokens == served["ref_tokens"][r.rid], r.rid
    _drained(keep.scheds[0].alloc)
    assert len(keep.scheds[0].swap_pool) == 0
    assert all(r.t_first_token is not None for r in rep.served)
    assert all(r.itl for r in rep.served if len(r.tokens) > 1)
    assert all(np.isfinite(v) for v in rep.breakdown().values())
    assert np.isfinite(rep.ttft_percentiles()["p99"])
    assert np.isfinite(rep.itl_percentiles()["p50"])
    assert rep.completion_rate == 1.0


def test_preempt_recompute_resume_token_identity(served):
    """swap=False sends every resume through a re-prefill of prompt ++
    generated with the remaining budget: tokens still equal JAX's
    uncontended run."""
    rep = serve(_engine(served, num_pages=SMALL_POOL), served["params"],
                served["requests"](), overload=OverloadConfig(swap=False))
    assert not rep.rejected
    assert rep.stats["preemptions"] >= 1
    assert rep.stats["swap_resumes"] == 0 == rep.stats["swap_outs"]
    assert rep.stats["recompute_resumes"] >= 1
    for r in rep.served:
        assert r.tokens == served["ref_tokens"][r.rid], r.rid


def test_chunked_prefill_token_identity(served):
    """Chunked prefill on an uncontended pool: long prompts go in as
    16-token chunks and a fork-point tail, short ones whole; tokens equal
    JAX's monolithic-prefill run."""
    rep = serve(_engine(served), served["params"], served["requests"](),
                overload=OverloadConfig(mode="reject", prefill_chunk=16))
    assert not rep.rejected
    assert rep.stats["chunked_admissions"] >= 2
    assert rep.stats["preemptions"] == 0
    for r in rep.served:
        assert r.tokens == served["ref_tokens"][r.rid], r.rid


def _drive(sched, reqs):
    """``serve()``'s loop with the clock pinned at 0 (no aging, no sheds:
    the decisions depend on pages and priorities alone)."""
    sched.clock = lambda: 0.0
    waiting = deque(sorted(reqs, key=lambda r: r.arrival))
    while waiting or sched.busy:
        progressed = sched.admission_round(waiting, 0.0, False)
        if not sched.busy:
            if not progressed:
                break
            continue
        sched.step_chunk(0.0)
    return sched


COUNTERS = ("preemptions", "swap_outs", "swap_resumes", "recompute_resumes",
            "chunked_admissions", "shed_ttft", "shed_deadline")


@pytest.mark.parametrize("kw", [dict(), dict(swap=False),
                                dict(prefill_chunk=16)],
                         ids=["swap", "recompute", "chunked"])
def test_scheduler_decisions_match_jax_with_the_clock_pinned(served, kw):
    """The same overload stream through JAX's and the port's
    ``OverloadScheduler`` (the clock pinned, as JAX's idle-pool test pins
    it): the same counters (``swap_bytes_peak`` aside: JAX pads each swap
    to a power of two of pages), the same preemptions and reject reason a
    request, the same allocator after the drain, and every request's
    tokens == JAX's uncontended run on both."""
    jsched = _drive(JaxOverloadScheduler(
        JaxSlotEngine(_run(served["jcfg"]), num_pages=SMALL_POOL, **ENGINE),
        served["jparams"], JaxOverloadConfig(**kw)),
        jreqs := served["requests"](JaxRequest))
    sched = _drive(OverloadScheduler(
        _engine(served, num_pages=SMALL_POOL), served["params"],
        OverloadConfig(**kw)), reqs := served["requests"]())
    got, want = sched.extra_stats(), jsched.extra_stats()
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert got["preemptions"] >= 1
    assert [(r.preemptions, r.reject_reason) for r in reqs] == \
        [(r.preemptions, r.reject_reason) for r in jreqs]
    assert sched.max_concurrency == jsched.max_concurrency
    assert sched.alloc.peak_pages == jsched.alloc.peak_pages
    assert list(sched.alloc.free) == list(jsched.alloc.free)
    _drained(sched.alloc)
    for r, j in zip(reqs, jreqs):
        assert r.tokens == j.tokens == served["ref_tokens"][r.rid], r.rid


def test_priority_order_and_aging_fields(served):
    """Closed loop, 2 slots: admission follows priority, high first (aging
    is negligible at t ~ 0), and the drain backfills in priority order."""
    reqs = [Request(rid=i, prompt=np.arange(4 + i, dtype=np.int32) + 1,
                    max_new_tokens=4, priority=p)
            for i, p in enumerate([0, 2, 1, 0, 2, 1])]
    rep = serve(_engine(served, capacity=2), served["params"], reqs,
                overload=OverloadConfig(mode="reject"))
    assert not rep.rejected
    order = [r.priority for r in sorted(rep.served,
                                        key=lambda r: r.t_admitted)]
    assert order == sorted(order, reverse=True), order


def test_every_shed_and_reject_path_sets_reason(served):
    """Oversized prompts and TTFT-SLO sheds come back with
    ``reject_reason`` set; nothing vanishes from the report."""
    reqs = [
        Request(rid=0, prompt=np.arange(60, dtype=np.int32) + 1,
                max_new_tokens=8),                        # > max_len
        Request(rid=1, prompt=np.arange(6, dtype=np.int32) + 1,
                max_new_tokens=4),                        # serves fine
        Request(rid=2, prompt=np.arange(6, dtype=np.int32) + 1,
                max_new_tokens=4, slo_ttft_ms=1e-3),      # sheds in queue
        Request(rid=3, prompt=np.arange(6, dtype=np.int32) + 1,
                max_new_tokens=4, slo_ttft_ms=1e-3),
    ]
    rep = serve(_engine(served, capacity=2, num_pages=9), served["params"],
                reqs, overload=OverloadConfig(mode="preempt"))
    by = {r.rid: r for r in rep.requests}
    assert by[0].reject_reason.startswith("too-long:")
    assert "max_len" in by[0].reject_reason
    assert by[1].reject_reason is None and len(by[1].tokens) == 4
    for rid in (2, 3):
        r = by[rid]
        assert (r.reject_reason is None) == bool(r.tokens)
        if r.reject_reason is not None:
            assert r.reject_reason.startswith("ttft-slo:")
            assert "TTFT SLO" in r.reject_reason
    assert len(rep.served) + len(rep.rejected) == len(reqs)


def test_deadline_shed_sets_reason(served):
    """With a decode estimate in hand, a queued request whose deadline
    cannot be met is shed with a ``deadline:`` reason."""
    sched = OverloadScheduler(_engine(served, capacity=2, num_pages=9),
                              served["params"], OverloadConfig())
    sched.clock = lambda: 0.0
    sched._tok_s = 0.5
    late = Request(rid=0, prompt=np.arange(6, dtype=np.int32) + 1,
                   max_new_tokens=4, deadline_ms=100.0)
    ok = Request(rid=1, prompt=np.arange(6, dtype=np.int32) + 1,
                 max_new_tokens=4, deadline_ms=1e6)
    waiting = deque([late, ok])
    assert sched.admission_round(waiting, 0.0, False)
    assert late.reject_reason.startswith("deadline:")
    assert ok.reject_reason is None and ok.tokens
    assert sched.extra_stats()["shed_deadline"] == 1


def test_idle_pool_unservable_sets_reason(served):
    """A request FULL against an IDLE batch can never be served: it is
    rejected with a reason instead of spinning (a constrained free list,
    as in JAX's test)."""
    sched = OverloadScheduler(_engine(served, capacity=2, num_pages=9),
                              served["params"], OverloadConfig())
    sched.clock = lambda: 0.0
    sched.alloc.free = deque(list(sched.alloc.free)[:2])  # 2 usable pages
    req = Request(rid=0, prompt=np.arange(30, dtype=np.int32) + 1,
                  max_new_tokens=4)                       # needs 4 pages
    waiting = deque([req])
    assert sched.admission_round(waiting, 0.0, False)
    assert not waiting
    assert "unservable" in req.reject_reason


def test_persistent_prefix_index_across_serve_calls(served):
    """The engine-owned index: the SECOND ``serve()`` fork-admits against
    pages the first left resident, and its tokens equal JAX's
    ``generate`` on the request alone."""
    pcfg = served["pcfg"]
    rng = np.random.default_rng(11)
    common = rng.integers(0, pcfg.vocab_size, (24,), dtype=np.int32)
    engine = _engine(served, capacity=2, num_pages=32, prefix_sharing=True,
                     persistent_prefix_index=True)

    def stream(n, seed):
        r = np.random.default_rng(seed)
        return [Request(rid=i, prompt=np.concatenate([
            common, r.integers(0, pcfg.vocab_size, (5,), dtype=np.int32)]),
            max_new_tokens=6) for i in range(n)]

    rep1 = serve(engine, served["params"], stream(3, seed=1))
    assert engine.resident is not None
    rep2 = serve(engine, served["params"], stream(1, seed=2),
                 overload=OverloadConfig())
    assert rep2.stats["shared_admissions"] == 1, rep2.stats
    assert rep2.stats["shared_tokens"] >= 24 - 8
    req = rep2.served[0]
    solo, _ = jax_generate(_run(served["jcfg"]), served["jparams"],
                           np.asarray(req.prompt)[None], req.max_new_tokens)
    assert req.tokens == [int(x) for x in np.asarray(solo)[0]]
    assert not rep1.rejected and not rep2.rejected


def test_sampled_swap_resume_continues_the_uncontended_stream(served):
    """Temperature 0.7, every request seeded: under preemption with host
    swap (and no recompute resume) each request's sampled tokens equal
    its uncontended run's, bitwise: the swap record carries the victim's
    generator state into the resumed slot."""
    seeds = [100 + i for i in range(10)]

    def reqs():
        out = served["requests"]()
        for r, s in zip(out, seeds):
            r.seed = s
        return out

    kw = dict(temperature=0.7)
    ref = serve(_engine(served, **kw), served["params"], reqs())
    rep = serve(_engine(served, num_pages=SMALL_POOL, **kw),
                served["params"], reqs(), overload=OverloadConfig())
    assert rep.stats["swap_resumes"] >= 1, rep.stats
    assert rep.stats["recompute_resumes"] == 0, rep.stats
    assert not rep.rejected
    assert [r.tokens for r in rep.requests] == \
        [r.tokens for r in ref.requests]
    # the stream differs from greedy's (the sampler ran)
    assert any(r.tokens != served["ref_tokens"][r.rid] for r in rep.requests)


def test_swap_resume_indexes_only_written_rows(served):
    """With prefix sharing, a swap resume registers prompt ++ generated
    WITHOUT the last token, whose KV row the next decode step writes: an
    11-token prompt with 5 tokens resumes at 16 = 2 full pages of 8, and
    only the first page (written whole) is indexed. (JAX registers both
    pages, the second with its last row unwritten: ROADMAP section 3.)"""
    sched = OverloadScheduler(
        _engine(served, num_pages=32, prefix_sharing=True), served["params"],
        OverloadConfig())
    sched.clock = lambda: 0.0
    req = Request(rid=0, prompt=np.arange(11, dtype=np.int32) + 1,
                  max_new_tokens=12)
    assert sched.admission_round(deque([req]), 0.0, False)
    sched.step_chunk(0.0)
    assert len(req.tokens) == 5
    (slot,) = sched.occupant
    sched._preempt(slot, 0.0)
    assert sched.n_swap_outs == 1 and len(sched.alloc.index) == 1
    assert sched.admission_round(deque(), 0.0, False)
    assert sched.n_swap_resumes == 1
    assert len(sched.alloc.index) == 1
    while sched.busy:
        sched.step_chunk(0.0)
    solo = serve(_engine(served), served["params"],
                 [Request(rid=0, prompt=req.prompt, max_new_tokens=12)])
    assert req.tokens == solo.requests[0].tokens


def _stream(vocab, n, lens, budgets, seed, make=Request):
    rng = np.random.default_rng(seed)
    protos = [dict(rid=i, prompt=rng.integers(0, vocab, (int(
        rng.integers(*lens)),), dtype=np.int32),
        max_new_tokens=int(rng.integers(*budgets))) for i in range(n)]
    return [make(**p) for p in protos]


@pytest.mark.parametrize("arch,swap,dropless", [
    ("deepseek-v2-lite-16b", True, False),
    ("jamba-v0.1-52b", False, True),
    ("jamba-v0.1-52b", False, False)],
    ids=["mla-swap", "jamba-recompute", "jamba-recompute-drops"])
def test_other_archs_resume_token_identity(arch, swap, dropless):
    """Reduced deepseek (MLA latent pages, MoE routing masking the dead
    slot) preempts by host swap; reduced jamba keeps Mamba state outside
    the pages, so its resumes are recomputes only. Both run on JAX's
    parameters (biases and scales perturbed), with the clock pinned, next
    to JAX's ``OverloadScheduler`` on the same stream: the same decisions
    and the same tokens, and the uncontended runs of both equal too.

    Where no prefill token is dropped (deepseek's swap resumes decode on,
    and jamba at a capacity factor of E / top_k), every overload token
    equals the uncontended one. At jamba's own capacity factor the MoE
    may drop prefill tokens, so a re-prefill of prompt ++ generated is
    another computation than the decode steps it replaces: a preempted
    request's tokens may part from the uncontended run, and they part on
    the port exactly where they part on JAX (ROADMAP section 3)."""
    jcfg = get_arch(arch).reduced(dtype="float32")
    pcfg = port_arch(arch).reduced(dtype="float32")
    if dropless:
        def cap(c):
            m = c.moe
            return dataclasses.replace(c, moe=dataclasses.replace(
                m, capacity_factor=m.num_experts / m.top_k))
        jcfg, pcfg = cap(jcfg), cap(pcfg)
    host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    host = _perturb(host, np.random.default_rng(5))
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    params = params_from_jax(host, device="cpu")
    # one engine a side for both runs (JAX's traces are built once); the
    # base scheduler reserves every request's worst case, so each request
    # runs uninterrupted on the same 7-page pool the overload run churns
    geo = dict(capacity=3, max_len=48, chunk=4, paged=True, page_size=8,
               num_pages=8)
    engine = SlotEngine(pcfg, device="cpu", **geo)
    jengine = JaxSlotEngine(_run(jcfg), **geo)
    make = lambda m=Request: _stream(  # noqa: E731
        pcfg.vocab_size, 6, (8, 11), (8, 16), 5, m)
    ref = serve(engine, params, make())
    jref = jax_serve(jengine, jparams, make(JaxRequest))
    assert [r.tokens for r in ref.requests] == \
        [list(r.tokens) for r in jref.requests]
    jsched = _drive(JaxOverloadScheduler(
        jengine, jparams, JaxOverloadConfig(swap=swap)),
        jreqs := make(JaxRequest))
    sched = _drive(OverloadScheduler(engine, params,
                                     OverloadConfig(swap=swap)),
                   reqs := make())
    got, want = sched.extra_stats(), jsched.extra_stats()
    assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert [(r.preemptions, r.reject_reason) for r in reqs] == \
        [(r.preemptions, r.reject_reason) for r in jreqs]
    assert not any(r.reject_reason for r in reqs)
    assert got["preemptions"] >= 1, got
    if swap:
        assert got["swap_resumes"] >= 1, got
    else:
        assert got["swap_outs"] == 0 == got["swap_resumes"]
        assert got["recompute_resumes"] >= 1, got
    _drained(sched.alloc)
    assert [r.tokens for r in reqs] == [list(r.tokens) for r in jreqs]
    parted = [r.rid for r, u in zip(reqs, ref.requests)
              if r.tokens != u.tokens]
    assert parted == [j.rid for j, u in zip(jreqs, jref.requests)
                      if list(j.tokens) != list(u.tokens)]
    if swap or dropless:
        assert parted == []
    assert all(reqs[i].preemptions for i in parted)


# ---------------------------------------------------------------------------
# Host-level units and the launcher
# ---------------------------------------------------------------------------


def test_preemption_policy_ordering():
    pol = PreemptionPolicy()
    mk = lambda prio: Request(rid=0, prompt=np.zeros(1, np.int32),  # noqa
                              max_new_tokens=1, priority=prio)
    assert pol.pick([(0, mk(2), 9, 1), (1, mk(0), 1, 9)]) == 1  # priority
    assert pol.pick([(0, mk(1), 2, 5), (1, mk(1), 7, 5)]) == 1  # pages
    assert pol.pick([(0, mk(1), 4, 9), (1, mk(1), 4, 2)]) == 1  # progress
    assert pol.pick([]) is None


def test_host_swap_pool_budget():
    pool = HostSwapPool(budget_bytes=100)
    rec = lambda n: _SwapRecord([1], None, None, n)  # noqa: E731
    assert pool.put(0, rec(60)) and pool.used == 60
    assert not pool.put(1, rec(50))          # over budget -> refused
    assert pool.put(1, rec(40)) and pool.peak == 100
    assert pool.pop(0).nbytes == 60 and pool.used == 40
    assert pool.pop(0) is None and len(pool) == 1


def test_report_percentile_helpers():
    reqs = []
    for i, prio in enumerate([0, 0, 2, 2]):
        r = Request(rid=i, prompt=np.zeros(4, np.int32), max_new_tokens=4,
                    arrival=0.0, priority=prio)
        r.t_admitted, r.t_first_token, r.t_finished = 0.1, 0.2 + i, 1.0 + i
        r.itl = [0.01 * (i + 1)] * 3
        reqs.append(r)
    rej = Request(rid=9, prompt=np.zeros(4, np.int32), max_new_tokens=4)
    rej.reject_reason = "shed: test"
    rep = ServeReport(requests=reqs + [rej], wall_s=1.0, decode_tokens=12,
                      stats={})
    assert rep.completion_rate == pytest.approx(4 / 5)
    assert rep.ttft_percentiles()["p50"] == pytest.approx(1.7)
    hi = rep.ttft_percentiles(min_priority=2)
    assert hi["mean"] == pytest.approx((2.2 + 3.2) / 2)
    assert rep.itl_percentiles()["max"] == pytest.approx(0.04)
    bd = rep.breakdown()
    assert bd["queue_s"] == pytest.approx(0.1)
    assert bd["prefill_s"] == pytest.approx(np.mean([0.1 + i for i in
                                                     range(4)]))


def test_poisson_priorities_and_slo_match_jax():
    """``poisson_requests`` with priority classes and a TTFT SLO draws
    JAX's prompts, budgets, arrivals and priorities."""
    kw = dict(num=12, rate_hz=3.0, prompt_lens=(4, 20),
              max_new_tokens=(2, 9), vocab_size=256, seed=4,
              priorities=(np.arange(3), np.full(3, 1 / 3)), slo_ttft_ms=50.0)
    for a, b in zip(poisson_requests(**kw), jax_poisson(**kw)):
        assert (a.prompt.tolist(), a.max_new_tokens, a.arrival, a.priority,
                a.slo_ttft_ms) == (b.prompt.tolist(), b.max_new_tokens,
                                   b.arrival, b.priority, b.slo_ttft_ms)
    assert len({r.priority for r in poisson_requests(**kw)}) > 1


def test_stop_token_retires_at_its_first_emission(served, monkeypatch):
    """A request with a ``stop_token`` keeps its tokens up to and with
    the first emission of it and retires; the other requests are
    untouched (the host-side early stop). Its slot is dead on the device
    when it retires (``done``), so it stops decoding until its next
    admission (JAX leaves it live: ROADMAP section 3)."""
    reqs = served["requests"]()
    ref = served["ref_tokens"]
    stop = ref[4][2]
    reqs[4].stop_token = stop
    done_at_retire = {}
    retire = SlotScheduler._retire

    def spy(self, slot, req, register=True):
        done_at_retire[req.rid] = bool(self.state.done[slot])
        retire(self, slot, req, register)

    monkeypatch.setattr(SlotScheduler, "_retire", spy)
    rep = serve(_engine(served), served["params"], reqs)
    k = ref[4].index(stop)
    assert reqs[4].tokens == ref[4][:k + 1]
    assert len(reqs[4].tokens) < reqs[4].max_new_tokens
    assert all(r.tokens == ref[r.rid] for r in reqs if r.rid != 4)
    assert rep.decode_tokens == sum(len(r.tokens) for r in reqs)
    assert done_at_retire == {r.rid: True for r in reqs}


def test_cli_overload_line_and_refusals(capsys):
    report = launch_serve.main([
        "--arch", ARCH, "--device", "cpu", "--paged", "--num-pages", "9",
        "--capacity", "3", "--preemption", "--prefill-chunk", "16",
        "--priority", "3"])
    out = capsys.readouterr().out
    assert "overload: mode=preempt" in out
    assert report.stats["preemptions"] >= 1
    assert report.stats["chunked_admissions"] >= 1
    assert not report.rejected
    assert len({r.priority for r in report.requests}) == 3
    for argv in (["--paged", "--prefill-chunk", "12", "--page-size", "8"],
                 ["--preemption"], ["--prefill-chunk", "16"],
                 ["--paged", "--priority", "-1"]):
        with pytest.raises(SystemExit) as e:
            launch_serve.main(["--arch", ARCH, "--device", "cpu"] + argv)
        assert e.value.code == 2, argv
