"""The port's prefix-sharing KV cache and chunked-prefill entry against the
JAX package's.

Host side: the port's ``PageAllocator(sharing=True)`` and ``PrefixIndex``
give JAX's tables, matches, refcounts, ``available`` and ``reclaimable``
for one random call sequence, and JAX's own unit scenarios
(``tests/test_prefix_sharing.py``) run on both allocators with the same
observations. Model side: ``forward_prefill_shared`` from the same paged
pools gives JAX's logits and pages (fp32, 1e-5: summation order only), on
yi-9b and on chatglm3-6b (QKV biases and half rotary, the biases and norm
scales drawn away from JAX's 0 / 1 init). Serving: the sharing engine's
greedy tokens equal the port's unshared paged engine's, ``generate``'s and
JAX's sharing engine's on a backfill stream, a copy-on-write stream and an
eviction-pressure stream, with the same sharing statistics. Inputs and
parameters from seeds with numpy; JAX runs its ref backend on the CPU.
"""
import dataclasses
import importlib.util
import itertools
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.paging import PageAllocator as JaxPageAllocator
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import xaif
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig, generate
from repro_torch.serve.paging import PageAllocator, PoolExhausted
from repro_torch.serve.scheduler import Request, serve

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
POLICY = AccelConfig()            # the JAX package's all-ref policy
# the JAX allocator asserts where the port raises
EXHAUSTED = {PageAllocator: PoolExhausted, JaxPageAllocator: AssertionError}


# ---------------------------------------------------------------------------
# Allocator and index: one random call sequence on both
# ---------------------------------------------------------------------------


def _state(al):
    return (al.table.tolist(), list(al.free), dict(al.refcnt),
            {s: list(p) for s, p in al.owned.items()}, dict(al.reserved),
            al.available, al.reclaimable, al.peak_pages, al.pages_in_use,
            sorted(al.index.pages), al.index.reclaimable(al.refcnt))


def test_allocator_and_index_match_jax_on_a_call_sequence():
    """admit, admit_shared (COW boundaries included), register at admission
    and at retire, ensure, release and explicit evictions, under a pool
    small enough that pops evict: the same tables, free lists, refcounts,
    matches (pages, boundary, rem), ``available`` and ``reclaimable`` after
    every call."""
    rng = np.random.default_rng(0)
    kw = dict(num_pages=14, capacity=4, max_pages=8, page_size=4,
              sharing=True)
    ours, theirs = PageAllocator(**kw), JaxPageAllocator(**kw)
    live, chains, ops = {}, [], {"shared": 0, "cow": 0, "evict": 0}

    def both(name, *a):
        got, want = getattr(ours, name)(*a), getattr(theirs, name)(*a)
        if isinstance(got, tuple):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        return got

    for step in range(400):
        op = int(rng.choice(4, p=[0.45, 0.2, 0.3, 0.05]))
        if op == 0 and len(live) < 4:               # admit, shared if it can
            slot = next(s for s in range(4) if s not in live)
            if chains and rng.integers(0, 3):       # fork an earlier chain
                base = chains[int(rng.integers(0, len(chains)))]
                cut = int(rng.integers(1, len(base) + 1))
                chain = np.concatenate([base[:cut], rng.integers(
                    0, 6, int(rng.integers(1, 7)))])
            else:
                chain = rng.integers(0, 6, int(rng.integers(5, 18)))
            t, new = len(chain), int(rng.integers(1, 6))
            if t + new > 32:
                continue
            pages, boundary, rem = both("match", chain)
            start = len(pages) * 4 + (rem if boundary is not None else 0)
            sb = -(-(t - start) // 4) * 4
            if pages and both("can_admit_shared", pages, boundary, rem, sb,
                              t, new):
                both("admit_shared", slot, pages, boundary, rem, sb, t, new)
                ops["shared"] += 1
                ops["cow"] += boundary is not None and rem > 0
            elif both("can_admit", -(-t // 4) * 4, t, new):
                both("admit", slot, -(-t // 4) * 4, t, new)
            else:
                continue
            both("register", chain, slot)
            live[slot] = (chain, new)
            chains.append(chain)
        elif op == 1 and live:                      # grow to the worst case
            slot = int(rng.choice(sorted(live)))
            chain, new = live[slot]
            both("ensure", slot, len(chain) + new - 1)
        elif op == 2 and live:                      # retire: index, release
            slot = int(rng.choice(sorted(live)))
            chain, new = live.pop(slot)
            ext = np.concatenate([chain, rng.integers(0, 6, new - 1)])
            both("register", ext, slot)
            both("release", slot)
        elif op == 3:
            got = ours.index.evict_one(ours)
            assert got == theirs.index.evict_one(theirs)
        assert _state(ours) == _state(theirs), step
    ops["evict"] = ours.index.evictions
    assert ops["shared"] > 20 and ops["cow"] > 5 and ops["evict"] > 5, ops


# ---------------------------------------------------------------------------
# JAX's unit scenarios, on both allocators
# ---------------------------------------------------------------------------


def _alloc(cls, num_pages=16, capacity=4, max_pages=8, ps=4):
    return cls(num_pages, capacity, max_pages, ps, sharing=True)


def _check_sharing_invariants(al):
    for pid, rc in al.refcnt.items():
        mapped = sum(p == pid for pages in al.owned.values() for p in pages)
        indexed = 1 if pid in al.index.pages else 0
        assert rc == mapped + indexed and rc >= 1 and pid != 0, (pid, rc)
    free = set(al.free)
    assert 0 not in free and free.isdisjoint(al.refcnt)
    for slot, pages in al.owned.items():
        n = len(pages)
        assert list(al.table[slot, :n]) == pages
        assert (al.table[slot, n:] == -1).all()


def _match_walk(cls):
    al = _alloc(cls)
    ids = al.admit(0, bucket_len=12, true_len=10, max_new=2)
    al.register(np.arange(10), 0)
    assert len(al.index) == 2                    # only FULL pages indexed
    out = [al.index.match(np.arange(8), cap=8)]
    assert out[-1] == ([int(ids[0]), int(ids[1])], None, 0)
    out.append(al.index.match(np.array([0, 1, 2, 3, 4, 5, 99, 98]), cap=8))
    assert out[-1] == ([int(ids[0])], int(ids[1]), 2)
    out.append(al.match(np.arange(8)))           # capped at len - 1
    assert out[-1] == ([int(ids[0])], int(ids[1]), 3)
    return out


def _dedup(cls):
    al = _alloc(cls)
    al.admit(0, bucket_len=8, true_len=8, max_new=2)
    al.admit(1, bucket_len=8, true_len=8, max_new=2)
    added = [al.register(np.arange(8), 0), al.register(np.arange(8), 1)]
    assert added == [2, 0]
    pages, _, _ = al.index.match(np.arange(8), cap=8)
    assert pages == al.owned[0][:2]              # first copy won
    return added, pages


def _lru_unmapped_leaves(cls):
    al = _alloc(cls, num_pages=6, ps=4)
    al.admit(0, bucket_len=4, true_len=4, max_new=1)
    al.register(np.arange(4), 0)                 # mapped AND indexed: rc 2
    al.admit(1, bucket_len=4, true_len=4, max_new=1)
    al.register(np.arange(100, 104), 1)
    reclaim = al.owned[1][0]
    al.release(1)                                # index-only now: rc 1
    assert al.reclaimable == 1 and al.refcnt[reclaim] == 1
    got = [al._pop_free() for _ in range(4)]
    assert got[-1] == reclaim and al.owned[0][0] in al.refcnt
    assert len(al.index) == 1
    with pytest.raises(EXHAUSTED[cls]):
        al._pop_free()                           # nothing reclaimable left
    return got


def _interior_nodes(cls):
    al = _alloc(cls, num_pages=8, ps=2)
    ids = al.admit(0, bucket_len=6, true_len=6, max_new=1)
    al.register(np.arange(6), 0)
    al.release(0)
    first = al.index.evict_one(al)
    assert first == int(ids[2]) and len(al.index) == 2
    pages, _, _ = al.index.match(np.arange(4), cap=4)
    assert pages == [int(ids[0]), int(ids[1])]
    return first, pages


def _release_orders(cls):
    out = []
    for order in itertools.permutations(["a", "b", "idx"]):
        al = _alloc(cls)
        al.admit(0, bucket_len=4, true_len=4, max_new=1)
        al.register(np.arange(4), 0)
        pid = al.owned[0][0]
        al.admit_shared(1, [pid], None, rem=0, suffix_bucket=4, true_len=8,
                        max_new=1)
        assert al.refcnt[pid] == 3
        for holder in order:
            assert pid not in al.free
            if holder == "a":
                al.release(0)
            elif holder == "b":
                al.release(1)
            else:
                node = al.index.pages[pid]
                del node.parent.children[node.edge]
                del al.index.pages[pid]
                al._release_page(pid)
            _check_sharing_invariants(al)
        assert pid in al.free and pid not in al.refcnt, order
        out.append(list(al.free))
    return out


def _cow_no_alias(cls):
    al = _alloc(cls, num_pages=32, ps=4)
    al.admit(0, bucket_len=12, true_len=12, max_new=2)
    al.register(np.arange(12), 0)
    prefix, boundary, rem = al.match(np.arange(11))
    assert len(prefix) == 2 and boundary is not None and rem == 2
    pre, region = al.admit_shared(1, prefix, boundary, rem=rem,
                                  suffix_bucket=4, true_len=11, max_new=2)
    live = set(al.owned[0]) | {int(p) for p in pre}
    assert live.isdisjoint(int(p) for p in region)
    assert int(boundary) not in region
    _check_sharing_invariants(al)
    return pre.tolist(), region.tolist()


def _fill_share_retire_refill(cls):
    al = _alloc(cls, num_pages=10, ps=4)
    fresh_free = sorted(al.free)
    al.admit(0, bucket_len=8, true_len=8, max_new=2)
    al.register(np.arange(8), 0)
    prefix, _, _ = al.match(np.arange(8, dtype=np.int64))
    al.admit_shared(1, prefix, None, rem=0, suffix_bucket=4, true_len=8,
                    max_new=2)
    _check_sharing_invariants(al)
    al.release(0)
    al.release(1)
    evicted = []
    while (pid := al.index.evict_one(al)) is not None:
        evicted.append(pid)
        _check_sharing_invariants(al)
    assert sorted(al.free) == fresh_free and not al.refcnt
    assert len(al.index) == 0 and al.available == len(fresh_free)
    fresh = _alloc(cls, num_pages=10, ps=4)
    ids = al.admit(2, bucket_len=8, true_len=8, max_new=2)
    fresh_ids = fresh.admit(2, bucket_len=8, true_len=8, max_new=2)
    assert len(ids) == len(fresh_ids) == 2
    assert al.available == fresh.available
    return evicted, ids.tolist()


def _pops_under_churn(cls):
    rng = np.random.default_rng(0)
    al = _alloc(cls, num_pages=14, capacity=4, max_pages=8, ps=4)
    live, chains, next_chain = {}, {}, 0
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0 and len(live) < 4:
            slot = next(s for s in range(4) if s not in live)
            if rng.integers(0, 2) and next_chain > 0:
                chain = chains[int(rng.integers(0, next_chain)) % 4]
            else:
                chain = rng.integers(0, 50, (int(rng.integers(5, 17)),))
            chains[next_chain % 4], next_chain = chain, next_chain + 1
            t, max_new = len(chain), int(rng.integers(1, 5))
            prefix, boundary, rem = al.match(chain)
            start = len(prefix) * 4 + rem
            if prefix:
                sb = -(-(t - start) // 4) * 4
                if al.can_admit_shared(prefix, boundary, rem, sb, t,
                                       max_new):
                    al.admit_shared(slot, prefix, boundary, rem, sb, t,
                                    max_new)
                    al.register(chain, slot)
                    live[slot] = (t, max_new)
            elif al.can_admit(-(-t // 4) * 4, t, max_new):
                al.admit(slot, -(-t // 4) * 4, t, max_new)
                al.register(chain, slot)
                live[slot] = (t, max_new)
        elif op == 1 and live:
            slot = int(rng.choice(sorted(live)))
            t, max_new = live[slot]
            al.ensure(slot, t + max_new - 1)
        elif op == 2 and live:
            slot = int(rng.choice(sorted(live)))
            al.release(slot)
            del live[slot]
        _check_sharing_invariants(al)
    assert al.peak_pages <= al.num_pages - 1
    return al.table.tolist(), list(al.free), al.peak_pages


def _pinned(cls):
    al = _alloc(cls, num_pages=4, ps=4)
    al.admit(0, bucket_len=8, true_len=8, max_new=0)
    al.register(np.arange(8), 0)
    al.release(0)
    assert len(al.free) == 1 and al.reclaimable == 2
    prompt = np.concatenate([np.arange(8), np.arange(50, 58)])
    prefix, boundary, rem = al.match(prompt)
    assert len(prefix) == 2 and boundary is None and rem == 0
    assert not al.can_admit_shared(prefix, boundary, rem=0, suffix_bucket=8,
                                   true_len=16, max_new=0)
    assert al.can_admit_shared(prefix, boundary, rem=0, suffix_bucket=4,
                               true_len=12, max_new=0)
    pre, region = al.admit_shared(1, prefix, boundary, rem=0,
                                  suffix_bucket=4, true_len=12, max_new=0)
    _check_sharing_invariants(al)
    return pre.tolist(), region.tolist()


def _transitive_reclaimable(cls):
    al = _alloc(cls, num_pages=8, ps=4)
    al.admit(0, bucket_len=8, true_len=8, max_new=0)
    al.register(np.arange(8), 0)
    al.release(0)
    al.admit(1, bucket_len=12, true_len=12, max_new=0)
    al.register(np.arange(12), 1)
    assert al.reclaimable == 0 and al.index.evict_one(al) is None
    free_now = len(al.free)
    assert not al.can_admit(bucket_len=4 * (free_now + 1),
                            true_len=4 * (free_now + 1), max_new=0)
    al.release(1)
    assert al.reclaimable == 3
    return free_now


def _fallback_reservation(cls):
    """The scheduler's fall-through case at the allocator: a fork whose
    shared reservation (2 pinned index pages + 3 region pages) exceeds the
    pool while the standard admission (3 pages) fits."""
    al = _alloc(cls, num_pages=5, capacity=1, max_pages=4, ps=4)
    stem = np.arange(8)
    al.admit(0, bucket_len=8, true_len=8, max_new=2)
    al.register(stem, 0)
    al.release(0)
    fork = np.concatenate([stem[:5], [90, 91, 92]])
    prefix, boundary, rem = al.match(fork)
    assert len(prefix) == 1 and rem == 1
    shared = al.can_admit_shared(prefix, boundary, rem, 8, 8, 2)
    standard = al.can_admit(8, 8, 2)
    assert not shared and standard
    return prefix, boundary, rem


def _sharing_off(cls):
    al = cls(9, 4, 4, 8, sharing=False)
    assert al.index is None and al.available == 8
    al.admit(0, bucket_len=16, true_len=12, max_new=12)
    assert all(rc == 1 for rc in al.refcnt.values())
    assert al.available == 8 - 3
    al.release(0)
    assert al.available == 8 and not al.refcnt
    return list(al.free)


SCENARIOS = {f.__name__[1:]: f for f in (
    _match_walk, _dedup, _lru_unmapped_leaves, _interior_nodes,
    _release_orders, _cow_no_alias, _fill_share_retire_refill,
    _pops_under_churn, _pinned, _transitive_reclaimable,
    _fallback_reservation, _sharing_off)}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_allocator_scenarios_match_jax(case):
    """JAX's allocator / index unit tests, each run on the port's allocator
    and on JAX's: both pass JAX's assertions and observe the same ids."""
    got = SCENARIOS[case](PageAllocator)
    want = SCENARIOS[case](JaxPageAllocator)
    assert repr(got) == repr(want)


# ---------------------------------------------------------------------------
# The model's fork-point prefill
# ---------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def worlds():
    """name -> (JAX config, port config, JAX params, port params)."""
    built = {}

    def get(name):
        if name not in built:
            jcfg = get_arch(name).reduced(dtype="float32")
            pcfg = port_arch(name).reduced(dtype="float32")
            host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
            host = _perturb(host, np.random.default_rng(3))
            jp = jax.tree_util.tree_map(jnp.asarray, host)
            built[name] = (jcfg, pcfg, jp, params_from_jax(host,
                                                           device="cpu"))
        return built[name]
    return get


def _run(jcfg):
    return RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                     accel=POLICY)


# a fork at position 29: 3 shared full pages of 8, 5 COW rows in region[0],
# a 6-token suffix in a bucket of 8 (region pages 9 and 4)
PS, N_POOL, MAX_LEN = 8, 12, 48
PREFIX, REGION, START, TSUF = [7, 3, 10], [9, 4], 29, 6


def _pools(pcfg, rng):
    shape = (pcfg.num_layers, N_POOL, pcfg.num_kv_heads, PS, pcfg.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _port_cache(pcfg, kp, vp):
    cache = lm.init_paged_cache(pcfg, 2, MAX_LEN, PS, N_POOL, device="cpu")
    cache.k_pages.copy_(torch.from_numpy(kp))
    cache.v_pages.copy_(torch.from_numpy(vp))
    return cache


def _ctx(prefix, region, start=START, true_len=START + TSUF):
    return attn.SharedPrefillCtx(torch.tensor(prefix), torch.tensor(region),
                                 start, len(PREFIX) * PS, true_len)


def _row():
    row = np.full(MAX_LEN // PS, -1, np.int32)
    row[:5] = PREFIX + REGION
    return row


@pytest.mark.parametrize("name", ["yi-9b", "chatglm3-6b"])
def test_forward_prefill_shared_matches_jax(worlds, name):
    """From the same pools, the port's fork-point prefill gives JAX's
    first-token logits and pages (1e-5), writes only its region pages,
    sets the slot's table row and length, and gives the same result with
    JAX's padded page lists (a -1 prefix entry, the pow2 cap) as without."""
    jcfg, pcfg, jp, pp = worlds(name)
    rng = np.random.default_rng(5)
    kp, vp = _pools(pcfg, rng)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :TSUF] = rng.integers(0, pcfg.vocab_size, TSUF)
    jcache = jlm.init_paged_cache(jcfg, 2, MAX_LEN, PS, N_POOL)
    jcache = jcache._replace(slots=(jattn.PagedKVCache(jnp.asarray(kp),
                                                       jnp.asarray(vp)),))
    jctx = jattn.SharedPrefillCtx(
        jnp.asarray(PREFIX + [-1], jnp.int32), jnp.asarray(REGION, jnp.int32),
        jnp.asarray(START, jnp.int32), jnp.asarray(len(PREFIX) * PS,
                                                   jnp.int32),
        jnp.asarray(START + TSUF, jnp.int32))
    jlog, jnew = jlm.forward_prefill_shared(jp, jnp.asarray(toks), jcfg,
                                            POLICY, jcache, 1, jctx,
                                            jnp.asarray(_row()))
    outs = {}
    for label, ctx in (("exact", _ctx(PREFIX, REGION)),
                       ("padded", _ctx(PREFIX + [-1], REGION + [0]))):
        cache = _port_cache(pcfg, kp, vp)
        logits, cache = lm.forward_prefill_shared(
            pp, torch.from_numpy(toks), pcfg, "auto", cache, 1, ctx, _row())
        outs[label] = (logits, cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=TOL, atol=TOL)
        for got, want in ((cache.k_pages, jnew.slots[0].k_pages),
                          (cache.v_pages, jnew.slots[0].v_pages)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
        assert cache.page_table[1].tolist() == _row().tolist()
        assert int(cache.pos[1]) == START + TSUF
        kept = [p for p in range(1, N_POOL) if p not in REGION]
        assert torch.equal(cache.k_pages[:, kept],
                           torch.from_numpy(kp)[:, kept])
        # the COW rows before the fork are kept as copied
        assert torch.equal(cache.k_pages[:, REGION[0], :, :START % PS],
                           torch.from_numpy(kp)[:, REGION[0], :, :START % PS])
    # the pad only lengthens the masked reductions: summation order
    (a, ca), (b, cb) = outs["exact"], outs["padded"]
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    torch.testing.assert_close(ca.k_pages[:, REGION], cb.k_pages[:, REGION],
                               rtol=TOL, atol=TOL)


def test_shared_prefill_keeps_nan_in_scratch_page_out(worlds):
    """NaN in the scratch page 0 of every pool, which the padded page lists
    gather (a -1 prefix entry, a scratch region entry): the masked V rows
    are zeroed, so the logits are finite and those of the clean run.
    (JAX's ref would give NaN here: 0 * NaN; not held against it.)"""
    _, pcfg, _, pp = worlds("yi-9b")
    rng = np.random.default_rng(6)
    kp, vp = _pools(pcfg, rng)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (1, 8)))
    clean = _port_cache(pcfg, kp, vp)
    want, _ = lm.forward_prefill_shared(pp, toks, pcfg, "auto", clean, 1,
                                        _ctx(PREFIX, REGION), _row())
    kp[:, 0], vp[:, 0] = np.nan, np.nan
    dirty = _port_cache(pcfg, kp, vp)
    got, _ = lm.forward_prefill_shared(pp, toks, pcfg, "auto", dirty, 1,
                                       _ctx(PREFIX + [-1], REGION + [0]),
                                       _row())
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_prefix",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("head", [True, False], ids=["head", "chunk"])
@pytest.mark.parametrize("name", ["yi-9b", "chatglm3-6b", "chameleon-34b"])
def test_shared_prefill_launches_are_chip_smokes_count(name, head,
                                                       monkeypatch):
    """``chip_smoke.shared_prefill_launches`` (the exact launches phase 5b
    asserts a fork-point admission and a chunk make on the card) against
    the ops ``forward_prefill_shared`` dispatches, counted here: one
    kernel launch each on the card. chameleon has a QK-norm."""
    cfg = port_arch(name).reduced(dtype="float32")
    params = lm.init_lm(cfg, device="cpu")
    seen, real = Counter(), xaif.call

    def counting(op, policy, *args, **kw):
        seen[op] += 1
        return real(op, policy, *args, **kw)

    monkeypatch.setattr(xaif, "call", counting)
    cache = lm.init_paged_cache(cfg, 1, 32, 8, 6, device="cpu")
    ctx = attn.SharedPrefillCtx(torch.tensor([1]), torch.tensor([2]), 8, 8,
                                12)
    lm.forward_prefill_shared(params, torch.zeros(1, 4, dtype=torch.int32),
                              cfg, "auto", cache, 0, ctx,
                              np.array([1, 2, -1, -1]), head=head)
    assert dict(seen) == _chip_smoke().shared_prefill_launches(cfg, head)


def test_copy_pages_copies_every_layer_in_place(worlds):
    _, pcfg, _, _ = worlds("yi-9b")
    kp, vp = _pools(pcfg, np.random.default_rng(7))
    cache = lm.copy_pages(_port_cache(pcfg, kp, vp), 3, 9)
    want_k = kp.copy()
    want_k[:, 9] = kp[:, 3]
    assert np.array_equal(cache.k_pages.numpy(), want_k)
    assert np.array_equal(cache.v_pages[:, 9].numpy(), vp[:, 3])


# ---------------------------------------------------------------------------
# Serving with sharing
# ---------------------------------------------------------------------------


def _shared_prefix_requests(vocab, n, prefix_len, seed, max_suffix,
                            max_new, make=Request):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, (prefix_len,), dtype=np.int32)
    out = []
    for i in range(n):
        suffix = rng.integers(0, vocab, (int(rng.integers(1, max_suffix)),),
                              dtype=np.int32)
        out.append(make(rid=i, prompt=np.concatenate([common, suffix]),
                        max_new_tokens=int(rng.integers(2, max_new + 1))))
    return out


def _cow_requests(vocab, make=Request):
    stem = np.random.default_rng(3).integers(0, vocab, (13,), dtype=np.int32)
    return [make(rid=0, prompt=np.concatenate([stem, [11, 12, 13]]),
                 max_new_tokens=4),
            make(rid=1, prompt=np.concatenate([stem, [21, 22, 23]]),
                 max_new_tokens=4)]


# stream -> (engine kwargs, request maker): JAX's tests' streams and
# pools, the eviction stream's pool cut from 11 usable pages (where nothing
# is evicted) to 6, just above the live working set
STREAMS = {
    "backfill": (dict(capacity=3, max_len=64, chunk=4, page_size=8,
                      num_pages=32),
                 lambda v, make: _shared_prefix_requests(v, 9, 20, 0, 12, 8,
                                                         make)),
    "cow": (dict(capacity=2, max_len=32, chunk=4, page_size=8, num_pages=16),
            _cow_requests),
    "eviction": (dict(capacity=2, max_len=32, chunk=4, page_size=8,
                      num_pages=7),
                 lambda v, make: _shared_prefix_requests(v, 8, 10, 5, 8, 6,
                                                         make)),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_sharing_serve_matches_unshared_generate_and_jax(worlds, stream):
    """chatglm3-6b (QKV biases, half rotary): the sharing engine's tokens
    equal the unshared paged engine's, ``generate``'s and JAX's sharing
    engine's per request, with JAX's sharing statistics; no more prefill
    tokens than without sharing (fewer on the backfill stream: the short
    prompts of the other two fill one bucket whether shared or not)."""
    jcfg, pcfg, jp, pp = worlds("chatglm3-6b")
    kw, make = STREAMS[stream]
    reports, reqs = {}, {}
    for sharing in (False, True):
        reqs[sharing] = make(pcfg.vocab_size, Request)
        engine = SlotEngine(pcfg, paged=True, prefix_sharing=sharing,
                            device="cpu", **kw)
        reports[sharing] = serve(engine, pp, reqs[sharing])
    jreqs = make(pcfg.vocab_size, JaxRequest)
    jrep = jax_serve(JaxSlotEngine(_run(jcfg), paged=True,
                                   prefix_sharing=True, **kw), jp, jreqs)
    on, off = reports[True].stats, reports[False].stats
    for name in ("shared_admissions", "shared_tokens", "index_pages",
                 "peak_pages", "prefill_tokens"):
        assert on[name] == jrep.stats[name], name
    assert on["prefill_tokens"] <= off["prefill_tokens"]
    assert len(reports[True].served) == len(jreqs)
    for r_off, r_on, j in zip(reqs[False], reqs[True], jreqs):
        solo, _ = generate(pcfg, pp, r_on.prompt[None], r_on.max_new_tokens,
                           max_len=kw["max_len"], device="cpu")
        assert r_on.tokens == r_off.tokens == solo[0].tolist() == j.tokens, \
            r_on.rid
    if stream == "backfill":
        assert on["shared_admissions"] >= 3
        assert on["prefill_tokens"] < off["prefill_tokens"]
    elif stream == "cow":
        assert on["shared_admissions"] == 1
    else:
        assert on["index_evictions"] > 0


def test_sharing_falls_back_to_the_standard_path(worlds):
    """JAX's fall-through case served: a fork whose shared reservation does
    not fit a 4-page pool is admitted the standard way, nobody starves,
    tokens == ``generate``."""
    _, pcfg, _, pp = worlds("chatglm3-6b")
    rng = np.random.default_rng(11)
    stem = rng.integers(0, pcfg.vocab_size, (8,), dtype=np.int32)
    fork = np.concatenate([stem[:5], rng.integers(0, pcfg.vocab_size, (3,),
                                                  dtype=np.int32)])
    engine = SlotEngine(pcfg, capacity=1, max_len=16, chunk=4, paged=True,
                        page_size=4, num_pages=5, prompt_bucket=8,
                        prefix_sharing=True, device="cpu")
    reqs = [Request(rid=0, prompt=stem, max_new_tokens=2),
            Request(rid=1, prompt=fork, max_new_tokens=2)]
    report = serve(engine, pp, reqs)
    assert len(report.served) == 2
    assert report.stats["shared_admissions"] == 0
    for r in reqs:
        solo, _ = generate(pcfg, pp, r.prompt[None], 2, max_len=16,
                           device="cpu")
        assert r.tokens == solo[0].tolist()


def test_spec_engine_with_sharing_equals_spec_without(worlds):
    """Greedy speculative decoding (a 1-layer draft of its own weights) on
    the sharing engine: tokens equal the same spec engine's without
    sharing, while it shares."""
    _, pcfg, _, pp = worlds("yi-9b")
    cfg = dataclasses.replace(pcfg, early_exit=None)
    draft = dataclasses.replace(cfg, name="yi-draft-1l", num_layers=1)
    toks, stats = {}, {}
    for sharing in (False, True):
        reqs = _shared_prefix_requests(cfg.vocab_size, 6, 20, 2, 12, 8)
        engine = SlotEngine(cfg, capacity=3, max_len=64, chunk=2, paged=True,
                            page_size=8, prefix_sharing=sharing,
                            spec=SpecConfig(draft_arch=draft, k=2),
                            device="cpu")
        stats[sharing] = serve(engine, pp, reqs).stats
        toks[sharing] = [r.tokens for r in reqs]
    assert toks[True] == toks[False]
    assert stats[True]["shared_admissions"] >= 3


def test_persistent_index_hits_on_the_next_serve(worlds):
    """``persistent_prefix_index``: a second ``serve()`` resumes the first
    one's pool, so its very first request already shares; tokens equal a
    fresh unshared engine's."""
    _, pcfg, _, pp = worlds("yi-9b")
    engine = SlotEngine(pcfg, capacity=2, max_len=64, chunk=4, paged=True,
                        page_size=8, prefix_sharing=True,
                        persistent_prefix_index=True, device="cpu")
    first = _shared_prefix_requests(pcfg.vocab_size, 3, 24, 4, 10, 4)
    serve(engine, pp, first)
    assert engine.resident is not None
    second = _shared_prefix_requests(pcfg.vocab_size, 3, 24, 4, 10, 5)
    report = serve(engine, pp, second)
    assert report.stats["shared_admissions"] == 3     # all three hit
    fresh = _shared_prefix_requests(pcfg.vocab_size, 3, 24, 4, 10, 5)
    serve(SlotEngine(pcfg, capacity=2, max_len=64, chunk=4, paged=True,
                     page_size=8, device="cpu"), pp, fresh)
    assert [r.tokens for r in second] == [r.tokens for r in fresh]


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def test_chunked_prefill_equals_full_prefill(worlds):
    """A 40-token prompt as two 16-token ``prefill_chunk``s and a shared
    suffix of 8: the first-token logits and every layer's K/V are the full
    prefill's (1e-5), and the engine's decoded tokens are ``generate``'s."""
    _, pcfg, _, pp = worlds("yi-9b")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, pcfg.vocab_size, 40).astype(np.int32)
    engine = SlotEngine(pcfg, capacity=2, max_len=64, chunk=4, paged=True,
                        page_size=8, device="cpu")
    cache, st = engine.init_state()
    alloc = PageAllocator(engine.num_pages, 2, engine.max_pages, 8)
    ids = alloc.admit(0, bucket_len=48, true_len=40, max_new=6)
    row = alloc.table[0]
    for c in range(2):
        cache = engine.prefill_chunk(pp, cache, prompt[16 * c:16 * (c + 1)],
                                     16 * c, 0, ids[:2 * c],
                                     ids[2 * c:2 * c + 2], row)
    assert int(cache.pos[0]) == 32 and engine.prefill_tokens == 32
    # the last part through the model entry, for its logits
    probe = lm.init_paged_cache(pcfg, 2, 64, 8, engine.num_pages,
                                device="cpu")
    for dst, src in zip(probe.pools, cache.pools):
        dst.copy_(src)
    suffix = torch.zeros(1, 16, dtype=torch.int32)
    suffix[0, :8] = torch.from_numpy(prompt[32:])
    got, probe = lm.forward_prefill_shared(
        pp, suffix, pcfg, "auto", probe, 0,
        attn.SharedPrefillCtx(torch.from_numpy(ids[:4]).long(),
                              torch.from_numpy(ids[4:6]).long(), 32, 32, 40),
        row)
    full = lm.init_cache(pcfg, 1, 40, device="cpu")
    want, full = lm.forward_prefill(pp, torch.from_numpy(prompt)[None], pcfg,
                                    "auto", full)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    paged_k = probe.k_pages[:, torch.from_numpy(ids[:5]).long()]
    paged_k = paged_k.permute(0, 2, 1, 3, 4).reshape(
        pcfg.num_layers, pcfg.num_kv_heads, 40, pcfg.head_dim)
    torch.testing.assert_close(paged_k, full.k[:, 0], rtol=TOL, atol=TOL)
    # the engine's admission of the rest, then decode
    cache, st, tok0 = engine.prefill_into_shared(pp, cache, st, prompt, 32, 0,
                                                 6, ids[:4], ids[4:6], row)
    assert engine.prefill_tokens == 48 and int(cache.pos[0]) == 40
    tokens = [int(tok0)]
    while len(tokens) < 6:
        alloc.ensure(0, 40 + len(tokens) - 1 + engine.chunk - 1)
        cache = engine.set_page_table(cache, alloc.table)
        seen = int(st.generated[0])
        cache, st, toks = engine.decode(pp, cache, st)
        tokens += toks[0, :int(st.generated[0]) - seen].tolist()
    solo, _ = generate(pcfg, pp, prompt[None], 6, max_len=64, device="cpu")
    assert tokens == solo[0].tolist()


def test_prefill_chunk_refuses_unaligned_chunks(worlds):
    _, pcfg, _, pp = worlds("yi-9b")
    engine = SlotEngine(pcfg, capacity=1, max_len=32, paged=True,
                        page_size=8, device="cpu")
    cache, _ = engine.init_state()
    row = np.array([1, 2, -1, -1], np.int32)
    for toks, start, pre, reg in ((np.arange(12), 0, [], [1, 2]),
                                  (np.arange(8), 8, [], [2]),
                                  (np.arange(8), 0, [], [1, 2])):
        with pytest.raises(ValueError):
            engine.prefill_chunk(pp, cache, toks, start, 0, pre, reg, row)


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "xlstm-350m"])
def test_sharing_refuses_mla_moe_and_recurrent_archs(name):
    """MLA, MoE and recurrent archs: the engine refuses sharing at
    construction, as JAX asserts, and the model entry refuses the call."""
    cfg = port_arch(name).reduced()
    assert not lm.shared_prefill_ok(cfg)
    with pytest.raises(ValueError, match="fork-point prefill"):
        SlotEngine(cfg, capacity=1, max_len=32, paged=True,
                   prefix_sharing=True, device="cpu")
    with pytest.raises(ValueError, match="fork-point prefill"):
        lm.forward_prefill_shared({}, torch.zeros(1, 1, dtype=torch.int32),
                                  cfg, "auto", None, 0, None, None)
    engine = SlotEngine(cfg, capacity=1, max_len=32, paged=True,
                        device="cpu")
    assert not engine.shared_prefill_ok
    with pytest.raises(ValueError):
        engine.prefill_chunk({}, None, np.arange(16), 0, 0, [], [1], None)


def test_sharing_needs_the_paged_engine():
    cfg = port_arch("yi-9b").reduced()
    with pytest.raises(ValueError, match="paged engine"):
        SlotEngine(cfg, capacity=1, max_len=32, prefix_sharing=True,
                   device="cpu")
    with pytest.raises(ValueError, match="persistent"):
        SlotEngine(cfg, capacity=1, max_len=32, paged=True,
                   persistent_prefix_index=True, device="cpu")
    engine = SlotEngine(cfg, capacity=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        engine.prefill_chunk({}, None, np.arange(16), 0, 0, [], [1], None)


@pytest.mark.parametrize("argv", [
    ["--prefix-sharing"],
    ["--prefix-sharing", "--gated"],
    ["--paged", "--prefix-sharing", "--gated"],
    ["--paged", "--prefix-sharing", "--arch", "deepseek-v2-lite-16b"],
    ["--paged", "--shared-prefix-len", "40"],
])
def test_cli_refuses_sharing_flags(argv):
    if "--arch" not in argv:
        argv = argv + ["--arch", "yi-9b"]
    with pytest.raises(SystemExit) as e:
        launch_serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_cli_serves_a_shared_prefix_stream(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--device", "cpu",
                                "--paged", "--prefix-sharing",
                                "--shared-prefix-len", "24", "--requests",
                                "8", "--capacity", "4"])
    assert len(report.served) == 8
    assert report.stats["shared_admissions"] >= 4
    assert "sharing:" in capsys.readouterr().out
