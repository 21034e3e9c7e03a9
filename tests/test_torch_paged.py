"""The port's paged KV path against the JAX package and against the port's
own contiguous path.

Inputs are made from a seed with numpy and handed to both packages. The
plain ``paged_attention_ref`` is held against the JAX ref and the Pallas
kernel in interpret mode (float32 1e-5: summation order only; bfloat16
1e-2: the kernel keeps the softmax weights fp32 where the refs round them
to bf16), with junk in pages no sequence owns and -1 table entries. The
page allocator must give the JAX allocator's table for the same call
sequence, and paged serving must give the tokens of the contiguous engine,
of ``generate`` and of the JAX paged engine. ``yi-9b.reduced`` in float32,
weights from the JAX ``init_lm`` through ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.kernels.paged_attention import ops as jax_pa_ops
from repro.kernels.paged_attention import ref as jax_pa_ref
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.paging import PageAllocator as JaxPageAllocator
from repro.serve.scheduler import poisson_requests as jax_requests
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.paged_attention.ops import attn_decode_paged
from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                     paged_attention_ref)
from repro_torch.kernels.verify_decode.ops import (verify_decode,
                                                   verify_decode_paged)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, generate
from repro_torch.serve.paging import PageAllocator, PoolExhausted
from repro_torch.serve.scheduler import (ADMITTED, Request, SlotScheduler,
                                         poisson_requests, serve)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def paged_inputs(rng, b, hq, hkv, d, ps, cache_pos, n_pool, k1=None):
    """Pools of ``n_pool`` pages, a shuffled page table covering positions
    0..cache_pos[b] (+ k1 - 1) and -1 beyond, and large junk in every page
    no sequence owns except the scratch page 0 (the plain versions gather
    page 0 for -1 entries and multiply its rows by a zero weight, which
    must stay finite). Returns numpy arrays (q, k_pages, v_pages, table)."""
    extra = 0 if k1 is None else k1 - 1
    need = [(int(c) + extra) // ps + 1 for c in cache_pos]
    np_ = max(need) + 1                      # a -1 tail on every row
    ids = rng.permutation(np.arange(1, n_pool))
    assert sum(need) <= len(ids)
    table = np.full((b, np_), -1, np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[at:at + n]
        at += n
    shape_q = (b, hq, d) if k1 is None else (b, hq, k1, d)
    q = rng.standard_normal(shape_q, np.float32)
    kp = rng.standard_normal((n_pool, hkv, ps, d), np.float32)
    vp = rng.standard_normal((n_pool, hkv, ps, d), np.float32)
    for pid in ids[at:]:
        kp[pid] = vp[pid] = 1e4
    return q, kp, vp, table


def _pair(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,hd,g", [
    pytest.param(4, 16, 2, id="4"), pytest.param(16, 16, 2, id="16"),
    pytest.param(16, 64, 1, id="16-d64g1")])
def test_paged_attention_ref_matches_jax(ps, hd, g, dtype):
    """Group 2 at head dim 16, and group 1 at musicgen's head dim 64."""
    rng = np.random.default_rng(ps)
    cp = np.array([0, 9, 2 * ps + 1], np.int32)
    q, kp, vp, table = paged_inputs(rng, 3, 4, 4 // g, hd, ps, cp, 12)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    out = paged_attention_ref(tq, tk, tv, torch.from_numpy(table),
                              torch.from_numpy(cp))
    assert out.dtype == torch.float32 and out.shape == (3, 4, hd)
    jt, jcp = jnp.asarray(table), jnp.asarray(cp)
    for want in (jax_pa_ref.paged_attention_ref(jq, jk, jv, jt, jcp),
                 jax_pa_ops.paged_attention_pallas_op(jq, jk, jv, jt, jcp,
                                                      interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_ref_bitwise_equals_contiguous_ref(dtype):
    """On the same KV (the pages gathered into a contiguous cache of the
    same extent) the plain paged and contiguous versions agree bit for bit:
    the paged engine's token identity rests on it."""
    rng = np.random.default_rng(3)
    cp = np.array([5, 17, 30], np.int32)
    q, kp, vp, table = paged_inputs(rng, 3, 4, 2, 16, 8, cp, 20)
    tq, tk, tv = (_pair(a, dtype)[1] for a in (q, kp, vp))
    tt, tcp = torch.from_numpy(table), torch.from_numpy(cp)
    got = paged_attention_ref(tq, tk, tv, tt, tcp)
    want = attn_decode_ref(tq, gather_pages(tk, tt), gather_pages(tv, tt),
                           tcp)
    assert torch.equal(got, want)


def test_paged_precise_mode_not_ported():
    """The precise (MLA) mode of the plain version, once refused, runs:
    one latent head that is K and V, fp32 out, and a -1 page inside the
    window masked (its positions weighted 0, so the result is that of the
    table without it)."""
    rng = np.random.default_rng(9)
    lat = torch.from_numpy(rng.standard_normal((4, 1, 4, 8), np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 2, 8), np.float32))
    cp = torch.tensor([7], dtype=torch.int32)
    table = torch.tensor([[2, -1]], dtype=torch.int32)
    out = paged_attention_ref(q, lat, lat, table, cp, precise=True)
    assert out.dtype == torch.float32 and out.shape == (1, 2, 8)
    short = paged_attention_ref(q, lat, lat, table[:, :1], cp - 4,
                                precise=True)
    torch.testing.assert_close(out, short, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["attn_decode_paged", "verify_decode",
                                  "verify_decode_paged"])
def test_kernel_backend_raises_on_cpu_tensors(name):
    q3, q4 = torch.zeros(1, 2, 128), torch.zeros(1, 2, 3, 128)
    pools, kv = torch.zeros(2, 1, 16, 128), torch.zeros(1, 1, 16, 128)
    table, cp = torch.ones(1, 1, dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    fn, args = {
        "attn_decode_paged": (attn_decode_paged, (q3, pools, pools, table,
                                                  cp)),
        "verify_decode": (verify_decode, (q4, kv, kv, cp)),
        "verify_decode_paged": (verify_decode_paged, (q4, pools, pools,
                                                      table, cp)),
    }[name]
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("case", ["ok", "ok4", "page_size", "group",
                                  "rows", "batch", "table", "ok64",
                                  "head_dim"])
def test_decode_wrappers_validate_inputs(case, monkeypatch):
    """The shape rules the wrappers hold the kernels to, with the device
    check stubbed out (the kernels themselves run only on the card): head
    dims 128 and 64 (musicgen's, group 1) pass, 96 is refused."""
    from repro_torch.kernels.attn_decode import ops as ad_ops
    from repro_torch.kernels.paged_attention.ops import check_paged
    monkeypatch.setattr(ad_ops, "require_cuda", lambda *a: None)
    bf = dict(dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)
    q3, q4 = torch.zeros(2, 8, 128, **bf), torch.zeros(2, 8, 4, 128, **bf)
    kv, pools = torch.zeros(2, 1, 32, 128, **bf), torch.zeros(
        5, 1, 16, 128, **bf)
    table, cp = torch.zeros(2, 2, **i32), torch.zeros(2, **i32)
    calls = {
        "ok": lambda: (ad_ops.check_contiguous("x", q3, kv, kv, cp, 16),
                       check_paged("x", q3, pools, pools, table, cp, 16)),
        "ok4": lambda: (ad_ops.check_contiguous("x", q4, kv, kv, cp, 64),
                        check_paged("x", q4, pools, pools, table, cp, 64)),
        "page_size": lambda: check_paged(
            "x", q3, torch.zeros(5, 1, 24, 128, **bf),
            torch.zeros(5, 1, 24, 128, **bf), table, cp, 16),
        "group": lambda: ad_ops.check_contiguous(
            "x", torch.zeros(2, 32, 128, **bf), kv, kv, cp, 16),
        "rows": lambda: ad_ops.check_contiguous(
            "x", torch.zeros(2, 8, 9, 128, **bf), kv, kv, cp, 64),
        "batch": lambda: ad_ops.check_contiguous(
            "x", q3, kv[:1], kv[:1], cp, 16),
        "table": lambda: check_paged("x", q3, pools, pools, table[:1], cp,
                                     16),
        "ok64": lambda: (
            ad_ops.check_contiguous("x", torch.zeros(2, 24, 64, **bf),
                                    torch.zeros(2, 24, 32, 64, **bf),
                                    torch.zeros(2, 24, 32, 64, **bf), cp, 16),
            check_paged("x", torch.zeros(2, 24, 4, 64, **bf),
                        torch.zeros(5, 24, 16, 64, **bf),
                        torch.zeros(5, 24, 16, 64, **bf), table, cp, 64)),
        "head_dim": lambda: ad_ops.check_contiguous(
            "x", torch.zeros(2, 8, 96, **bf), torch.zeros(2, 1, 32, 96, **bf),
            torch.zeros(2, 1, 32, 96, **bf), cp, 16),
    }
    if case.startswith("ok"):
        assert calls[case]() == (1, 1)              # the bfloat16 code
    else:
        with pytest.raises(ValueError):
            calls[case]()


# ---------------------------------------------------------------------------
# Page allocator
# ---------------------------------------------------------------------------


def test_allocator_table_matches_jax():
    """The same admit / ensure / release sequence, backfill included, gives
    the JAX allocator's table, free list and peak after every call."""
    args = dict(num_pages=12, capacity=3, max_pages=6, page_size=4)
    ours, theirs = PageAllocator(**args), JaxPageAllocator(**args)
    calls = [("admit", 0, 8, 7, 9), ("admit", 1, 4, 3, 6),
             ("ensure", 0, 12), ("admit", 2, 12, 10, 3),
             ("ensure", 1, 8), ("release", 0), ("admit", 0, 4, 2, 10),
             ("ensure", 0, 11), ("release", 2), ("ensure", 1, 7),
             ("release", 1), ("admit", 1, 16, 13, 7)]
    for name, *a in calls:
        got = getattr(ours, name)(*a)
        want = getattr(theirs, name)(*a)
        if name == "admit":
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ours.table, theirs.table)
        assert list(ours.free) == list(theirs.free)
        assert (ours.available, ours.peak_pages, ours.dirty) == (
            theirs.available, theirs.peak_pages, theirs.dirty)


def test_allocator_reservation_accounting():
    alloc = PageAllocator(num_pages=9, capacity=4, max_pages=4, page_size=8)
    assert alloc.available == 8
    ids = alloc.admit(0, bucket_len=16, true_len=12, max_new=12)
    assert list(ids) == [1, 2]                      # bucket pages allocated
    # reservation is the worst case ceil((12+12)/8)=3, not just the bucket
    assert alloc.available == 8 - 3
    alloc.ensure(0, last_pos=17)                    # 3rd page on demand
    assert len(alloc.owned[0]) == 3 and alloc.available == 5
    assert not alloc.can_admit(bucket_len=48, true_len=41, max_new=8)
    with pytest.raises(ValueError):
        alloc.ensure(0, last_pos=24)                # past the reservation
    alloc.release(0)
    assert alloc.available == 8 and not alloc.owned
    with pytest.raises(NotImplementedError):
        PageAllocator(9, 4, 4, 8, sharing=True)
    drained = PageAllocator(num_pages=2, capacity=1, max_pages=1, page_size=8)
    drained.free.clear()
    with pytest.raises(PoolExhausted):
        drained._pop_free()


def _cfgs(exits=True):
    jcfg = get_arch("yi-9b").reduced(dtype="float32")
    pcfg = port_arch("yi-9b").reduced(dtype="float32")
    if not exits:
        jcfg = dataclasses.replace(jcfg, early_exit=None)
        pcfg = dataclasses.replace(pcfg, early_exit=None)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def world():
    jcfg, pcfg = _cfgs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, params_from_jax(jax.device_get(jp), device="cpu")


def _requests(n, seed, make=poisson_requests):
    return make(num=n, rate_hz=np.inf, prompt_lens=(2, 14),
                max_new_tokens=(3, 8), vocab_size=256, seed=seed)


def _check_alloc_invariants(alloc: PageAllocator):
    owned_all = [p for pages in alloc.owned.values() for p in pages]
    assert len(owned_all) == len(set(owned_all)), "page aliased across slots"
    assert 0 not in owned_all, "scratch page allocated"
    assert not (set(owned_all) & set(alloc.free)), "owned page also free"
    for slot, pages in alloc.owned.items():
        n = len(pages)
        assert list(alloc.table[slot, :n]) == pages
        assert (alloc.table[slot, n:] == -1).all()
    for slot in range(alloc.table.shape[0]):
        if slot not in alloc.owned:
            assert (alloc.table[slot] == -1).all()


def test_retire_backfill_never_aliases_pages(world):
    """Churn over the live scheduler: after every admission and every
    chunk, live slots own disjoint page sets, the scratch page is never
    allocated, the mirror rows match ownership and the device table
    equals the mirror once a chunk has run."""
    _, pcfg, _, pp = world
    engine = SlotEngine(pcfg, capacity=3, max_len=32, chunk=2, paged=True,
                        page_size=8, num_pages=10, device="cpu")
    sched = SlotScheduler(engine, pp)
    waiting = _requests(8, seed=3)
    steps = 0
    while waiting or sched.busy:
        while waiting and sched.free:
            if sched.admit(waiting[0], 0.0) != ADMITTED:
                break
            waiting.pop(0)
            _check_alloc_invariants(sched.alloc)
        if sched.busy:
            sched.step_chunk(0.0)
            _check_alloc_invariants(sched.alloc)
            assert sched.alloc.dirty or np.array_equal(
                sched.cache.page_table.numpy(), sched.alloc.table)
        steps += 1
        assert steps < 200
    assert not sched.alloc.owned                    # all pages returned
    assert len(sched.alloc.free) == engine.num_pages - 1


# ---------------------------------------------------------------------------
# Paged serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps", [4, 16])
def test_paged_serve_matches_contiguous_generate_and_jax(world, ps):
    """7 requests through 3 slots and a pool of 8 usable pages, fewer than
    the slots could ask for, so admission waits on pages: the tokens equal
    the contiguous engine's, ``generate``'s and the JAX paged engine's."""
    jcfg, pcfg, jp, pp = world
    num_pages = 8 * 16 // ps + 1
    paged = SlotEngine(pcfg, capacity=3, max_len=32, chunk=4, paged=True,
                       page_size=ps, num_pages=num_pages, device="cpu")
    preqs = _requests(7, seed=1)
    report = serve(paged, pp, preqs)
    contiguous = _requests(7, seed=1)
    serve(SlotEngine(pcfg, capacity=3, max_len=32, chunk=4, device="cpu"),
          pp, contiguous)
    jreqs = _requests(7, seed=1, make=jax_requests)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=AccelConfig())
    jrep = jax_serve(JaxSlotEngine(run, capacity=3, max_len=32, chunk=4,
                                   paged=True, page_size=ps,
                                   num_pages=num_pages), jp, jreqs)
    assert report.completion_rate == 1.0
    assert report.stats["peak_pages"] <= num_pages - 1
    assert report.stats["peak_pages"] == jrep.stats["peak_pages"]
    for r, c, j in zip(preqs, contiguous, jreqs):
        solo, _ = generate(pcfg, pp, r.prompt[None], r.max_new_tokens,
                           device="cpu")
        assert r.tokens == c.tokens == solo[0].tolist() == j.tokens, r.rid


def test_paged_decode_bitwise_equals_contiguous_decode(world):
    """One model decode step on a paged cache and on a contiguous cache
    holding the same KV gives the same logits bit for bit."""
    _, pcfg, _, pp = world
    rng = np.random.default_rng(7)
    cont = lm.init_cache(pcfg, 2, 16, device="cpu")
    paged = lm.init_paged_cache(pcfg, 2, 16, 4, 12, device="cpu")
    table = torch.tensor([[5, 2, 9, 1], [3, 11, 7, 4]], dtype=torch.int32)
    paged.page_table.copy_(table)
    kv = torch.from_numpy(rng.standard_normal(cont.k.shape, np.float32))
    cont.k.copy_(kv)
    cont.v.copy_(kv * 0.5)
    for b in range(2):
        for j in range(4):
            pid = int(table[b, j])
            paged.k_pages[:, pid] = cont.k[:, b, :, 4 * j:4 * j + 4]
            paged.v_pages[:, pid] = cont.v[:, b, :, 4 * j:4 * j + 4]
    pos = torch.tensor([6, 13], dtype=torch.int32)
    tok = torch.tensor([[17], [101]], dtype=torch.int32)
    a, ea, _ = lm.forward_decode(pp, tok, pcfg, "auto", cont._replace(pos=pos))
    b, eb, _ = lm.forward_decode(pp, tok, pcfg, "auto",
                                 paged._replace(pos=pos))
    assert torch.equal(a, b) and torch.equal(ea[0], eb[0])


def test_free_slot_paged_clears_only_its_row():
    _, pcfg = _cfgs()
    cache = lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")
    cache.page_table.copy_(torch.tensor([[3, 1, -1, -1], [2, 7, 4, 6]],
                                        dtype=torch.int32))
    cache = cache._replace(pos=torch.tensor([5, 13], dtype=torch.int32))
    cache.k_pages[:, 2] = 1.0
    cache = lm.free_slot_paged(cache, 1)
    assert cache.pos.tolist() == [5, 0]
    assert cache.page_table.tolist() == [[3, 1, -1, -1], [-1] * 4]
    assert bool((cache.k_pages[:, 2] == 1.0).all())     # pages keep bytes


def test_paged_admission_waits_on_pages(world):
    """Four 2-page requests over 4 slots and 4 usable pages: concurrency is
    bounded by pages (2), not slots, and every request is served."""
    _, pcfg, _, pp = world
    engine = SlotEngine(pcfg, capacity=4, max_len=32, chunk=4, paged=True,
                        page_size=8, num_pages=5, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, 256, 6).astype(np.int32), 6)
            for i in range(4)]
    report = serve(engine, pp, reqs)
    assert all(len(r.tokens) == 6 for r in reqs)
    assert report.stats["max_concurrency"] == 2.0
    assert report.stats["peak_pages"] == 4.0


def test_paged_nan_quarantine_scrubs_pages(world):
    """A paged slot whose KV goes NaN is shed; its pages are zeroed before
    they return to the pool and the co-batched request is untouched."""
    _, pcfg, _, pp = world
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=4, paged=True,
                        page_size=8, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 6).astype(np.int32) for _ in range(2)]
    reqs = [Request(i, p, 6) for i, p in enumerate(prompts)]
    sched = SlotScheduler(engine, pp)
    for r in reqs:
        sched.admit(r, 0.0)
    poisoned = list(sched.alloc.owned[1])
    with torch.inference_mode():
        sched.cache.v_pages[:, poisoned[0], :, :3] = float("nan")
    while sched.busy:
        sched.step_chunk(0.0)
    solo, _ = generate(pcfg, pp, prompts[0][None], 6, device="cpu")
    assert reqs[0].reject_reason is None and reqs[0].tokens == solo[0].tolist()
    assert reqs[1].reject_reason.startswith("nan-quarantined")
    assert torch.isfinite(sched.cache.v_pages[:, poisoned]).all()


def test_engine_rejects_bad_paged_configs(world):
    _, pcfg, _, pp = world
    with pytest.raises(ValueError, match="cannot hold one max-length"):
        SlotEngine(pcfg, capacity=2, max_len=32, paged=True, page_size=8,
                   num_pages=4, device="cpu")
    engine = SlotEngine(pcfg, capacity=2, max_len=32, paged=True,
                        page_size=8, device="cpu")
    cache, st = engine.init_state()
    with pytest.raises(ValueError, match="page_ids"):
        engine.prefill_into(pp, cache, st, np.arange(5), 0, 4)
    with pytest.raises(ValueError, match="page ids for a bucket"):
        engine.prefill_into(pp, cache, st, np.arange(5), 0, 4,
                            page_ids=np.array([1, 2, 3], np.int32))


def test_launch_serve_paged_cli_on_cpu(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--requests", "3",
                                "--capacity", "2", "--new-tokens", "4",
                                "--max-len", "32", "--device", "cpu",
                                "--paged", "--page-size", "8",
                                "--num-pages", "6"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 4 for r in report.requests)
    assert 0 < report.stats["peak_pages"] <= 5
    assert "pages: peak" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--page-size", "8"],
                                  ["--num-pages", "9"]])
def test_launch_serve_rejects_page_flags_without_paged(argv, capsys):
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "yi-9b", "--device", "cpu"] + argv)
    assert "require --paged" in capsys.readouterr().err
