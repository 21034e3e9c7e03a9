"""The port's paged engine on MLA and hybrid archs against the JAX package
and against the port's own contiguous path.

Inputs are made from a seed with numpy and handed to both packages. The
precise (MLA) mode of the plain ``paged_attention_ref`` is held against
the JAX ref and the Pallas kernel in interpret mode (1e-5: both compute in
fp32 from the same values; the Pallas kernel concatenates q|q2 and k|k2,
which reassociates the score sum), and bitwise against the port's
contiguous precise plain version on the same latent. The paged MLA mixer
is held against JAX's from the same parameters (1e-4, as the contiguous
mixer in ``test_torch_mla.py``: XLA's and PyTorch's CPU matmuls). Paged
serving of the reduced deepseek-v2-lite-16b and jamba-v0.1-52b (float32)
must give the tokens of the port's contiguous engine and of the JAX paged
engine, with a pool smaller than the slots could ask for.
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
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attn_decode.ref import (attn_decode_ref,
                                                 precise_attention)
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (gather_pages,
                                                     paged_attention_ref)
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, generate
from repro_torch.serve.scheduler import Request, SlotScheduler, serve

POLICY = AccelConfig()            # the JAX package's all-ref policy
TOL = 1e-4
TOL_OP = 1e-5
MLA, HYBRID = "deepseek-v2-lite-16b", "jamba-v0.1-52b"


def _configs(arch, dtype="float32"):
    return (get_arch(arch).reduced(dtype=dtype),
            port_arch(arch).reduced(dtype=dtype))


def latent_pages(rng, b, h, r, rd, ps, cache_pos, n_pool):
    """Latent and rotary pools [n_pool, 1, ps, r / rd] behind a shuffled
    page table covering positions 0..cache_pos[b] and -1 beyond, large junk
    in every page no sequence owns except the scratch page 0, and fp32
    queries q [b, h, r] / q2 [b, h, rd]. numpy arrays."""
    need = [int(c) // ps + 1 for c in cache_pos]
    np_ = max(need) + 1                      # a -1 tail on every row
    ids = rng.permutation(np.arange(1, n_pool))
    table = np.full((b, np_), -1, np.int32)
    at = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[at:at + n]
        at += n
    lat = rng.standard_normal((n_pool, 1, ps, r), np.float32)
    kr = rng.standard_normal((n_pool, 1, ps, rd), np.float32)
    for pid in ids[at:]:
        lat[pid] = kr[pid] = 1e4
    q = rng.standard_normal((b, h, r), np.float32) * 0.3
    q2 = rng.standard_normal((b, h, rd), np.float32)
    return q, q2, lat, kr, table


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# the precise (MLA) mode of the paged decode attention op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [4, 16])
def test_precise_paged_ref_matches_jax(ps, dtype):
    rng = np.random.default_rng(ps)
    cp = np.array([0, 9, 2 * ps + 1], np.int32)
    q, q2, lat, kr, table = latent_pages(rng, 3, 4, 32, 8, ps, cp, 12)
    jl = jnp.asarray(lat).astype(jnp.dtype(dtype))
    jk = jnp.asarray(kr).astype(jnp.dtype(dtype))
    tl = _t(np.asarray(jl.astype(jnp.float32)), dtype)
    tk = _t(np.asarray(jk.astype(jnp.float32)), dtype)
    scale = 0.2
    out = paged_attention_ref(_t(q), tl, tl, _t(table), _t(cp, "int32"),
                              scale=scale, q2=_t(q2), k2_pages=tk,
                              precise=True)
    assert out.dtype == torch.float32 and out.shape == (3, 4, 32)
    args = (jnp.asarray(q), jl, jl, jnp.asarray(table), jnp.asarray(cp))
    kw = dict(scale=scale, q2=jnp.asarray(q2), k2_pages=jk, precise=True)
    for want in (jax_pa_ref.paged_attention_ref(*args, **kw),
                 jax_pa_ops.paged_attention_pallas_op(*args, **kw,
                                                      interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=TOL_OP, atol=TOL_OP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [4, 16])
def test_precise_paged_ref_bitwise_equals_contiguous_ref(ps, dtype):
    """On the same latent (the pages gathered into a contiguous cache of
    the same extent) the plain paged and contiguous precise versions agree
    bit for bit: the paged MLA engine's token identity rests on it."""
    rng = np.random.default_rng(3 + ps)
    cp = np.array([5, 17, 30], np.int32)
    q, q2, lat, kr, table = latent_pages(rng, 3, 4, 32, 8, ps, cp, 24)
    tl, tk = _t(lat, dtype), _t(kr, dtype)
    tt, tcp = _t(table, "int32"), _t(cp, "int32")
    got = paged_attention_ref(_t(q), tl, tl, tt, tcp, scale=0.3, q2=_t(q2),
                              k2_pages=tk, precise=True)
    cl = gather_pages(tl, tt)
    want = attn_decode_ref(_t(q), cl, cl, tcp, scale=0.3, q2=_t(q2),
                           k2=gather_pages(tk, tt), precise=True)
    assert torch.equal(got, want)


def test_precise_paged_ref_masks_unallocated_pages():
    """A -1 entry inside a sequence's window is masked: its positions get
    weight 0 whatever the scratch page it gathers holds, even NaN (dead
    slots write there), and the result is the softmax over the allocated
    positions alone."""
    rng = np.random.default_rng(4)
    ps, r, rd = 4, 16, 8
    lat = _t(rng.standard_normal((6, 1, ps, r), np.float32))
    kr = _t(rng.standard_normal((6, 1, ps, rd), np.float32))
    q, q2 = _t(rng.standard_normal((1, 2, r), np.float32)), _t(
        rng.standard_normal((1, 2, rd), np.float32))
    table = torch.tensor([[3, -1, 5]], dtype=torch.int32)
    cp = torch.tensor([11], dtype=torch.int32)
    got = paged_attention_ref(q, lat, lat, table, cp, scale=0.25, q2=q2,
                              k2_pages=kr, precise=True)
    lat2, kr2 = lat.clone(), kr.clone()
    lat2[0], kr2[0] = float("nan"), float("nan")  # the scratch page
    again = paged_attention_ref(q, lat2, lat2, table, cp, scale=0.25, q2=q2,
                                k2_pages=kr2, precise=True)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    keep = torch.tensor([[0, 1, 2, 3, 8, 9, 10, 11]])
    c = gather_pages(lat, table)[:, 0][:, keep[0]]
    k2 = gather_pages(kr, table)[:, 0][:, keep[0]]
    want = precise_attention(q, c, c, torch.ones(1, 8, dtype=torch.bool),
                             0.25, q2, k2)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_gqa_paged_ref_ignores_nan_in_the_scratch_page():
    """The GQA mode too: NaN in the scratch page 0, which every -1 entry
    gathers, never reaches the output (the paged hybrid engine's dead
    slots write there whatever their recurrent state holds)."""
    rng = np.random.default_rng(6)
    kp = _t(rng.standard_normal((5, 2, 4, 16), np.float32))
    vp = _t(rng.standard_normal((5, 2, 4, 16), np.float32))
    q = _t(rng.standard_normal((2, 4, 16), np.float32))
    table = torch.tensor([[3, 1, -1], [2, -1, -1]], dtype=torch.int32)
    cp = torch.tensor([6, 2], dtype=torch.int32)
    got = paged_attention_ref(q, kp, vp, table, cp)
    kn, vn = kp.clone(), vp.clone()
    kn[0], vn[0] = float("nan"), float("nan")
    assert torch.isfinite(got).all()
    assert torch.equal(got, paged_attention_ref(q, kn, vn, table, cp))


def test_precise_paged_wrapper_raises_on_cpu_tensors():
    """No fallback: on a CPU tensor the kernel wrapper raises and counts
    no launch (the op's plain version serves CPU tensors)."""
    lat = torch.zeros(3, 1, 16, 512, dtype=torch.bfloat16)
    kr = torch.zeros(3, 1, 16, 64, dtype=torch.bfloat16)
    before = pa_ops.attn_decode_paged.launches
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        pa_ops.attn_decode_paged(
            torch.zeros(2, 16, 512), lat, lat,
            torch.ones(2, 2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), scale=0.1,
            q2=torch.zeros(2, 16, 64), k2_pages=kr, precise=True)
    assert pa_ops.attn_decode_paged.launches == before


@pytest.mark.parametrize("case", ["ok", "page_size", "heads", "latent",
                                  "v_not_k", "no_q2", "q_dtype"])
def test_precise_paged_wrapper_validates_inputs(case, monkeypatch):
    """The shape rules the wrapper holds the kernel to, with the device
    check and the launch stubbed out (the kernel runs only on the card):
    a page size that does not divide the 32-position tile is refused."""
    from repro_torch.kernels.attn_decode import ops as ad_ops
    monkeypatch.setattr(ad_ops, "require_cuda", lambda *a: None)
    launched = []

    def no_card():
        launched.append(1)
        raise RuntimeError("launch")

    monkeypatch.setattr(pa_ops, "_lib_mla", no_card)
    bf = dict(dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)

    def call(q=None, lat=None, kr=None, ps=16, v=None, q2=True):
        q = torch.zeros(2, 16, 512) if q is None else q
        lat = torch.zeros(3, 1, ps, 512, **bf) if lat is None else lat
        kr = torch.zeros(3, 1, ps, 64, **bf) if kr is None else kr
        return pa_ops.attn_decode_paged(
            q, lat, lat if v is None else v, torch.ones(2, 2, **i32),
            torch.zeros(2, **i32), scale=0.1,
            q2=torch.zeros(q.shape[0], q.shape[1], 64) if q2 else None,
            k2_pages=kr, precise=True)

    calls = {
        "ok": lambda: call(),
        "page_size": lambda: call(ps=24),
        "heads": lambda: call(q=torch.zeros(2, 32, 512)),
        "latent": lambda: call(q=torch.zeros(2, 16, 256),
                               lat=torch.zeros(3, 1, 16, 256, **bf)),
        "v_not_k": lambda: call(v=torch.zeros(3, 1, 16, 512, **bf)),
        "no_q2": lambda: call(q2=False),
        "q_dtype": lambda: call(q=torch.zeros(2, 16, 512, **bf)),
    }
    if case == "ok":
        with pytest.raises(RuntimeError, match="launch"):
            calls[case]()
        assert launched == [1]
    else:
        with pytest.raises((ValueError, TypeError)):
            calls[case]()
        assert not launched


# ---------------------------------------------------------------------------
# the paged MLA mixer
# ---------------------------------------------------------------------------


def test_apply_mla_decode_paged_matches_jax():
    """4 absorbed decode steps against paged latents (a shuffled page
    table, ragged positions, one dead slot writing to the scratch page):
    outputs and the latent pools agree with the JAX mixer, and the port's
    paged mixer equals its contiguous mixer on the same latent bitwise."""
    jcfg, pcfg = _configs(MLA)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    m = pcfg.mla
    rng = np.random.default_rng(31)
    b, ps, n_pool, np_ = 3, 4, 14, 4
    table = np.array([[5, 2, 9, 1], [3, 11, 7, 4], [-1] * 4], np.int32)
    lat = rng.standard_normal((n_pool, ps, m.kv_lora_rank), np.float32)
    kr = rng.standard_normal((n_pool, ps, m.qk_rope_head_dim), np.float32)
    jst = jattn.PagedMLACache(jnp.asarray(lat), jnp.asarray(kr))
    pst = attn.PagedMLACache(_t(lat), _t(kr))
    # the same latent as a contiguous cache [B, NP * ps, r]
    cont = attn.MLACache(
        gather_pages(_t(lat)[:, None], _t(table, "int32"))[:, 0].clone(),
        gather_pages(_t(kr)[:, None], _t(table, "int32"))[:, 0].clone())
    pos = np.array([6, 11, 0], np.int32)
    for _ in range(4):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jattn.apply_mla_decode_paged(
            jp, jnp.asarray(x), jcfg, POLICY, jst, jnp.asarray(pos),
            jnp.asarray(table))
        py, pst = attn.apply_mla_decode_paged(
            pp, _t(x), pcfg, "auto", pst, _t(pos, "int32"),
            _t(table, "int32"))
        cy, cont = attn.apply_mla_decode(pp, _t(x), pcfg, "auto", cont,
                                         _t(pos, "int32"))
        live = slice(0, 2)
        np.testing.assert_allclose(py.numpy()[live], np.asarray(jy)[live],
                                   rtol=TOL, atol=TOL)
        assert torch.equal(py[live], cy[live])
        for a, c in ((pst.c_kv_pages, jst.c_kv_pages),
                     (pst.k_rope_pages, jst.k_rope_pages)):
            np.testing.assert_allclose(a.numpy()[1:], np.asarray(c)[1:],
                                       rtol=TOL, atol=TOL)
        pos = pos + np.array([1, 1, 0], np.int32)


# ---------------------------------------------------------------------------
# the paged cache
# ---------------------------------------------------------------------------


def _leaves(cache):
    return [t for t in cache if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_paged_fill_free_fill_roundtrip_equals_fresh(arch):
    """fill_slot_paged -> free_slot_paged -> fill_slot_paged (same pages)
    equals one fill into a fresh paged cache, leaf for leaf: position,
    page table and recurrent state reset exactly, pools re-scattered."""
    _, pcfg = _configs(arch)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, pcfg.vocab_size, (1, 6)).astype(np.int32))
    src = lm.init_cache(pcfg, 1, 6, device="cpu")
    _, src = lm.forward_prefill(pp, toks, pcfg, "auto", src)
    ids = torch.tensor([2, 4], dtype=torch.int32)
    fresh = lm.fill_slot_paged(
        lm.init_paged_cache(pcfg, 2, 16, 4, 6, device="cpu"), src, 1, 6, ids)
    cycled = lm.init_paged_cache(pcfg, 2, 16, 4, 6, device="cpu")
    cycled = lm.fill_slot_paged(cycled, src, 1, 6, ids)
    cycled = lm.fill_slot_paged(cycled, src, 0, 6,
                                torch.tensor([1, 3], dtype=torch.int32))
    cycled = lm.free_slot_paged(cycled, 0)         # neighbour churn
    cycled = lm.free_slot_paged(cycled, 1)
    assert int(cycled.pos[1]) == 0 and (cycled.page_table[1] == -1).all()
    assert not any(bool(t[:, 1].any()) for t in cycled.recurrent)
    cycled = lm.fill_slot_paged(cycled, src, 1, 6, ids)
    for t in (cycled.c_kv_pages, cycled.k_rope_pages, cycled.k_pages,
              cycled.v_pages):      # page 1 and 3 keep slot 0's bytes
        if t is not None:
            t[:, [1, 3]] = 0
    assert len(_leaves(fresh)) == len(_leaves(cycled))
    for a, c in zip(_leaves(fresh), _leaves(cycled)):
        assert torch.equal(a, c)
    kinds = ((fresh.c_kv_pages is not None, fresh.k_pages is not None,
              fresh.conv is not None))
    assert kinds == ((True, False, False) if arch == MLA
                     else (False, True, True))


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_paged_decode_bitwise_equals_contiguous_decode(arch):
    """One model decode step on a paged cache and on a contiguous cache
    holding the same attention state and the same recurrent state gives
    the same logits bit for bit (the plain versions, float32)."""
    _, pcfg = _configs(arch)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    cont = lm.init_cache(pcfg, 2, 16, device="cpu")
    paged = lm.init_paged_cache(pcfg, 2, 16, 4, 12, device="cpu")
    table = torch.tensor([[5, 2, 9, 1], [3, 11, 7, 4]], dtype=torch.int32)
    paged.page_table.copy_(table)
    for t in cont.states + cont.recurrent:
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)))
    for dst, src in zip(paged.recurrent, cont.recurrent):
        dst.copy_(src)
    for pool, src in zip(paged.pools, cont.states):
        for b in range(2):
            for j in range(4):
                pool[:, int(table[b, j])] = src[:, b, ..., 4 * j:4 * j + 4, :]
    pos = torch.tensor([6, 13], dtype=torch.int32)
    tok = torch.tensor([[17], [101]], dtype=torch.int32)
    a, ea, _ = lm.forward_decode(pp, tok, pcfg, "auto",
                                 cont._replace(pos=pos))
    b, eb, _ = lm.forward_decode(pp, tok, pcfg, "auto",
                                 paged._replace(pos=pos))
    assert torch.equal(a, b) and all(torch.equal(x, y)
                                     for x, y in zip(ea, eb))
    for x, y in zip(cont.recurrent, paged.recurrent):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# paged serving
# ---------------------------------------------------------------------------


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_paged_serve_matches_contiguous_and_jax(arch):
    """7 requests through 3 slots with page churn (a pool of 7 usable
    pages of 4, fewer than 3 slots x 5 pages could ask for, so admission
    waits on pages; exact-length prefill books ceil(prompt / 4) pages):
    the tokens equal the port's contiguous engine's and the JAX paged
    engine's on the same requests."""
    jcfg, pcfg = _configs(arch)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    prompts = _prompts(pcfg.vocab_size, (5, 9, 5, 9, 5, 9, 5), seed=12)
    news = (6, 4, 7, 5, 3, 6, 5)
    kw = dict(capacity=3, max_len=20, chunk=3)
    paged = [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))]
    report = serve(SlotEngine(pcfg, **kw, paged=True, page_size=4,
                              num_pages=8, device="cpu"), pp, paged)
    cont = [Request(i, p, n) for i, (p, n) in enumerate(zip(prompts, news))]
    serve(SlotEngine(pcfg, **kw, device="cpu"), pp, cont)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, news))]
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    jrep = jax_serve(JaxSlotEngine(run, **kw, paged=True, page_size=4,
                                   num_pages=8), jp, jreqs)
    assert report.completion_rate == 1.0
    assert report.stats["max_concurrency"] == 2
    assert report.stats["peak_pages"] <= 7
    assert report.stats["peak_pages"] == jrep.stats["peak_pages"]
    for r, c, j in zip(paged, cont, jreqs):
        assert len(r.tokens) == r.max_new_tokens
        assert r.tokens == c.tokens == list(j.tokens), r.rid


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_exact_length_prefill_books_ceil_pages(arch):
    """MoE and recurrent archs prefill at the exact prompt length (bucket
    1): a 9-token prompt with pages of 4 books ceil(9 / 4) = 3 pages at
    admission and reserves ceil((9 + 6) / 4) = 4 for its decode."""
    _, pcfg = _configs(arch)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    engine = SlotEngine(pcfg, capacity=2, max_len=24, chunk=3, paged=True,
                        page_size=4, device="cpu")
    assert engine.prompt_bucket == 1 and engine._bucket(9) == 9
    sched = SlotScheduler(engine, pp)
    sched.admit(Request(0, _prompts(pcfg.vocab_size, (9,), seed=2)[0], 6),
                0.0)
    assert len(sched.alloc.owned[0]) == 3 and sched.alloc.reserved[0] == 4
    assert engine.prefill_tokens == 9
    assert int(sched.cache.pos[0]) == 9
    assert sched.cache.page_table[0].tolist()[:4] == \
        sched.alloc.owned[0] + [-1]


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_paged_nan_quarantine_scrubs_pages(arch):
    """A paged slot whose attention state goes NaN is shed; its pages are
    zeroed in every pool before they return to the free list, and the
    co-batched request keeps the tokens ``generate`` gives it alone."""
    _, pcfg = _configs(arch)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    engine = SlotEngine(pcfg, capacity=2, max_len=24, chunk=3, paged=True,
                        page_size=4, device="cpu")
    prompts = _prompts(pcfg.vocab_size, (6, 6), seed=5)
    reqs = [Request(i, p, 6) for i, p in enumerate(prompts)]
    sched = SlotScheduler(engine, pp)
    for r in reqs:
        sched.admit(r, 0.0)
    poisoned = list(sched.alloc.owned[1])
    with torch.inference_mode():
        sched.cache.pools[0][:, poisoned[0], :2] = float("nan")
    while sched.busy:
        sched.step_chunk(0.0)
    solo, _ = generate(pcfg, pp, prompts[0][None], 6, device="cpu")
    assert reqs[0].reject_reason is None
    assert reqs[0].tokens == solo[0].tolist()
    assert reqs[1].reject_reason.startswith("nan-quarantined")
    for pool in sched.cache.pools:
        assert not bool(pool[:, poisoned].any())


@pytest.mark.parametrize("arch", [MLA, HYBRID])
def test_launch_serve_paged_cli_on_cpu(arch, capsys):
    report = launcher.main(["--arch", arch, "--requests", "3",
                            "--capacity", "2", "--new-tokens", "4",
                            "--prompt-len-min", "5", "--prompt-len-max",
                            "6", "--max-len", "16", "--device", "cpu",
                            "--paged", "--page-size", "4", "--num-pages",
                            "7"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 4 for r in report.requests)
    assert 0 < report.stats["peak_pages"] <= 6
    out = capsys.readouterr().out
    assert "paged=True" in out and "pages: peak" in out
