"""The port's greedy speculative decoding against the JAX package and
against the port's own plain greedy path.

The plain verify versions are held against the JAX refs and the Pallas
kernels in interpret mode (float32 1e-5: summation order only; bfloat16
1e-2: the Pallas kernels keep the query and the softmax weights fp32
where the refs round them to bf16), contiguous and paged (page sizes 4
and 16, junk in unowned pages, -1 entries). Row i of a plain verify
version must equal the single-token plain version at ``cache_pos + i``
bit for bit. Spec serving, tied and independent draft, on the contiguous
and the paged engine, must give the plain greedy tokens and the JAX spec
engine's tokens; the tied draft accepts every proposal. ``yi-9b.reduced``
in float32 with the exit heads stripped, weights (the draft's too) from
the JAX ``init_lm`` through ``params_from_jax``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.kernels.verify_decode import ops as jax_vd_ops
from repro.kernels.verify_decode import ref as jax_vd_ref
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.engine import SpecConfig as JaxSpecConfig
from repro.serve.scheduler import poisson_requests as jax_requests
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.verify_decode.ref import (verify_decode_paged_ref,
                                                   verify_decode_ref)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig
from repro_torch.serve.scheduler import poisson_requests, serve
from test_torch_paged import paged_inputs

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(a, dtype):
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, wants, dtype):
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def _contiguous_inputs(seed, k1, s=64, hd=16, g=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 4, k1, hd), np.float32)
    k = rng.standard_normal((3, 4 // g, s, hd), np.float32)
    v = rng.standard_normal((3, 4 // g, s, hd), np.float32)
    cp = np.array([0, 21, s - k1], np.int32)     # the last row at S - 1
    return q, k, v, cp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k1,hd,g", [
    pytest.param(1, 16, 2, id="1"), pytest.param(4, 16, 2, id="4"),
    pytest.param(4, 64, 1, id="4-d64g1")])
def test_verify_ref_matches_jax(k1, hd, g, dtype):
    """Group 2 at head dim 16, and group 1 at musicgen's head dim 64."""
    q, k, v, cp = _contiguous_inputs(k1, k1, hd=hd, g=g)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out = verify_decode_ref(tq, tk, tv, torch.from_numpy(cp))
    assert out.dtype == torch.float32 and out.shape == (3, 4, k1, hd)
    jcp = jnp.asarray(cp)
    _close(out, [jax_vd_ref.verify_decode_ref(jq, jk, jv, jcp),
                 jax_vd_ops.verify_decode_pallas_op(jq, jk, jv, jcp, bs=32,
                                                    interpret=True)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps,hd,g", [
    pytest.param(4, 16, 2, id="4"), pytest.param(16, 16, 2, id="16"),
    pytest.param(16, 64, 1, id="16-d64g1")])
def test_verify_paged_ref_matches_jax(ps, hd, g, dtype):
    """Group 2 at head dim 16, and group 1 at musicgen's head dim 64."""
    rng = np.random.default_rng(ps + 1)
    cp = np.array([0, 9, 2 * ps + 1], np.int32)
    q, kp, vp, table = paged_inputs(rng, 3, 4, 4 // g, hd, ps, cp, 14, k1=3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    out = verify_decode_paged_ref(tq, tk, tv, torch.from_numpy(table),
                                  torch.from_numpy(cp))
    assert out.shape == (3, 4, 3, hd)
    jt, jcp = jnp.asarray(table), jnp.asarray(cp)
    _close(out, [jax_vd_ref.verify_decode_paged_ref(jq, jk, jv, jt, jcp),
                 jax_vd_ops.verify_decode_paged_pallas_op(
                     jq, jk, jv, jt, jcp, interpret=True)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_rows_bitwise_equal_single_token_decode(dtype):
    """Row i of each plain verify version is bit for bit the single-token
    plain version at cache_pos + i: greedy spec == plain greedy rests on
    it (the kernels are held to the same on the card)."""
    q, k, v, cp = _contiguous_inputs(5, 4)
    tq, tk, tv = (_pair(a, dtype)[1] for a in (q, k, v))
    tcp = torch.from_numpy(cp)
    got = verify_decode_ref(tq, tk, tv, tcp)
    rng = np.random.default_rng(6)
    pq, kp, vp, table = paged_inputs(rng, 2, 4, 2, 16, 4, cp[:2], 12, k1=4)
    pq, kp, vp = (_pair(a, dtype)[1] for a in (pq, kp, vp))
    tt, pcp = torch.from_numpy(table), tcp[:2]
    got_p = verify_decode_paged_ref(pq, kp, vp, tt, pcp)
    for i in range(4):
        assert torch.equal(got[:, :, i],
                           attn_decode_ref(tq[:, :, i], tk, tv, tcp + i))
        assert torch.equal(got_p[:, :, i], paged_attention_ref(
            pq[:, :, i], kp, vp, tt, pcp + i))


def _cfgs():
    jcfg = dataclasses.replace(get_arch("yi-9b").reduced(dtype="float32"),
                               early_exit=None)
    pcfg = dataclasses.replace(port_arch("yi-9b").reduced(dtype="float32"),
                               early_exit=None)
    return jcfg, pcfg


def _draft(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-draft1l",
                               num_layers=1)


@pytest.fixture(scope="module")
def world():
    """Parameters, 7 requests through 3 slots and their plain greedy tokens
    from the port's contiguous engine."""
    jcfg, pcfg = _cfgs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    reqs = _requests(poisson_requests)
    serve(SlotEngine(pcfg, capacity=3, max_len=32, chunk=4, device="cpu"),
          pp, reqs)
    return jcfg, pcfg, jp, pp, [r.tokens for r in reqs]


def _requests(make):
    return make(num=7, rate_hz=np.inf, prompt_lens=(2, 13),
                max_new_tokens=(2, 10), vocab_size=256, seed=4)


def test_verify_drops_rows_past_the_cache_extent(world):
    """A contiguous verify whose rows run past the cache extent drops
    them, as the JAX scatter does: the rows inside land at their
    positions, and every other position keeps its bits."""
    _, pcfg, _, pp, _ = world
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 4)).astype(np.int32))
    cache = lm.init_cache(pcfg, 2, 8, device="cpu")
    for t in (cache.k, cache.v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, np.float32)))
    before = cache.k.clone(), cache.v.clone()
    pos = torch.tensor([6, 1], dtype=torch.int32)     # rows 8, 9 of b0 drop
    _, after = lm.forward_verify(pp, tokens, pcfg, "auto",
                                 cache._replace(pos=pos))
    seq = lm.init_cache(pcfg, 2, 8, device="cpu")
    seq.k.copy_(before[0])
    seq.v.copy_(before[1])
    seq = seq._replace(pos=pos)
    for i in range(2):                 # b0's two rows inside the extent
        _, _, seq = lm.forward_decode(pp, tokens[:, i:i + 1], pcfg, "auto",
                                      seq, with_exits=False)
    stepped = [(0, 6), (0, 7), (1, 1), (1, 2)]
    kept = torch.ones(2, 8, dtype=torch.bool)       # positions not written
    for b, p in stepped + [(1, 3), (1, 4)]:
        kept[b, p] = False
    for got, old, want in ((after.k, before[0], seq.k),
                           (after.v, before[1], seq.v)):
        for b, p in stepped:
            np.testing.assert_allclose(got[:, b, :, p].numpy(),
                                       want[:, b, :, p].numpy(),
                                       rtol=1e-5, atol=1e-5)
        assert torch.equal(got.transpose(2, 3)[:, kept],
                           old.transpose(2, 3)[:, kept])


def test_forward_verify_rows_match_sequential_decode(world):
    """Logits row i of one verify forward equal the i-th sequential decode
    step (float32; the plain GEMM may reduce M = B * K1 rows in another
    order than M = B, so 1e-5)."""
    _, pcfg, _, pp, _ = world
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, 256, (2, 4)).astype(np.int32))
    for paged in (False, True):
        caches = []
        for _ in range(2):
            if paged:
                c = lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")
                c.page_table.copy_(torch.tensor([[3, 1, 8, 5], [2, 7, 4, 6]],
                                                dtype=torch.int32))
            else:
                c = lm.init_cache(pcfg, 2, 16, device="cpu")
            caches.append(c._replace(pos=torch.tensor([3, 9],
                                                      dtype=torch.int32)))
        vlg, vc = lm.forward_verify(pp, tokens, pcfg, "auto", caches[0])
        assert torch.equal(vc.pos, caches[0].pos)     # pos left unchanged
        seq = caches[1]
        for i in range(4):
            lg, _, seq = lm.forward_decode(pp, tokens[:, i:i + 1], pcfg,
                                           "auto", seq)
            np.testing.assert_allclose(vlg[:, i].numpy(), lg.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tied", [True, False])
def test_spec_serve_matches_plain_greedy_and_jax(world, paged, tied):
    jcfg, pcfg, jp, pp, plain = world
    kw = dict(capacity=3, max_len=32, chunk=2, paged=paged, page_size=8)
    spec = SpecConfig(draft_arch=pcfg if tied else _draft(pcfg), k=3,
                      share_params=tied)
    engine = SlotEngine(pcfg, device="cpu", spec=spec, **kw)
    jspec = JaxSpecConfig(draft_arch=jcfg if tied else _draft(jcfg), k=3,
                          share_params=tied)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=AccelConfig())
    jengine = JaxSlotEngine(run, spec=jspec, **kw)
    if not tied:
        engine.set_draft_params(params_from_jax(
            jax.device_get(jengine.draft_params), device="cpu"))
    reqs, jreqs = _requests(poisson_requests), _requests(jax_requests)
    report = serve(engine, pp, reqs)
    jreport = jax_serve(jengine, jp, jreqs)
    assert [r.tokens for r in reqs] == plain
    assert [r.tokens for r in jreqs] == plain
    assert report.stats["realized_tokens"] == sum(len(t) - 1 for t in plain)
    if tied:
        assert report.stats["spec_acceptance"] == 1.0
    assert report.stats["spec_proposed"] == jreport.stats["spec_proposed"]
    assert report.stats["spec_accepted"] == jreport.stats["spec_accepted"]


def test_engine_rejects_bad_spec_configs(world):
    _, pcfg, _, pp, _ = world
    kw = dict(capacity=2, max_len=24, device="cpu")
    with pytest.raises(ValueError, match="spec.k"):
        SlotEngine(pcfg, spec=SpecConfig(draft_arch=pcfg, k=0), **kw)
    with pytest.raises(ValueError, match="rows of one verify"):
        SlotEngine(pcfg, spec=SpecConfig(draft_arch=pcfg, k=24,
                                         share_params=True), **kw)
    with pytest.raises(ValueError, match="share_params"):
        SlotEngine(pcfg, spec=SpecConfig(draft_arch=_draft(pcfg), k=2,
                                         share_params=True), **kw)
    with pytest.raises(ValueError, match="vocab"):
        SlotEngine(pcfg, spec=SpecConfig(draft_arch=dataclasses.replace(
            pcfg, vocab_size=128), k=2), **kw)
    exits = port_arch("yi-9b").reduced(dtype="float32")
    with pytest.raises(ValueError, match="early-exit"):
        SlotEngine(exits, spec=SpecConfig(draft_arch=exits, k=2,
                                          share_params=True), **kw)
    # sampling is no bad config: the sampled spec engine constructs and
    # serves every request its budget
    sampled = SlotEngine(pcfg, spec=SpecConfig(draft_arch=pcfg, k=2),
                         temperature=0.7, **kw)
    reqs = _requests(poisson_requests)
    assert len(serve(sampled, pp, reqs).served) == len(reqs)
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)


def test_set_draft_params_validates(world):
    _, pcfg, _, pp, _ = world
    kw = dict(capacity=2, max_len=24, device="cpu")
    engine = SlotEngine(pcfg, spec=SpecConfig(draft_arch=_draft(pcfg), k=2),
                        **kw)
    engine.set_draft_params(lm.init_lm(_draft(pcfg), seed=9, device="cpu"))
    with pytest.raises(ValueError, match="draft arch"):
        engine.set_draft_params(pp)                 # the target's tree
    tied = SlotEngine(pcfg, spec=SpecConfig(draft_arch=pcfg, k=2,
                                            share_params=True), **kw)
    with pytest.raises(ValueError, match="independent"):
        tied.set_draft_params(pp)


def test_launch_serve_spec_cli_on_cpu(capsys):
    report = launch_serve.main(["--arch", "yi-9b", "--requests", "3",
                                "--capacity", "2", "--new-tokens", "6",
                                "--max-len", "32", "--device", "cpu",
                                "--paged", "--draft", "yi-9b",
                                "--spec-k", "3"])
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 6 for r in report.requests)
    assert report.stats["spec_proposed"] > 0
    assert "spec decode: k=3" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--spec-k", "3"], "--draft"),
    (["--draft", "yi-9b", "--spec-k", "0"], ">= 1"),
    (["--draft", "no-such-arch"], "not a known arch"),
    (["--draft", "yi-9b", "--threshold", "0.5"], "--threshold"),
])
def test_launch_serve_rejects_bad_spec_flags(capsys, argv, needle):
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(["--arch", "yi-9b", "--device", "cpu"] + argv)
    assert ei.value.code == 2                     # argparse error exit
    assert needle in capsys.readouterr().err
