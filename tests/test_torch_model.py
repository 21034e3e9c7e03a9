"""The port's dense LM against the JAX package's, from the same weights.

``yi-9b.reduced(dtype="float32")`` is initialised by the JAX ``init_lm``
and loaded into the port with ``params_from_jax``. Tolerance 1e-4 on
logits of magnitude ~1: both sides run in fp32 and differ only in the
summation order of XLA's and PyTorch's CPU matmuls, which a 2-layer model
keeps at the 1e-6 level.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.core.early_exit import should_exit as jax_should_exit
from repro.models import lm as jlm
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import xaif
from repro_torch.core.early_exit import merge_exit_logits, should_exit
from repro_torch.models import lm
from repro_torch.serve.engine import generate

TOL = 1e-4
POLICY = AccelConfig()            # the JAX package's all-ref policy


def _configs(dtype="float32", threshold=None):
    jcfg = get_arch("yi-9b").reduced(dtype=dtype)
    pcfg = port_arch("yi-9b").reduced(dtype=dtype)
    if threshold is not None:
        jcfg = dataclasses.replace(jcfg, early_exit=dataclasses.replace(
            jcfg.early_exit, entropy_threshold=threshold))
        pcfg = dataclasses.replace(pcfg, early_exit=dataclasses.replace(
            pcfg.early_exit, entropy_threshold=threshold))
    return jcfg, pcfg


def _params(jcfg, seed=0):
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(t):
    return t.float().numpy()


def test_configs_match_the_jax_package():
    for jcfg, pcfg in (_configs(), (get_arch("yi-9b"), port_arch("yi-9b"))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta", "dtype",
                  "norm_eps"):
            assert getattr(jcfg, f) == getattr(pcfg, f), f
        assert jcfg.early_exit.exit_layers == pcfg.early_exit.exit_layers
    assert lm._segments(_configs()[1]) == jlm._segments(_configs()[0])


def test_params_from_jax_is_copy_only():
    jcfg, _ = _configs(dtype="bfloat16")
    jp, pp = _params(jcfg)
    jl = jax.tree_util.tree_leaves(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves(pp)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
    assert pp["slots"][0]["mixer"]["wq"].dtype == torch.bfloat16
    assert pp["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_match(ragged):
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 9), np.int32)
    lengths = np.array([9, 5], np.int32) if ragged else None
    jlog, jcache = jlm.forward_prefill(
        jp, jnp.asarray(tokens), jcfg, POLICY, jlm.init_cache(jcfg, 2, 12),
        lengths=None if lengths is None else jnp.asarray(lengths))
    plog, pcache = lm.forward_prefill(
        pp, torch.from_numpy(tokens), pcfg, "auto",
        lm.init_cache(pcfg, 2, 12, device="cpu"),
        lengths=None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(pcache.pos.numpy(), np.asarray(jcache.pos))
    # the cache holds the same K rows (layer-stacked in both packages)
    np.testing.assert_allclose(_np(pcache.k), np.asarray(jcache.slots[0].k),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("threshold", [0.45, 1.0])
def test_decode_and_exit_logits_match_over_8_steps(threshold):
    """Teacher-forced decode: both packages take the same tokens; final
    logits, exit logits and the exit entropies agree at every step."""
    jcfg, pcfg = _configs(threshold=threshold)
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 256, (3, 6), np.int32)
    feed = rng.integers(0, 256, (8, 3), np.int32)
    _, jc = jlm.forward_prefill(jp, jnp.asarray(prompt), jcfg, POLICY,
                                jlm.init_cache(jcfg, 3, 16))
    _, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg, "auto",
                               lm.init_cache(pcfg, 3, 16, device="cpu"))
    th = pcfg.early_exit.entropy_threshold
    for step in range(8):
        tok = feed[step][:, None]
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(tok), jcfg,
                                           POLICY, jc)
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(tok), pcfg,
                                          "auto", pc)
        np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                                   atol=TOL)
        assert len(pex) == len(jex) == 1
        np.testing.assert_allclose(_np(pex[0]), np.asarray(jex[0]),
                                   rtol=TOL, atol=TOL)
        jmask, jent = jax_should_exit(jex[0], th, POLICY)
        pmask, pent = should_exit(pex[0], th, "auto")
        np.testing.assert_allclose(_np(pent), np.asarray(jent), atol=1e-5)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))


PINNED_PROMPTS = [[5, 17, 200, 3, 90], [1, 2, 3, 4, 5, 6, 7, 8, 9],
                  [255, 0, 128, 64, 32, 16, 8, 4, 2, 1, 77, 13]]


@pytest.mark.parametrize("threshold", [0.45, 1.0])
def test_greedy_tokens_identical(threshold):
    """threshold 1.0: every step exits at the exit head (merge path);
    0.45: no row is that confident, every step runs to the end."""
    jcfg, pcfg = _configs(threshold=threshold)
    jp, pp = _params(jcfg)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    for prompt in PINNED_PROMPTS:
        p = np.asarray([prompt], np.int32)
        jtok, jstats = jax_generate(run, jp, jnp.asarray(p), 10)
        ptok, pstats = generate(pcfg, pp, p, 10, device="cpu")
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        assert pstats["exit_rate"] == pytest.approx(jstats["exit_rate"])
        assert pstats["gated_fraction"] == pytest.approx(
            jstats["gated_fraction"])


def test_bf16_greedy_agreement_rate():
    """At bf16 the two frameworks round at the same points but sum in
    other orders, so greedy paths may part after a near tie. The rate of
    agreeing tokens is reported and must stay high."""
    jcfg, pcfg = _configs(dtype="bfloat16")
    jp, pp = _params(jcfg)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    agree = total = 0
    for prompt in PINNED_PROMPTS:
        p = np.asarray([prompt], np.int32)
        jtok = np.asarray(jax_generate(run, jp, jnp.asarray(p), 10)[0])[0]
        ptok = generate(pcfg, pp, p, 10, device="cpu")[0].numpy()[0]
        # tokens agree up to the first divergence; count that prefix
        same = np.cumprod(jtok == ptok)
        agree += int(same.sum())
        total += len(jtok)
    rate = agree / total
    print(f"bf16 greedy agreement rate: {rate:.3f} ({agree}/{total})")
    assert rate >= 0.5, rate


def test_ops_get_contiguous_inputs(monkeypatch):
    """The CUDA kernels take contiguous tensors only (their wrappers
    raise otherwise). Check on the CPU that the model hands every op
    contiguous inputs, at batch > 1, ragged lengths, decode and verify,
    on a contiguous and on a paged cache, and through the MLA + MoE layers
    of the reduced deepseek-v2-lite-16b and the Mamba + attention + MoE
    layers of the reduced jamba-v0.1-52b (prefill and decode with a live
    mask)."""
    seen = []
    for name in xaif.ops():
        e = xaif.entry(name)

        def checked(*args, _plain=e.plain, _name=name, **kw):
            for a in list(args) + list(kw.values()):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (_name, tuple(a.shape))
            seen.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setitem(xaif._REGISTRY, name,
                            xaif.OpEntry(name, checked, e.kernel))
    _, pcfg = _configs()
    pp = lm.init_lm(pcfg, device="cpu")
    tokens = torch.randint(0, 256, (3, 7), dtype=torch.int32)
    for lengths in (None, torch.tensor([7, 2, 5], dtype=torch.int32)):
        cache = lm.init_cache(pcfg, 3, 12, device="cpu")
        _, cache = lm.forward_prefill(pp, tokens, pcfg, "auto", cache,
                                      lengths=lengths)
        logits, exits, _ = lm.forward_decode(pp, tokens[:, :1], pcfg, "auto",
                                             cache)
        merge_exit_logits(logits, exits, pcfg.early_exit, "auto")
        lm.forward_verify(pp, tokens[:, :3], pcfg, "auto", cache)
    paged = lm.init_paged_cache(pcfg, 3, 12, 4, 10, device="cpu")
    paged.page_table[:] = torch.arange(1, 10, dtype=torch.int32).view(3, 3)
    paged = paged._replace(pos=torch.tensor([7, 2, 5], dtype=torch.int32))
    lm.forward_decode(pp, tokens[:, :1], pcfg, "auto", paged)
    lm.forward_verify(pp, tokens[:, :3], pcfg, "auto", paged)
    dcfg = port_arch("deepseek-v2-lite-16b").reduced()
    dp = lm.init_lm(dcfg, device="cpu")
    cache = lm.init_cache(dcfg, 3, 12, device="cpu")
    _, cache = lm.forward_prefill(dp, tokens, dcfg, "auto", cache)
    lm.forward_decode(dp, tokens[:, :1], dcfg, "auto", cache,
                      live=torch.tensor([True, False, True]))
    jcfg = port_arch("jamba-v0.1-52b").reduced()
    jp = lm.init_lm(jcfg, device="cpu")
    cache = lm.init_cache(jcfg, 3, 12, device="cpu")
    _, cache = lm.forward_prefill(jp, tokens, jcfg, "auto", cache)
    lm.forward_decode(jp, tokens[:, :1], jcfg, "auto", cache,
                      live=torch.tensor([True, False, True]))
    assert set(seen) == set(xaif.ops())
