"""The port's musicgen-medium against the JAX package's, from the same
weights.

``musicgen-medium.reduced(num_kv_heads=4, head_dim=64, dtype="float32")``:
two layers of 4 query heads over 4 KV heads of 64 (group 1, the head dim
of the full config; ``reduced()`` alone would give group 2 and head dim
16), no rotary embedding, an exit after layer 1. Initialised by the JAX
``init_lm`` and loaded into the port with ``params_from_jax``. Tolerance
1e-4 on logits of magnitude ~1, as ``tests/test_torch_model.py``: both
sides run in fp32 and differ only in summation order. The frontend is a
stub: the model takes frame embeddings [B, T, d] as well as codebook ids
(served through the ``embed`` table, as the JAX engine serves them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.models import lm as jlm
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, generate
from repro_torch.serve.scheduler import Request, serve

TOL = 1e-4
POLICY = AccelConfig()            # the JAX package's all-ref policy
NAME = "musicgen-medium"
REDUCED = dict(num_kv_heads=4, head_dim=64, dtype="float32")


def _configs(threshold=None):
    jcfg, pcfg = (get_arch(NAME).reduced(**REDUCED),
                  port_arch(NAME).reduced(**REDUCED))
    if threshold is not None:
        jcfg, pcfg = (dataclasses.replace(c, early_exit=dataclasses.replace(
            c.early_exit, entropy_threshold=threshold)) for c in (jcfg, pcfg))
    return jcfg, pcfg


@pytest.fixture(scope="module")
def world():
    jcfg, pcfg = _configs()
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, pcfg, jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(t):
    return t.float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_configs_match_the_jax_package():
    for jcfg, pcfg in (_configs(), (get_arch(NAME), port_arch(NAME))):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "rope",
                  "frontend_stub", "dtype", "norm_eps"):
            assert getattr(jcfg, f) == getattr(pcfg, f), f
        assert jcfg.early_exit == jcfg.early_exit.__class__(
            **dataclasses.asdict(pcfg.early_exit))
    pcfg = _configs()[1]
    assert (pcfg.head_dim, pcfg.num_heads // pcfg.num_kv_heads) == (64, 1)
    assert port_arch(NAME).head_dim == 64
    assert lm._segments(pcfg) == jlm._segments(_configs()[0])


def test_params_from_jax_is_copy_only(world):
    _, pcfg, jp, pp = world
    jl = jax.tree_util.tree_leaves(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves(pp)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
    assert pp["slots"][0]["mixer"]["wq"].shape[-1] == 4 * 64


def _prefill(world, inputs, max_len=16):
    jcfg, pcfg, jp, pp = world
    b = inputs.shape[0]
    jlog, jc = jlm.forward_prefill(jp, jnp.asarray(inputs), jcfg, POLICY,
                                   jlm.init_cache(jcfg, b, max_len))
    plog, pc = lm.forward_prefill(pp, torch.from_numpy(inputs), pcfg, "auto",
                                  lm.init_cache(pcfg, b, max_len,
                                                device="cpu"))
    _close(plog, jlog)
    np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    _close(pc.k, jc.slots[0].k)
    return jc, pc


@pytest.mark.parametrize("inputs", ["tokens", "embeddings"])
def test_prefill_and_decode_logits_match_over_8_steps(world, inputs):
    """Prefill, then 8 teacher-forced decode steps: final and exit logits
    agree at every step, from codebook ids or from frame embeddings
    ([B, T, d] and [B, 1, d], made with numpy from a seed)."""
    jcfg, pcfg, jp, pp = world
    rng = np.random.default_rng(2)
    if inputs == "tokens":
        prompt = rng.integers(0, 256, (3, 6), np.int32)
        feed = rng.integers(0, 256, (8, 3, 1), np.int32)
    else:
        prompt = rng.standard_normal((3, 6, 64), np.float32)
        feed = rng.standard_normal((8, 3, 1, 64), np.float32)
    jc, pc = _prefill(world, prompt)
    for step in range(8):
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(feed[step]), jcfg,
                                           POLICY, jc)
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(feed[step]),
                                          pcfg, "auto", pc)
        _close(plog, jlog)
        assert len(pex) == len(jex) == 1
        _close(pex[0], jex[0])
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))


PINNED_PROMPTS = [[5, 17, 200, 3, 90],
                  [255, 0, 128, 64, 32, 16, 8, 4, 2, 1, 77, 13]]


@pytest.mark.parametrize("threshold", [0.45, 1.0])
def test_greedy_tokens_identical(threshold):
    """threshold 1.0: every step exits at the exit head; 0.45: every step
    runs to the end."""
    jcfg, pcfg = _configs(threshold)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    for prompt in PINNED_PROMPTS:
        p = np.asarray([prompt], np.int32)
        jtok, jstats = jax_generate(run, jp, jnp.asarray(p), 8)
        ptok, pstats = generate(pcfg, pp, p, 8, device="cpu")
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        assert pstats["exit_rate"] == pytest.approx(jstats["exit_rate"])


ENGINE_PROMPTS = [np.random.default_rng(5).integers(0, 256, (n,), np.int32)
                  for n in (3, 11, 7, 14)]


@pytest.fixture(scope="module")
def jax_tokens(world):
    """JAX's ``generate`` (6 new tokens) on each of ``ENGINE_PROMPTS``."""
    jcfg, _, jp, _ = world
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    return [np.asarray(jax_generate(run, jp, jnp.asarray(p[None]), 6)[0]
                       )[0].tolist() for p in ENGINE_PROMPTS]


@pytest.mark.parametrize("paged", [False, True])
def test_engines_match_jax_generate(world, jax_tokens, paged):
    """4 requests through 2 slots (backfill), contiguous or paged (pages of
    4 from a pool smaller than the slots could ask for): each request's
    tokens equal JAX's ``generate`` on its prompt."""
    _, pcfg, _, pp = world
    requests = [Request(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(ENGINE_PROMPTS)]
    kw = dict(paged=True, page_size=4, num_pages=10) if paged else {}
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=4, device="cpu",
                        **kw)
    report = serve(engine, pp, requests)
    assert report.completion_rate == 1.0
    if paged:
        assert report.stats["peak_pages"] <= 9
    for r, want in zip(requests, jax_tokens):
        assert r.tokens == want, r.rid


def test_embeddings_only_for_a_stub_frontend():
    """Without ``frontend_stub`` float inputs raise, as JAX asserts; token
    ids there run as before (yi-9b's reduced config against JAX)."""
    jcfg, pcfg = (get_arch("yi-9b").reduced(dtype="float32"),
                  port_arch("yi-9b").reduced(dtype="float32"))
    assert not pcfg.frontend_stub and not jcfg.frontend_stub
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    emb = np.random.default_rng(3).standard_normal((2, 5, 64), np.float32)
    with pytest.raises(AssertionError):
        jlm.forward_prefill(jp, jnp.asarray(emb), jcfg, POLICY,
                            jlm.init_cache(jcfg, 2, 8))
    with pytest.raises(ValueError, match="frontend_stub"):
        lm.forward_prefill(pp, torch.from_numpy(emb), pcfg, "auto",
                           lm.init_cache(pcfg, 2, 8, device="cpu"))
    cache = lm.init_cache(pcfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="frontend_stub"):
        lm.forward_decode(pp, torch.from_numpy(emb[:, :1]), pcfg, "auto",
                          cache)
    tokens = np.random.default_rng(4).integers(0, 256, (2, 5), np.int32)
    jlog, _ = jlm.forward_prefill(jp, jnp.asarray(tokens), jcfg, POLICY,
                                  jlm.init_cache(jcfg, 2, 8))
    plog, _ = lm.forward_prefill(pp, torch.from_numpy(tokens), pcfg, "auto",
                                 cache)
    _close(plog, jlog)


@pytest.mark.parametrize("paged", [False, True])
def test_launch_serve_cli_on_cpu(capsys, paged):
    argv = ["--arch", NAME, "--requests", "3", "--capacity", "2",
            "--new-tokens", "4", "--max-len", "32", "--device", "cpu"]
    report = launch_serve.main(argv + (["--paged"] if paged else []))
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 4 for r in report.requests)
    out = capsys.readouterr().out
    assert "tok/s" in out and (("pages: peak" in out) == paged)
