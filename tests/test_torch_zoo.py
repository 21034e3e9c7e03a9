"""The port's remaining zoo archs against the JAX package's, from the same
weights: chatglm3-6b, qwen1.5-32b, qwen3-moe-30b-a3b, chameleon-34b and
mistral-large-123b.

Each runs ``get_arch(name).reduced(**overrides)`` on both sides, in fp32,
with overrides that keep what sets the arch apart: chatglm3 a group of 2
and rotary over half the head dims, with QKV biases; qwen1.5 4 query heads
over 4 KV heads (group 1), with QKV biases; qwen3 128 experts cut to 4, a
QK-norm, and ``head_dim=32`` (so hq * dh = 128 is not d_model = 64);
chameleon a QK-norm and frame embeddings [B, T, d] taken in place of token
ids (its tokenizer is a stub); mistral 6 query heads over 2 (a group of 3,
not a power of two). The JAX ``init_lm`` tree zeroes the QKV biases and
sets every norm scale to 1, which would hide a missing bias or scale: the
biases and every ``scale`` leaf (layer norms, QK-norms, exit heads) are
replaced with numpy draws from a seed before both sides load the tree
(``params_from_jax``). Tolerance 1e-4 on logits of magnitude ~1: both
sides run in fp32 and differ only in summation order.
"""
import dataclasses
import importlib.util
from pathlib import Path

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
from repro_torch.core import xaif
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.scheduler import Request, serve

TOL = 1e-4
POLICY = AccelConfig()            # the JAX package's all-ref policy
ROOT = Path(__file__).resolve().parents[1]
REDUCED = {
    "chatglm3-6b": {},
    "qwen1.5-32b": dict(num_kv_heads=4),
    "qwen3-moe-30b-a3b": dict(head_dim=32),
    "chameleon-34b": {},
    "mistral-large-123b": dict(num_heads=6, num_kv_heads=2),
}
ARCHS = sorted(REDUCED)
# Parameters (billions) of each full-width config at the depth the card
# serves, as ``lm.init_lm`` lays them out (embed and unembed apart)
PARAMS_B = {"chatglm3-6b": 6.24, "qwen1.5-32b": 35.20,
            "qwen3-moe-30b-a3b": 30.53, "chameleon-34b": 34.29,
            "mistral-large-123b": 34.02}


def _configs(name):
    kw = dict(REDUCED[name], dtype="float32")
    return get_arch(name).reduced(**kw), port_arch(name).reduced(**kw)


def _perturb(tree, rng):
    """The JAX tree (numpy leaves) with the QKV biases and every norm
    ``scale`` replaced by seeded draws: biases N(0, 0.5^2), scales 1 +
    U(-0.5, 0.5)."""
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
    """name -> (JAX config, port config, JAX params, port params), built
    on first use."""
    built = {}

    def get(name):
        if name not in built:
            jcfg, pcfg = _configs(name)
            host = jax.device_get(jlm.init_lm(jax.random.PRNGKey(0), jcfg))
            host = _perturb(host, np.random.default_rng(
                ARCHS.index(name) + 10))
            jp = jax.tree_util.tree_map(jnp.asarray, host)
            built[name] = (jcfg, pcfg, jp, params_from_jax(host, device="cpu"))
        return built[name]
    return get


def _np(t):
    return t.float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_the_jax_package(name):
    for jcfg, pcfg in (_configs(name), (get_arch(name), port_arch(name))):
        for f in ("family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "rope",
                  "rope_theta", "rope_partial_pct", "qkv_bias", "qk_norm",
                  "frontend_stub", "first_k_dense", "dtype", "norm_eps"):
            assert getattr(jcfg, f) == getattr(pcfg, f), (name, f)
        assert jcfg.early_exit == jcfg.early_exit.__class__(
            **dataclasses.asdict(pcfg.early_exit))
        assert (jcfg.moe is None) == (pcfg.moe is None)
        if pcfg.moe is not None:
            assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(
                pcfg.moe)
        assert [(b.mixer, b.ffn) for b in jcfg.block_pattern] == [
            (b.mixer, b.ffn) for b in pcfg.block_pattern]
    jcfg, pcfg = _configs(name)
    assert lm._segments(pcfg) == jlm._segments(jcfg)


def test_the_reduced_configs_keep_what_sets_each_arch_apart():
    c = {n: _configs(n)[1] for n in ARCHS}
    group = {n: cfg.num_heads // cfg.num_kv_heads for n, cfg in c.items()}
    assert group == {"chatglm3-6b": 2, "qwen1.5-32b": 1,
                     "qwen3-moe-30b-a3b": 2, "chameleon-34b": 2,
                     "mistral-large-123b": 3}
    assert c["chatglm3-6b"].rope == "partial" and c["chatglm3-6b"].qkv_bias
    assert c["qwen1.5-32b"].qkv_bias
    q3 = c["qwen3-moe-30b-a3b"]
    assert q3.qk_norm and q3.num_heads * q3.head_dim != q3.d_model
    assert q3.moe.num_shared_experts == 0 and q3.first_k_dense == 0
    assert c["chameleon-34b"].qk_norm and c["chameleon-34b"].frontend_stub
    assert c["chameleon-34b"].family == "vlm"


@pytest.mark.parametrize("name", ARCHS)
def test_params_from_jax_is_copy_only(worlds, name):
    _, pcfg, jp, pp = worlds(name)
    jl = jax.tree_util.tree_leaves(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves(pp)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))
    mixer = pp["slots"][0]["mixer"]
    assert ("q_norm" in mixer) == ("k_norm" in mixer) == pcfg.qk_norm
    assert ("bq" in mixer) == pcfg.qkv_bias
    # the perturbation reached the leaves that init leaves at 0 / 1
    assert not torch.all(pp["final_norm"]["scale"] == 1)
    if pcfg.qkv_bias:
        assert mixer["bq"].abs().min() > 0
    if pcfg.qk_norm:
        assert not torch.all(mixer["k_norm"]["scale"] == 1)


def _inputs(pcfg, rng, embeddings):
    if embeddings:
        return (rng.standard_normal((3, 6, pcfg.d_model), np.float32),
                rng.standard_normal((2, 3, 1, pcfg.d_model), np.float32))
    return (rng.integers(0, pcfg.vocab_size, (3, 6), np.int32),
            rng.integers(0, pcfg.vocab_size, (2, 3, 1), np.int32))


CASES = [(n, False) for n in ARCHS] + [("chameleon-34b", True)]


@pytest.mark.parametrize("name,embeddings", CASES)
def test_prefill_decode_and_verify_logits_match(worlds, name, embeddings):
    """Prefill 3 sequences of 6, then 2 teacher-forced decode steps (final
    and exit logits at each), then one verify of 3 tokens: every logit
    within 1e-4 of JAX's. Chameleon also from frame embeddings."""
    jcfg, pcfg, jp, pp = worlds(name)
    rng = np.random.default_rng(2)
    prompt, feed = _inputs(pcfg, rng, embeddings)
    jlog, jc = jlm.forward_prefill(jp, jnp.asarray(prompt), jcfg, POLICY,
                                   jlm.init_cache(jcfg, 3, 16))
    plog, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg, "auto",
                                  lm.init_cache(pcfg, 3, 16, device="cpu"))
    _close(plog, jlog)
    _close(pc.k, jc.slots[0].k)
    for step in range(feed.shape[0]):
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(feed[step]), jcfg,
                                           POLICY, jc)
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(feed[step]),
                                          pcfg, "auto", pc)
        _close(plog, jlog)
        assert len(pex) == len(jex) == 1
        _close(pex[0], jex[0])
    np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    ver = rng.integers(0, pcfg.vocab_size, (3, 3), np.int32)
    jlog, _ = jlm.forward_verify(jp, jnp.asarray(ver), jcfg, POLICY, jc)
    plog, _ = lm.forward_verify(pp, torch.from_numpy(ver), pcfg, "auto", pc)
    _close(plog, jlog)


ENGINE_PROMPTS = [np.random.default_rng(5).integers(0, 256, (n,), np.int32)
                  for n in (3, 11, 14)]


@pytest.fixture(scope="module")
def jax_tokens(worlds):
    """name -> JAX's ``generate`` (5 new tokens) on each prompt."""
    done = {}

    def get(name):
        if name not in done:
            jcfg, _, jp, _ = worlds(name)
            run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                            accel=POLICY)
            done[name] = [np.asarray(jax_generate(
                run, jp, jnp.asarray(p[None]), 5)[0])[0].tolist()
                for p in ENGINE_PROMPTS]
        return done[name]
    return get


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_engines_match_jax_generate(worlds, jax_tokens, name, paged):
    """3 requests through 2 slots (backfill), contiguous or paged (pages of
    4 from a pool smaller than the slots could ask for): each request's
    tokens equal JAX's ``generate`` on its prompt."""
    _, pcfg, _, pp = worlds(name)
    want = jax_tokens(name)
    requests = [Request(rid=i, prompt=p, max_new_tokens=5)
                for i, p in enumerate(ENGINE_PROMPTS)]
    kw = dict(paged=True, page_size=4, num_pages=10) if paged else {}
    engine = SlotEngine(pcfg, capacity=2, max_len=32, chunk=4, device="cpu",
                        **kw)
    report = serve(engine, pp, requests)
    assert report.completion_rate == 1.0
    if paged:
        assert report.stats["peak_pages"] <= 9
    for r, w in zip(requests, want):
        assert r.tokens == w, (name, r.rid)


@pytest.mark.parametrize("mode", ["contiguous", "paged", "draft"])
@pytest.mark.parametrize("name", ARCHS)
def test_launch_serve_cli_on_cpu(capsys, name, mode):
    argv = ["--arch", name, "--requests", "3", "--capacity", "2",
            "--new-tokens", "4", "--max-len", "32", "--prompt-len-max", "12",
            "--device", "cpu"]
    extra = {"contiguous": [], "paged": ["--paged"],
             "draft": ["--paged", "--draft", name, "--spec-k", "3"]}[mode]
    report = launch_serve.main(argv + extra)
    assert report.completion_rate == 1.0
    assert all(len(r.tokens) == 4 for r in report.requests)
    out = capsys.readouterr().out
    assert f"arch={name}" in out and "tok/s" in out
    assert ("pages: peak" in out) == (mode != "contiguous")
    assert ("spec decode: k=3" in out) == (mode == "draft")


@pytest.mark.parametrize("name", ARCHS)
def test_rmsnorm_operands_are_contiguous(monkeypatch, name):
    """The card's rmsnorm wrapper refuses a non-contiguous tensor (the CPU's
    plain version takes any): every rmsnorm operand on the prefill,
    decode, paged decode, verify and paged verify paths is contiguous, and
    a decode step runs 2 per layer plus the final norm and the exit head's,
    2 more per layer with a QK-norm (q and k, rows of the head dim)."""
    _, pcfg = _configs(name)
    params = lm.init_lm(pcfg, seed=0, device="cpu")
    seen = []
    real = xaif.call

    def call(op, policy, *args, **kw):
        if op == "rmsnorm":
            seen.append((tuple(args[0].shape), args[0].is_contiguous()))
        return real(op, policy, *args, **kw)

    monkeypatch.setattr(xaif, "call", call)
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, 256, (2, 5), np.int32))
    step = torch.from_numpy(rng.integers(0, 256, (2, 1), np.int32))
    ver = torch.from_numpy(rng.integers(0, 256, (2, 3), np.int32))
    nl, dh = pcfg.num_layers, pcfg.head_dim
    per_layer = 4 if pcfg.qk_norm else 2
    _, cache = lm.forward_prefill(params, tok, pcfg, "auto",
                                  lm.init_cache(pcfg, 2, 16, device="cpu"))
    assert len(seen) == per_layer * nl + 1
    lm.forward_decode(params, step, pcfg, "auto", cache)
    assert len(seen) == 2 * per_layer * nl + 3
    lm.forward_verify(params, ver, pcfg, "auto", cache)
    paged = lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")
    paged.page_table[:] = torch.arange(1, 9, dtype=torch.int32).view(2, 4)
    paged = paged._replace(pos=torch.tensor([5, 2], dtype=torch.int32))
    lm.forward_decode(params, step, pcfg, "auto", paged)
    lm.forward_verify(params, ver, pcfg, "auto", paged)
    assert all(ok for _, ok in seen), [s for s in seen if not s[1]]
    # q and k of every layer on the five paths
    qk = [s for s, _ in seen if s[-1] == dh]
    assert len(qk) == (2 * nl * 5 if pcfg.qk_norm else 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ARCHS)
def test_full_configs_fit_the_card(name):
    """At the depth ``chip_smoke.py`` serves (``ZOO_LAYERS``), the full-width
    bf16 tree (laid out on the meta device: nothing allocated) holds the
    parameters counted for it, within 1%, in under 70 GiB of the H100's 80
    GB."""
    depth = _chip_smoke().ZOO_LAYERS[name]
    cfg = dataclasses.replace(port_arch(name), num_layers=depth)
    leaves = lm._leaves(lm.init_lm(cfg, device="meta"))
    n = sum(t.numel() for t in leaves)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    assert n / 1e9 == pytest.approx(PARAMS_B[name], rel=0.01)
    assert nbytes < 70 * 2 ** 30
