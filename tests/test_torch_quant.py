"""The port's int8 serving path against the JAX package's, from the same
weights.

Two modes, as in JAX: weight-only (the default policy on a tree that
``quantize_weights_int8`` made: the gemm op dequantizes each ``WeightQ``)
and W8A8 (the lossy ``gemm`` backend ``int8``, JAX's ``gemm/pallas_int8``:
activations quantized per row, int32 products). Inputs come from numpy
seeds; JAX's Pallas kernels run in interpret mode.

Tolerances: the quantizers and the integer GEMM are exact, so they agree
bitwise; the activation's own rounding (an ``exp``) may move silu / gelu
by one bf16 ulp. Whole models compare at fp32 with ``TOL`` as in
``test_torch_model.py``: integer products are exact, the rest differs in
XLA's and PyTorch's summation orders only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, AccelConfig, RunConfig, get_arch
from repro.kernels.gemm import ops as jops
from repro.kernels.gemm import ref as jref
from repro.models import lm as jlm
from repro.serve import quantize as jquant
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import RunConfig as PortRun
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import xaif
from repro_torch.kernels.gemm import ops as gm
from repro_torch.kernels.gemm.ref import (gemm_ref, gemm_w8a8_ref,
                                          quantize_int8)
from repro_torch.models import lm
from repro_torch.serve import quantize as quant
from repro_torch.serve.engine import SlotEngine, SpecConfig, generate
from repro_torch.serve.scheduler import Request, serve

TOL = 1e-4
W8A8 = xaif.Policy({"gemm": "int8"}, allow_lossy=True)
JAX_POLICY = {"weight-only": AccelConfig(),
              "w8a8": AccelConfig(backends={"gemm": "pallas_int8"})}
PORT_POLICY = {"weight-only": "auto", "w8a8": W8A8}
BF16_ULP = 2.0 ** -7


def _np(t):
    return t.float().numpy()


def _quantized(arch="yi-9b", dtype="float32", seed=0):
    """(JAX config, port config, JAX quantized params, port params loaded
    from them)."""
    jcfg = get_arch(arch).reduced(dtype=dtype)
    pcfg = port_arch(arch).reduced(dtype=dtype)
    jq = jquant.quantize_weights_int8(
        jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return jcfg, pcfg, jq, params_from_jax(jax.device_get(jq), device="cpu")


def _paths(tree, prefix=()):
    """{path: WeightQ} of every quantized leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "q"):
        items = enumerate(tree)
    else:
        return {prefix: tree} if hasattr(tree, "q") else {}
    out = {}
    for k, v in items:
        out.update(_paths(v, prefix + (k,)))
    return out


# ----- the quantizers --------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b",
                                  "jamba-v0.1-52b"])
def test_quantize_weights_matches_jax(arch):
    """The port's quantizer on the same bf16 weights gives JAX's q and
    scale bitwise, at the same paths (MLA's w_dkv and Mamba's in_proj /
    out_proj too)."""
    jcfg = get_arch(arch).reduced()
    jp = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    want = _paths(jax.device_get(jquant.quantize_weights_int8(jp)))
    got = _paths(quant.quantize_weights_int8(
        params_from_jax(jax.device_get(jp), device="cpu")))
    assert set(got) == set(want) and len(got) > 0
    for path, w in want.items():
        assert got[path].q.dtype == torch.int8, path
        assert got[path].scale.dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(w.scale))
    names = {p[-1] for p in got}
    assert names <= quant._QUANT_NAMES


def test_quantize_leaf_stacked_equals_whole():
    """A stacked [L, K, N] leaf quantized layer by layer equals the one
    quantization along axis -2."""
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 40, 24)).astype(np.float32))
    got = quant.quantize_leaf(w)
    q, s = quantize_int8(w, dim=-2)
    assert torch.equal(got.q, q) and torch.equal(got.scale, s)
    assert got.scale.shape == (3, 1, 24)


@pytest.mark.parametrize("dim", [-1, 0])
def test_quantize_int8_matches_jax(dim):
    """Per row (activations) and per column (unquantized weights), with
    exact .5 ties that round half to even, and an all-zero row."""
    x = np.random.default_rng(5).normal(size=(6, 40)).astype(np.float32)
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]         # scale 1: ties
    x[:, 0] = 127.0
    x[1] = 0.0
    q, s = quantize_int8(torch.from_numpy(x), dim=dim)
    jq, js = jref.quantize_int8(jnp.asarray(x), axis=dim)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if dim == -1:
        assert q[0, :4].tolist() == [127, 2, -4, 0]


@pytest.mark.parametrize("dim", [-1, 0])
def test_quantize_int8_divides_as_jax_writes_it(dim):
    """On random rows (no forced 127), where the quotient max(amax, 1e-8)
    / 127 and the product with fl(1/127) give different scales in some
    rows, the port follows ``quantize_int8`` as JAX writes it (a division,
    as JAX computes it op by op) bitwise. Under ``jax.jit`` XLA may turn
    the division by the constant into that product: the jitted scales may
    then differ from the port's, and only in those rows."""
    x = np.random.default_rng(8).normal(size=(512, 96)).astype(np.float32)
    x *= np.random.default_rng(9).uniform(0.01, 10.0, size=(512, 1)
                                          ).astype(np.float32)
    if dim == 0:
        x = np.ascontiguousarray(x.T)
    q, s = quantize_int8(torch.from_numpy(x), dim=dim)
    jq, js = jref.quantize_int8(jnp.asarray(x), axis=dim)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    amax = np.maximum(np.abs(x).max(axis=dim, keepdims=True),
                      np.float32(1e-8))
    moved = amax / np.float32(127) != amax * (np.float32(1) / np.float32(127))
    assert moved.any()          # the data tells the two roundings apart
    tq, ts = jax.jit(lambda a: jref.quantize_int8(a, axis=dim))(
        jnp.asarray(x))
    differs = s.numpy() != np.asarray(ts)
    assert not (differs & ~moved).any()
    kept = np.broadcast_to(~moved, x.shape)
    np.testing.assert_array_equal(q.numpy()[kept], np.asarray(tq)[kept])


# ----- the GEMMs -------------------------------------------------------------


CASES = {   # (M, K, N, dtype): aligned fp32 out, ragged bf16 out
    "aligned": (8, 64, 48, np.float32),
    "ragged": (5, 40, 24, "bfloat16"),
}


def _gemm_inputs(case, with_bias, seed=6):
    m, k, n, dtype = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else dtype)
    px = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return jx, px, w, b


def _assert_within(got, want, activation):
    """Bitwise for none / relu; within one bf16 ulp of the value for the
    activations that call exp / tanh."""
    if activation in ("none", "relu"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("prequantized", [True, False])
@pytest.mark.parametrize("activation", ["none", "relu", "silu", "gelu"])
def test_gemm_int8_plain_matches_jax_interpret(activation, prequantized,
                                               with_bias, case):
    jx, px, w, b = _gemm_inputs(case, with_bias)
    if prequantized:
        jw = jquant.quantize_leaf(jnp.asarray(w))
        pw = quant.quantize_leaf(torch.from_numpy(w))
    else:
        jw, pw = jnp.asarray(w), torch.from_numpy(w)
    jb = None if b is None else jnp.asarray(b)
    pb = None if b is None else torch.from_numpy(b)
    want = jops.gemm_int8_pallas_op(jx, jw, jb, activation, interpret=True)
    got = gemm_w8a8_ref(px, pw, pb, activation)
    assert str(got.dtype).endswith(str(want.dtype))
    _assert_within(_np(got), np.asarray(want, np.float32), activation)
    # the xaif op on CPU tensors under the W8A8 policy is this plain version
    assert torch.equal(xaif.call("gemm", W8A8, px, pw, bias=pb,
                                 activation=activation), got)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("activation", ["none", "silu"])
def test_gemm_on_weightq_matches_jax(backend, activation):
    """Weight-only: the plain gemm dequantizes a WeightQ as the JAX ref and
    Pallas backends do (fp32: summation order only)."""
    jx, px, w, b = _gemm_inputs("aligned", True, seed=7)
    jw = jquant.quantize_leaf(jnp.asarray(w))
    pw = quant.quantize_leaf(torch.from_numpy(w))
    jb, pb = jnp.asarray(b), torch.from_numpy(b)
    if backend == "ref":
        want = jops.gemm_ref_op(jx, jw, jb, activation)
    else:
        want = jops.gemm_pallas_op(jx, jw, jb, activation, interpret=True)
    got = gemm_ref(px, pw, pb, activation)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        _np(quant.dequantize(pw, torch.float32)),
        np.asarray(jquant.dequantize(jw, jnp.float32)))


def test_int8_gemm_rows_independent_of_the_batch():
    """Integer sums are exact and activations are quantized per row, so a
    row's W8A8 output never depends on the rows beside it."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32)).to(
        torch.bfloat16)
    w = quant.quantize_leaf(torch.from_numpy(
        rng.normal(size=(64, 32)).astype(np.float32)))
    whole = gemm_w8a8_ref(x, w, activation="silu")
    for i in range(4):
        assert torch.equal(gemm_w8a8_ref(x[i:i + 1], w, activation="silu"),
                           whole[i:i + 1])


# ----- dispatch --------------------------------------------------------------


def test_auto_and_ref_never_select_int8(monkeypatch):
    """Neither "auto" nor "ref" reaches the lossy backend: the default
    gemm on a WeightQ is the dequantizing one."""
    called = []
    e = xaif.entry("gemm", "int8")
    monkeypatch.setitem(xaif._NAMED, ("gemm", "int8"), xaif.OpEntry(
        "gemm", lambda *a, **k: called.append(1), e.kernel, True))
    x = torch.randn(3, 64)
    w = quant.quantize_leaf(torch.randn(64, 16))
    for policy in ("auto", "ref", xaif.Policy()):
        out = xaif.call("gemm", policy, x, w)
        assert torch.equal(out, gemm_ref(x, w))
    assert not called
    xaif.call("gemm", W8A8, x, w)
    assert called == [1]


def test_lossy_backend_needs_an_explicit_opt_in():
    with pytest.raises(ValueError, match="lossy"):
        xaif.Policy({"gemm": "int8"})
    with pytest.raises(ValueError, match="no backend"):
        xaif.Policy({"gemm": "int4"}, allow_lossy=True)
    with pytest.raises(ValueError, match="unknown mode"):
        xaif.Policy(mode="fast")
    with pytest.raises(ValueError, match="unknown policy"):
        xaif.call("gemm", "int8", torch.zeros(1, 4), torch.zeros(4, 2))
    assert W8A8.backend_for("gemm") == "int8"
    assert W8A8.backend_for("rmsnorm") == "default"
    assert W8A8 == xaif.Policy({"gemm": "int8"}, allow_lossy=True)
    assert hash(W8A8) == hash(xaif.Policy({"gemm": "int8"},
                                          allow_lossy=True))


def test_cpu_tensors_run_the_plain_int8_version_and_count_no_launch():
    before = xaif.launch_counts()
    assert {"gemm_int8", "gemm_wq"} <= set(before)
    x = torch.randn(2, 3, 64)
    w = quant.quantize_leaf(torch.randn(64, 16))
    out = xaif.call("gemm", W8A8, x, w, activation="relu")
    assert out.shape == (2, 3, 16)
    assert torch.equal(out, gemm_w8a8_ref(x, w, activation="relu"))
    ref = xaif.call("gemm", xaif.Policy({"gemm": "int8"}, allow_lossy=True,
                                        mode="ref"), x, w, activation="relu")
    assert torch.equal(ref, out)
    assert xaif.launch_counts() == before


@pytest.mark.parametrize("fn", ["gemm_int8", "gemm_weightq"])
def test_int8_kernels_raise_on_cpu_tensors(fn):
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = quant.quantize_leaf(torch.randn(64, 16))
    before = dict(xaif.launch_counts())
    with pytest.raises(ValueError, match="CUDA kernel got a tensor"):
        if fn == "gemm_int8":
            gm.gemm_int8(x, w)
        else:
            gm.gemm(x, w)
    assert xaif.launch_counts() == before


# ----- the repairs: loading and slicing quantized trees ---------------------


def test_params_from_jax_carries_weightq():
    """A JAX WeightQ comes out as the port's WeightQ (int8 q, fp32 scale);
    every other tuple stays a tuple."""
    jcfg, pcfg, jq, pp = _quantized(dtype="bfloat16")
    wq = pp["slots"][0]["mixer"]["wq"]
    assert isinstance(wq, quant.WeightQ)
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    assert wq.q.shape == (jcfg.num_superblocks, jcfg.d_model,
                          jcfg.num_heads * jcfg.head_dim)
    assert isinstance(pp["unembed"], quant.WeightQ)
    assert type(pp["slots"]) is tuple and type(pp["exits"]) is tuple
    assert not isinstance(pp["slots"][0]["ln1"]["scale"], tuple)
    assert pp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.q.numpy(), np.asarray(jq["slots"][0]["mixer"]["wq"].q))


def test_layer_slices_q_and_scale_together():
    """Layer i of a quantized stack gets row sb of q [L, K, N] and of
    scale [L, 1, N], both, as a WeightQ."""
    _, pcfg, _, pp = _quantized()
    assert pcfg.num_superblocks >= 2
    stack = pp["slots"][0]["ffn"]["w_gate"]
    for i in range(pcfg.num_layers):
        w = lm._layer(pp, pcfg, i)["ffn"]["w_gate"]
        assert isinstance(w, quant.WeightQ)
        assert w.q.shape == stack.q.shape[1:]
        assert w.scale.shape == (1, stack.q.shape[-1])
        assert torch.equal(w.q, stack.q[i]) and torch.equal(
            w.scale, stack.scale[i])
    moved = lm._map(pp["slots"][0], lambda t: t[:1])
    assert isinstance(moved["mixer"]["wo"], quant.WeightQ)
    assert moved["mixer"]["wo"].scale.shape[0] == 1
    assert len(lm._leaves(pp)) == len(jax.tree_util.tree_leaves(pp))


# ----- the reduced model against JAX ----------------------------------------


@pytest.mark.parametrize("mode", ["weight-only", "w8a8"])
def test_prefill_and_decode_match_jax(mode):
    """Prefill, then 8 teacher-forced decode steps from the same quantized
    params: final and exit logits within TOL at every step."""
    jcfg, pcfg, jq, pp = _quantized()
    jpol, ppol = JAX_POLICY[mode], PORT_POLICY[mode]
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 256, (3, 7), np.int32)
    feed = rng.integers(0, 256, (8, 3), np.int32)
    jlog, jc = jlm.forward_prefill(jq, jnp.asarray(prompt), jcfg, jpol,
                                   jlm.init_cache(jcfg, 3, 16))
    plog, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg, ppol,
                                  lm.init_cache(pcfg, 3, 16, device="cpu"))
    np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    for step in range(8):
        tok = feed[step][:, None]
        jlog, jex, jc = jlm.forward_decode(jq, jnp.asarray(tok), jcfg, jpol,
                                           jc)
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(tok), pcfg,
                                          ppol, pc)
        np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(pex[0]), np.asarray(jex[0]),
                                   rtol=TOL, atol=TOL)


def test_weight_only_is_the_model_on_dequantized_weights():
    """The default policy on a quantized tree computes the model on the
    dequantized weights: the same logits as an unquantized tree holding
    dequantize(w) in each quantized place."""
    _, pcfg, _, pp = _quantized()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, quant.WeightQ):
            return quant.dequantize(node, torch.float32)
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    deq = walk(pp)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (2, 6), np.int32))
    a, _ = lm.forward_prefill(pp, tokens, pcfg, "auto",
                              lm.init_cache(pcfg, 2, 8, device="cpu"))
    b, _ = lm.forward_prefill(deq, tokens, pcfg, "auto",
                              lm.init_cache(pcfg, 2, 8, device="cpu"))
    assert torch.equal(a, b)


PROMPTS = [[5, 17, 200, 3, 90], [1, 2, 3, 4, 5, 6, 7, 8, 9],
           [255, 0, 128, 64, 32, 16, 8, 4, 2, 1, 77, 13]]


@pytest.mark.parametrize("mode", ["weight-only", "w8a8"])
def test_greedy_tokens_match_jax_and_engine_matches_generate(mode):
    """Greedy tokens of the port's ``generate`` == JAX ``generate`` at
    fp32 on each prompt, and the port's ``SlotEngine`` + ``serve()`` (2
    slots for 3 requests: backfill) == the port's ``generate``."""
    jcfg, pcfg, jq, pp = _quantized()
    jrun = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                     accel=JAX_POLICY[mode])
    prun = PortRun(arch=pcfg, policy=PORT_POLICY[mode])
    solo = []
    for prompt in PROMPTS:
        p = np.asarray([prompt], np.int32)
        jtok, _ = jax_generate(jrun, jq, jnp.asarray(p), 8)
        ptok, _ = generate(prun, pp, p, 8, device="cpu")
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
        solo.append(ptok[0].tolist())
    reqs = [Request(i, np.asarray(p, np.int32), 8)
            for i, p in enumerate(PROMPTS)]
    engine = SlotEngine(prun, capacity=2, max_len=32, chunk=4, device="cpu")
    report = serve(engine, pp, reqs)
    assert report.completion_rate == 1.0
    assert [r.tokens for r in reqs] == solo


@pytest.mark.parametrize("mode", ["weight-only", "w8a8"])
def test_quantized_paged_engine_matches_contiguous(mode):
    """The paged engine on a quantized tree gives the contiguous engine's
    tokens."""
    _, pcfg, _, pp = _quantized()
    pcfg = dataclasses.replace(pcfg, early_exit=None)
    toks = {}
    for paged in (False, True):
        reqs = [Request(i, np.asarray(p, np.int32), 6)
                for i, p in enumerate(PROMPTS)]
        kw = dict(paged=True, page_size=4, num_pages=12) if paged else {}
        serve(SlotEngine(PortRun(pcfg, policy=PORT_POLICY[mode]),
                         capacity=2, max_len=32, chunk=4, device="cpu", **kw),
              pp, reqs)
        toks[paged] = [r.tokens for r in reqs]
    assert toks[True] == toks[False]
    assert all(len(t) == 6 for t in toks[True])


@pytest.mark.parametrize("mode", ["weight-only", "w8a8"])
def test_quantized_tied_spec_matches_greedy(mode):
    """Greedy speculative decoding with a tied draft (``share_params``:
    the draft reads the target's quantized tree) gives plain greedy's
    tokens on the same quantized tree, every proposal accepted."""
    _, pcfg, _, pp = _quantized()
    pcfg = dataclasses.replace(pcfg, early_exit=None)
    run = PortRun(pcfg, policy=PORT_POLICY[mode])
    toks = {}
    for spec in (None, SpecConfig(draft_arch=pcfg, k=3, share_params=True)):
        reqs = [Request(i, np.asarray(p, np.int32), 6)
                for i, p in enumerate(PROMPTS)]
        report = serve(SlotEngine(run, capacity=2, max_len=32, chunk=2,
                                  device="cpu", paged=True, page_size=4,
                                  num_pages=16, spec=spec), pp, reqs)
        toks[spec is None] = [r.tokens for r in reqs]
    assert toks[False] == toks[True]
    assert report.stats["spec_acceptance"] == 1.0
