"""The port's Mamba path and the reduced jamba-v0.1-52b against the JAX
package's, from the same seeded numpy inputs and the same parameters.

The reduced Jamba: d_model 64, 16 layers (two super-blocks of M M M M A M
M M, MoE on the odd layers), d_state 8, exit after layer 8.

Tolerances:
  * 1e-5 for the ops at fp32 (``ssm_scan``, ``ssm_decode``, the conv):
    both sides compute in fp32 from the same inputs and differ only in the
    order of the sum over the state and in exp's last bit; in bf16 the
    scan's y is held to one bf16 step (2^-8 relative, rtol = atol = 1e-2)
    and its fp32 state to 1e-5;
  * 1e-4 for the Mamba mixer and the model at fp32, as in
    ``test_torch_model.py``: the projections go through XLA's and
    PyTorch's CPU matmuls;
  * 1e-4 between a prefill of T tokens followed by decode steps and one
    prefill of the longer sequence (the scan and the step recurrence are
    the same arithmetic in another order of operations; the MoE's capacity
    is raised so that the prefill drops no token);
  * greedy tokens at fp32 must be equal; the slot engine's tokens must
    equal ``generate``'s exactly; a scan of T1 then T2 tokens with the
    state carried must equal the scan of T1 + T2 bitwise.

Recurrent archs compile one JAX trace per prompt length, so the file uses
few lengths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (SHAPES_BY_NAME, AccelConfig, RunConfig,
                                get_arch)
from repro.kernels.ssm_decode import ops as jax_sd_ops
from repro.kernels.ssm_decode import ref as jax_sd_ref
from repro.kernels.ssm_scan import ops as jax_ss_ops
from repro.kernels.ssm_scan import ref as jax_ss_ref
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.models import mamba
from repro_torch.models.layers import apply_conv1d
from repro_torch.serve.engine import SlotEngine, SpecConfig, generate
from repro_torch.serve.scheduler import Request, serve

POLICY = AccelConfig()            # the JAX package's all-ref policy
TOL = 1e-4
TOL_OP = 1e-5
ARCH = "jamba-v0.1-52b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are thousands of small ops: one intra-op
    thread each (restored after the module). Under the suite's parallel
    workers, threads that wait for a core slow such runs tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32"):
    return (get_arch(ARCH).reduced(dtype=dtype),
            port_arch(ARCH).reduced(dtype=dtype))


def _params(jcfg, seed=0):
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(t):
    return t.float().numpy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_the_jax_package():
    for jcfg, pcfg in (_configs(), (get_arch(ARCH), port_arch(ARCH))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope", "dtype",
                  "norm_eps", "first_k_dense", "family", "period"):
            assert getattr(jcfg, f) == getattr(pcfg, f), f
        assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(pcfg.moe)
        assert dataclasses.asdict(jcfg.mamba) == \
            dataclasses.asdict(pcfg.mamba)
        assert jcfg.early_exit.exit_layers == pcfg.early_exit.exit_layers
        for i in range(jcfg.num_layers):
            assert (jcfg.layer_spec(i).mixer, jcfg.layer_spec(i).ffn) == \
                (pcfg.layer_spec(i).mixer, pcfg.layer_spec(i).ffn)
        assert lm._segments(pcfg) == jlm._segments(jcfg)
    _, pcfg = _configs()
    assert pcfg.mamba.d_state == 8 and pcfg.recurrent
    assert [s.mixer for s in pcfg.block_pattern] == ["mamba"] * 4 + \
        ["attn"] + ["mamba"] * 3
    assert not port_arch("yi-9b").recurrent
    with pytest.raises(ValueError, match="super-block boundary"):
        lm._segments(dataclasses.replace(pcfg, early_exit=dataclasses.replace(
            pcfg.early_exit, exit_layers=(5,))))


@pytest.mark.parametrize("num_layers,n_params", [(32, 51.57e9),
                                                 (16, 26.05e9)])
def test_full_size_parameter_shapes_match_jax(num_layers, n_params):
    """The full-width tree's shapes and dtypes equal ``jax.eval_shape`` of
    the JAX ``init_lm``, with nothing allocated on either side (the port
    builds it on the meta device): the registered 32 layers, and the
    16-layer cut (two super-blocks) the card serves."""
    jcfg = dataclasses.replace(get_arch(ARCH), num_layers=num_layers)
    pcfg = dataclasses.replace(port_arch(ARCH), num_layers=num_layers)
    want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg),
                          jax.random.PRNGKey(0))
    got = lm.init_lm(pcfg, device="meta")
    jl = jax.tree_util.tree_leaves_with_path(want)
    pl = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in pl]
    for (path, a), (_, b) in zip(jl, pl):
        assert tuple(a.shape) == tuple(b.shape), jax.tree_util.keystr(path)
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
    assert len(got["slots"]) == 8
    assert got["slots"][0]["mixer"]["a_log"].dtype == torch.float32
    assert got["slots"][0]["mixer"]["x_proj"].shape == (num_layers // 8,
                                                        8192, 288)
    n = sum(b.numel() for _, b in pl)
    assert abs(n - n_params) < 0.01e9, n


def test_params_from_jax_carries_the_hybrid_tree():
    jcfg, _ = _configs(dtype="bfloat16")
    jp, pp = _params(jcfg)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves_with_path(pp)
    assert len(jl) == len(pl)
    for (path, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert isinstance(pp["slots"], tuple) and len(pp["slots"]) == 8
    assert set(pp["slots"][0]["mixer"]) == {
        "in_proj", "conv", "x_proj", "dt_proj", "dt_bias", "a_log",
        "d_skip", "out_proj"}
    assert set(pp["slots"][4]["mixer"]) == {"wq", "wk", "wv", "wo"}
    assert "router" in pp["slots"][1]["ffn"]
    assert pp["slots"][0]["mixer"]["in_proj"].dtype == torch.bfloat16


def test_init_mamba_draws_from_the_jax_distributions():
    """S4D-real A, softplus(dt_bias) in [1e-3, 1e-1], d_skip = 1: a wrong A
    makes the recurrence blow up under random weights."""
    _, pcfg = _configs()
    p = mamba.init_mamba(torch.Generator().manual_seed(0), pcfg,
                         torch.float32, "cpu")
    n = pcfg.mamba.d_state
    a_init = np.tile(np.arange(1, n + 1, dtype=np.float32), (128, 1))
    np.testing.assert_allclose(p["a_log"].numpy(), np.log(a_init))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert bool((p["d_skip"] == 1).all())
    assert p["dt_bias"].dtype == p["a_log"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _scan_inputs(rng, b, t, din, n, dtype):
    u = rng.standard_normal((b, t, din)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (b, t, din)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (din, 1))
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    d = rng.standard_normal(din).astype(np.float32)
    h0 = rng.standard_normal((b, din, n)).astype(np.float32)
    jd = jnp.dtype(dtype)
    jx = dict(u=jnp.asarray(u, jd), dt=jnp.asarray(dt, jd), a=jnp.asarray(a),
              b=jnp.asarray(bm, jd), c=jnp.asarray(cm, jd), d=jnp.asarray(d),
              h0=jnp.asarray(h0))
    tx = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype) if k in ("u", "dt", "b", "c") else torch.float32)
        for k, v in jx.items()}
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssm_scan_matches_jax(dtype, with_h0):
    """T = 21 is not a multiple of the Pallas kernel's bt = 8 (its wrapper
    pads T; the port's kernel walks T unpadded)."""
    rng = np.random.default_rng(31)
    jx, tx = _scan_inputs(rng, 2, 21, 24, 8, dtype)
    args = ("u", "dt", "a", "b", "c", "d")
    jh0 = jx["h0"] if with_h0 else None
    y, h = selective_scan_ref(*(tx[k] for k in args),
                              tx["h0"] if with_h0 else None)
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    ytol = TOL_OP if dtype == "float32" else 1e-2
    for wy, wh in (jax_ss_ref.selective_scan_ref(*(jx[k] for k in args), jh0),
                   jax_ss_ops.ssm_pallas_op(*(jx[k] for k in args), jh0,
                                            interpret=True, bt=8, bd=8)):
        np.testing.assert_allclose(_np(y), np.asarray(wy, np.float32),
                                   rtol=ytol, atol=ytol)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), rtol=TOL_OP,
                                   atol=TOL_OP)


def test_ssm_scan_split_equals_whole_bitwise():
    """A scan of T1 then T2 tokens with the state carried == one scan of
    T1 + T2 (chunked prefill rests on it; the card checks the kernel)."""
    rng = np.random.default_rng(32)
    _, tx = _scan_inputs(rng, 2, 13, 16, 8, "float32")
    u, dt, a, b, c, d = (tx[k] for k in ("u", "dt", "a", "b", "c", "d"))
    y, h = selective_scan_ref(u, dt, a, b, c, d, tx["h0"])
    y1, h1 = selective_scan_ref(u[:, :5], dt[:, :5], a, b[:, :5], c[:, :5],
                                d, tx["h0"])
    y2, h2 = selective_scan_ref(u[:, 5:], dt[:, 5:], a, b[:, 5:], c[:, 5:],
                                d, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_mamba_decode_matches_jax():
    rng = np.random.default_rng(33)
    b, din, n = 3, 24, 8
    x = rng.standard_normal((b, din)).astype(np.float32)
    g = rng.uniform(1e-3, 0.1, (b, din)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (din, 1))
    bm = rng.standard_normal((b, n)).astype(np.float32)
    cm = rng.standard_normal((b, n)).astype(np.float32)
    m = rng.standard_normal(din).astype(np.float32)
    h = rng.standard_normal((b, din, n)).astype(np.float32)
    ops = (x, g, a, bm, cm, m, h)
    y, hn = ssm_decode_ref(*map(_t, ops))
    for wy, wh in (jax_sd_ref.mamba_decode_ref(*map(jnp.asarray, ops)),
                   jax_sd_ops.ssm_decode_pallas_op(*map(jnp.asarray, ops),
                                                   interpret=True, bd=8)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=TOL_OP,
                                   atol=TOL_OP)
        np.testing.assert_allclose(hn.numpy(), np.asarray(wh), rtol=TOL_OP,
                                   atol=TOL_OP)
    # one decode step == one scan step from the same state
    ys, hs = selective_scan_ref(_t(x[:, None]), _t(g[:, None]), _t(a),
                                _t(bm[:, None]), _t(cm[:, None]), _t(m),
                                _t(h))
    np.testing.assert_allclose(ys[:, 0].numpy(), y.numpy(), rtol=TOL_OP,
                               atol=TOL_OP)
    np.testing.assert_allclose(hs.numpy(), hn.numpy(), rtol=TOL_OP,
                               atol=TOL_OP)


def test_mlstm_decode_plain_matches_jax():
    """The op's mLSTM mode has a plain version (its kernel waits for the
    xLSTM slice)."""
    rng = np.random.default_rng(34)
    b, hh, dh = 2, 3, 8
    q, k, v = (rng.standard_normal((b, hh, dh)).astype(np.float32)
               for _ in range(3))
    li, lf, m = (rng.standard_normal((b, hh)).astype(np.float32)
                 for _ in range(3))
    c = rng.standard_normal((b, hh, dh, dh)).astype(np.float32)
    nn_ = rng.standard_normal((b, hh, dh)).astype(np.float32)
    ops = (q, k, v, li, lf, m, c, nn_)
    got_h, got_s = ssm_decode_ref(*map(_t, ops))
    want_h, want_s = jax_sd_ref.ssm_decode_ref(*map(jnp.asarray, ops))
    for a_, w_ in zip((got_h,) + got_s, (want_h,) + want_s):
        np.testing.assert_allclose(a_.numpy(), np.asarray(w_), rtol=TOL_OP,
                                   atol=TOL_OP)


def test_conv1d_with_carried_state_matches_jax():
    rng = np.random.default_rng(35)
    key = jax.random.PRNGKey(3)
    jp = jlayers.init_conv1d(key, 12, 4, jnp.float32)
    jp = {"w": jp["w"], "b": jnp.asarray(rng.standard_normal(12), jnp.float32)}
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        wy, ws = jlayers.apply_conv1d(
            jp, jnp.asarray(x), None if state is None else jnp.asarray(state))
        y, s = apply_conv1d(pp, _t(x), None if state is None else _t(state))
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=TOL_OP,
                                   atol=TOL_OP)
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------


def _mixer(jcfg, seed=0):
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def test_apply_mamba_prefill_and_decode_match_jax():
    """Prefill 7 tokens from a zero state, then 4 decode steps; outputs and
    states agree with the JAX mixer."""
    jcfg, pcfg = _configs()
    jp, pp = _mixer(jcfg)
    rng = np.random.default_rng(36)
    b, t = 3, 7
    x = rng.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    jst = jmamba.init_mamba_state(jcfg, b, jnp.float32)
    pst = mamba.MambaState(*(s[0] for s in mamba.init_mamba_state(
        pcfg, b, torch.float32, "cpu", layers=1)))
    jy, jst = jmamba.apply_mamba(jp, jnp.asarray(x), jcfg, POLICY, jst)
    py, pst = mamba.apply_mamba(pp, _t(x), pcfg, "auto", pst)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    for a_, w_ in zip(pst, jst):
        np.testing.assert_allclose(a_.numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)
    for _ in range(4):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jmamba.apply_mamba_decode(jp, jnp.asarray(xt), jcfg, POLICY,
                                            jst)
        py, pst = mamba.apply_mamba_decode(pp, _t(xt), pcfg, "auto", pst)
        assert py.shape == (b, 1, jcfg.d_model)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        for a_, w_ in zip(pst, jst):
            np.testing.assert_allclose(a_.numpy(), np.asarray(w_), rtol=TOL,
                                       atol=TOL)
    # without a state: the same output, no state returned
    jy0, _ = jmamba.apply_mamba(jp, jnp.asarray(x), jcfg, POLICY)
    py0, st0 = mamba.apply_mamba(pp, _t(x), pcfg, "auto")
    assert st0 is None
    np.testing.assert_allclose(py0.numpy(), np.asarray(jy0), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_then_decode_equals_longer_prefill():
    """A prefill of T tokens followed by decode steps gives the logits of
    a prefill of the longer sequence (the scan and the step recurrence
    agree; attention and Mamba states both carry). The MoE runs at a
    capacity factor of E / k, so the capacity prefill drops no token: a
    dropped token's update is zero there but not in the dropless decode."""
    _, pcfg = _configs()
    m = pcfg.moe
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    pp = lm.init_lm(pcfg, seed=1, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(37).integers(0, 256, (2, 10), np.int32))
    logits, cache = lm.forward_prefill(pp, toks[:, :6], pcfg, "auto",
                                       lm.init_cache(pcfg, 2, 10,
                                                     device="cpu"))
    for i in range(6, 10):
        want, _ = lm.forward_prefill(pp, toks[:, :i], pcfg, "auto",
                                     lm.init_cache(pcfg, 2, 10, device="cpu"))
        np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
        logits, _, cache = lm.forward_decode(pp, toks[:, i:i + 1], pcfg,
                                             "auto", cache)
    assert cache.pos.tolist() == [10, 10]


def test_prefill_and_decode_logits_match():
    """Teacher-forced: prefill then 5 decode steps with a live mask (slot
    1 dead); final and exit logits, K/V and Mamba states agree."""
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(38)
    prompt = rng.integers(0, 256, (3, 8), np.int32)
    feed = rng.integers(0, 256, (5, 3), np.int32)
    live = np.array([True, False, True])
    jlog, jc = jlm.forward_prefill(jp, jnp.asarray(prompt), jcfg, POLICY,
                                   jlm.init_cache(jcfg, 3, 16))
    plog, pc = lm.forward_prefill(pp, _t(prompt), pcfg, "auto",
                                  lm.init_cache(pcfg, 3, 16, device="cpu"))
    np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    assert pc.k.shape[0] == 2 and pc.ssm.shape[0] == 14
    for step in range(5):
        tok = feed[step][:, None]
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(tok), jcfg,
                                           POLICY, jc,
                                           live=jnp.asarray(live))
        plog, pex, pc = lm.forward_decode(pp, _t(tok), pcfg, "auto", pc,
                                          live=_t(live))
        np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                                   atol=TOL)
        assert len(pex) == len(jex) == 1
        np.testing.assert_allclose(_np(pex[0]), np.asarray(jex[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    # the stacks hold the JAX slots' states: slot 4 is attention, the rest
    # Mamba, each [n_sb, ...] in JAX and one row per layer here
    for i in range(pcfg.num_layers):
        sb, j = divmod(i, pcfg.period)
        st = pc.layer(i)
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[sb],
                                      jc.slots[j])
        for a_, w_ in zip(st, want):
            np.testing.assert_allclose(_np(a_), w_, rtol=TOL, atol=TOL)


def test_greedy_tokens_match_jax_generate():
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    prompt = np.random.default_rng(39).integers(0, 256, (2, 6), np.int32)
    jtok = np.asarray(jax_generate(run, jp, jnp.asarray(prompt), 8)[0])
    ptok, _ = generate(pcfg, pp, prompt, 8, device="cpu")
    np.testing.assert_array_equal(ptok.numpy(), jtok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_engine_tokens_equal_generate(dtype):
    """6 requests of ragged lengths through 3 slots (backfill: a slot's
    Mamba state is overwritten by its next occupant's prefill): every
    request's tokens equal ``generate`` on its prompt alone. Recurrent
    archs prefill at the exact prompt length (no bucket)."""
    _, pcfg = _configs(dtype)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    rng = np.random.default_rng(40)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=6)
            for i, n in enumerate((5, 9, 13, 3, 7, 11))]
    engine = SlotEngine(pcfg, capacity=3, max_len=24, chunk=3, device="cpu")
    assert engine.prompt_bucket == 1
    report = serve(engine, pp, reqs)
    assert len(report.served) == 6
    assert engine.prefill_tokens == sum(len(r.prompt) for r in reqs)
    for r in reqs:
        want, _ = generate(pcfg, pp, r.prompt[None], 6, device="cpu")
        assert r.tokens == want[0].tolist(), r.rid


def test_fill_and_reset_slot_write_the_recurrent_rows():
    _, pcfg = _configs()
    cache = lm.init_cache(pcfg, 3, 8, device="cpu")
    src = lm.init_cache(pcfg, 1, 5, device="cpu")
    for t in src.states + src.recurrent:
        t.fill_(1.0)
    lm.fill_slot(cache, src, 1, 5)
    assert all(bool((t[:, 1] == 1).all()) and not bool(t[:, 0].any())
               and not bool(t[:, 2].any()) for t in cache.recurrent)
    assert bool((cache.k[:, 1, :, :5] == 1).all())
    assert not bool(cache.k[:, 1, :, 5:].any())
    assert cache.pos.tolist() == [0, 5, 0]
    lm.reset_slot(cache, 1)
    assert not any(bool(t.any()) for t in cache.states + cache.recurrent)
    assert cache.pos.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# refusals, and no fallback
# ---------------------------------------------------------------------------


def test_paged_and_spec_refused_for_recurrent_archs():
    """The paged engine serves recurrent archs (attention pages beside the
    slot-indexed Mamba state); speculative decoding and verify stay
    refused for them, as in JAX."""
    _, pcfg = _configs()
    yi = port_arch("yi-9b").reduced(early_exit=None)
    engine = SlotEngine(pcfg, capacity=2, max_len=16, device="cpu",
                        paged=True, page_size=4)
    assert engine.prompt_bucket == 1
    cache, _ = engine.init_state()
    n_attn = cache.mixers.count("attn")
    n_mamba = cache.mixers.count("mamba")
    assert n_attn and n_mamba
    assert cache.k_pages.shape[:2] == (n_attn, 9)
    assert cache.conv.shape[:2] == cache.ssm.shape[:2] == (n_mamba, 2)
    for target, draft in ((dataclasses.replace(pcfg, early_exit=None), yi),
                          (yi, dataclasses.replace(pcfg, early_exit=None))):
        with pytest.raises(ValueError, match="speculative decoding for "
                                             "recurrent archs"):
            SlotEngine(target, capacity=2, max_len=16, device="cpu",
                       spec=SpecConfig(draft_arch=draft, k=2))
    pp = lm.init_lm(pcfg, device="cpu")
    for cache in (lm.init_cache(pcfg, 2, 16, device="cpu"),
                  lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")):
        with pytest.raises(ValueError, match="recurrent"):
            lm.forward_verify(pp, torch.zeros(2, 3, dtype=torch.int32), pcfg,
                              "auto", cache)


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--paged"], None, id="flags0-paged hybrid engine"),
    pytest.param(["--draft", "yi-9b"], "speculative decoding for recurrent",
                 id="flags1-speculative decoding for recurrent"),
])
def test_launcher_refuses_paged_and_spec_for_jamba(flags, match, capsys):
    """``--paged`` serves jamba through the paged hybrid engine; ``--draft``
    is refused for a recurrent target."""
    argv = ["--arch", ARCH, "--device", "cpu"] + flags
    if match is None:
        report = launcher.main(argv + ["--requests", "2", "--capacity", "2",
                                       "--new-tokens", "3",
                                       "--prompt-len-min", "5",
                                       "--prompt-len-max", "5",
                                       "--max-len", "16"])
        assert report.completion_rate == 1.0
        assert "pages: peak" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit):
        launcher.main(argv)
    assert match in capsys.readouterr().err


def test_launcher_refuses_a_recurrent_draft(capsys):
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "yi-9b", "--device", "cpu", "--draft",
                       ARCH])
    assert "speculative decoding for recurrent" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["ssm_scan", "ssm_decode"])
def test_new_kernel_wrappers_raise_on_cpu_tensors(name):
    """The wrapper of each kernel this slice adds raises on a CPU tensor
    and counts no launch: on the card ``policy="auto"`` launches the
    kernel or fails, it never falls back to the plain version."""
    from repro_torch.core import xaif
    from repro_torch.kernels.ssm_decode.ops import ssm_decode
    from repro_torch.kernels.ssm_scan.ops import ssm_scan
    f32 = torch.float32
    calls = {
        "ssm_scan": lambda: ssm_scan(
            torch.zeros(1, 3, 16), torch.zeros(1, 3, 16), torch.zeros(16, 8),
            torch.zeros(1, 3, 8), torch.zeros(1, 3, 8), torch.zeros(16)),
        "ssm_decode": lambda: ssm_decode(
            torch.zeros(2, 16), torch.zeros(2, 16), torch.zeros(16, 8),
            torch.zeros(2, 8), torch.zeros(2, 8), torch.zeros(16),
            torch.zeros(2, 16, 8, dtype=f32)),
    }
    before = xaif.launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        calls[name]()
    assert xaif.launch_counts() == before


def test_ssm_decode_kernel_refuses_the_mlstm_mode():
    """The mLSTM mode of the kernel wrapper refuses CPU tensors (its
    kernel runs on the card only) and counts no launch."""
    from repro_torch.core import xaif
    from repro_torch.kernels.ssm_decode.ops import ssm_decode
    z3, z2 = torch.zeros(2, 3, 8), torch.zeros(2, 3)
    before = xaif.launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        ssm_decode(z3, z3, z3, z2, z2, z2, torch.zeros(2, 3, 8, 8),
                   torch.zeros(2, 3, 8))
    assert xaif.launch_counts() == before


# ---------------------------------------------------------------------------
# the decode step's new state, written in place
# ---------------------------------------------------------------------------


def _mamba_step_inputs(rng, b, din, n):
    x = rng.standard_normal((b, din)).astype(np.float32)
    g = rng.uniform(1e-3, 0.1, (b, din)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (din, 1))
    bm = rng.standard_normal((b, n)).astype(np.float32)
    cm = rng.standard_normal((b, n)).astype(np.float32)
    m = rng.standard_normal(din).astype(np.float32)
    h = rng.standard_normal((b, din, n)).astype(np.float32)
    return tuple(map(_t, (x, g, a, bm, cm, m, h)))


@pytest.mark.parametrize("via_op", [False, True], ids=["plain", "op"])
def test_mamba_decode_writes_its_state_in_place(via_op):
    """``out=h``: the new state lands in h itself, bitwise the values of a
    separate output, with the same y; a separate ``out`` is filled and
    returned and leaves h as it was. Plain version, directly and through
    the ``ssm_decode`` op on CPU tensors."""
    from repro_torch.core import xaif
    rng = np.random.default_rng(37)
    args = _mamba_step_inputs(rng, 3, 24, 8)
    want_y, want_h = ssm_decode_ref(*args)
    call = (lambda *a, **k: xaif.call("ssm_decode", "auto", *a, **k)) \
        if via_op else ssm_decode_ref
    h = args[-1].clone()
    ptr = h.data_ptr()
    y, h_new = call(*args[:-1], h, out=h)
    assert h_new is h and h.data_ptr() == ptr
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert not torch.equal(h, args[-1])          # the state did move
    dst = torch.empty_like(h)
    y2, h2 = call(*args, out=dst)
    assert h2 is dst and torch.equal(dst, want_h) and torch.equal(y2, want_y)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_ssm_decode_refuses_an_out_that_does_not_fit_the_state(bad):
    """``out`` takes the new state whole: another shape or dtype raises
    before anything is written."""
    rng = np.random.default_rng(39)
    args = _mamba_step_inputs(rng, 2, 16, 8)
    out = (torch.zeros(2, 16, 4) if bad == "shape"
           else torch.zeros(2, 16, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="out"):
        ssm_decode_ref(*args, out=out)
    assert not out.any()


def test_mamba_decode_steps_advance_the_cache_stack_in_place():
    """Decode steps through one layer's view of the stacked [L, B, ...]
    state write the stack's own memory (no copy back): after 5 steps from
    a carried state, the views keep their storage, row 1 of the stacks
    agrees with the JAX mixer's state, and row 0 is untouched."""
    jcfg, pcfg = _configs()
    jp, pp = _mixer(jcfg)
    rng = np.random.default_rng(38)
    b = 2
    stack = mamba.init_mamba_state(pcfg, b, torch.float32, "cpu", layers=2)
    jst = jmamba.init_mamba_state(jcfg, b, jnp.float32)
    arrs = [rng.standard_normal(np.shape(a)).astype(np.float32) * 0.5
            for a in jst]
    jst = jmamba.MambaState(*map(jnp.asarray, arrs))
    for s_, a_ in zip(stack, arrs):
        s_[1].copy_(_t(a_))
        s_[0].copy_(_t(a_) + 1.0)
    row0 = [s_[0].clone() for s_ in stack]
    pst = mamba.MambaState(*(s_[1] for s_ in stack))
    ptrs = [t_.data_ptr() for t_ in pst]
    for _ in range(5):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jmamba.apply_mamba_decode(jp, jnp.asarray(xt), jcfg, POLICY,
                                            jst)
        py, pst = mamba.apply_mamba_decode(pp, _t(xt), pcfg, "auto", pst)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
    assert [t_.data_ptr() for t_ in pst] == ptrs
    for s_, w_, r_ in zip(stack, jst, row0):
        np.testing.assert_allclose(s_[1].numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)
        assert torch.equal(s_[0], r_)
