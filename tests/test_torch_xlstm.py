"""The port's xLSTM path and the reduced xlstm-350m against the JAX
package's, from the same seeded numpy inputs and the same parameters.

The reduced xLSTM: d_model 64, 4 heads, 16 layers (two super-blocks of 7
mLSTM + 1 sLSTM), mLSTM d_in 128 (dh 32), sLSTM head dim 16 and a gated
FFN of 85, chunk 16, exit after layer 8.

Tolerances:
  * 1e-5 for the mLSTM decode step at fp32 (the ``ssm_decode`` op's mLSTM
    mode): both sides compute in fp32 from the same inputs and differ only
    in the order of the sums over dh and in exp's last bit;
  * 1e-4 for the mixers and the model at fp32, as in
    ``test_torch_model.py``: the projections go through XLA's and
    PyTorch's CPU matmuls, the chunkwise prefill through their batched
    dots; in bf16 the mixers' outputs are held to a few bf16 steps (rtol =
    atol = 5e-2: q, k and v are rounded to bf16 before the cell, as in
    JAX, and an ulp there moves the cell's output by a few);
  * 1e-3 for the reduced model's logits end to end at fp32: layer by
    layer, teacher-forced, the port agrees with JAX to 1e-5 (held at 1e-4
    below), but sixteen recurrent layers, each renormalizing its cell
    output per head, carry and grow those fp32 differences to ~5e-4 of
    logits of magnitude ~3 (the reduced jamba and deepseek stay within
    1e-4);
  * 1e-4 between a prefill of T tokens followed by decode steps and one
    prefill of the longer sequence (the chunkwise form and the step
    recurrence are the same arithmetic in another order);
  * greedy tokens at fp32 must be equal; the slot engine's tokens must
    equal ``generate``'s exactly, and the paged engine's the contiguous
    engine's.

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
from repro.models import lm as jlm
from repro.models import xlstm as jxlstm
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import xaif
from repro_torch.kernels.gemm.ref import gemm_heads_ref
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.models import xlstm
from repro_torch.serve.engine import SlotEngine, generate
from repro_torch.serve.scheduler import Request, serve

POLICY = AccelConfig()            # the JAX package's all-ref policy
TOL = 1e-4
TOL_OP = 1e-5
TOL_BF16 = 5e-2
TOL_MODEL = 1e-3
ARCH = "xlstm-350m"


def _configs(dtype="float32"):
    return (get_arch(ARCH).reduced(dtype=dtype),
            port_arch(ARCH).reduced(dtype=dtype))


def _params(jcfg, seed=0):
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(t):
    return t.float().numpy()


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32)))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


def test_configs_match_the_jax_package():
    for jcfg, pcfg in (_configs(), (get_arch(ARCH), port_arch(ARCH))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope", "dtype",
                  "norm_eps", "first_k_dense", "family", "period"):
            assert getattr(jcfg, f) == getattr(pcfg, f), f
        assert dataclasses.asdict(jcfg.xlstm) == \
            dataclasses.asdict(pcfg.xlstm)
        assert jcfg.mamba is None and pcfg.mamba is None
        assert jcfg.moe is None and pcfg.moe is None
        assert jcfg.early_exit.exit_layers == pcfg.early_exit.exit_layers
        for i in range(jcfg.num_layers):
            assert (jcfg.layer_spec(i).mixer, jcfg.layer_spec(i).ffn) == \
                (pcfg.layer_spec(i).mixer, pcfg.layer_spec(i).ffn)
        assert lm._segments(pcfg) == jlm._segments(jcfg)
    _, pcfg = _configs()
    assert pcfg.xlstm.chunk_size == 16 and pcfg.recurrent
    assert port_arch(ARCH).xlstm.chunk_size == 64
    assert [s.mixer for s in pcfg.block_pattern] == ["mlstm"] * 7 + \
        ["slstm"]
    assert {s.ffn for s in pcfg.block_pattern} == {"none"}
    with pytest.raises(ValueError, match="XLSTMConfig"):
        dataclasses.replace(pcfg, xlstm=None)


def test_full_size_parameter_shapes_match_jax():
    """The full-size tree's shapes and dtypes equal ``jax.eval_shape`` of
    the JAX ``init_lm``, with nothing allocated on either side (the port
    builds it on the meta device): 24 layers, ~0.33 B parameters."""
    jcfg, pcfg = get_arch(ARCH), port_arch(ARCH)
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
    ml, sl = got["slots"][0]["mixer"], got["slots"][7]["mixer"]
    assert ml["wq"].shape == (3, 4, 512, 512)
    assert ml["w_if"].shape == (3, 2048, 8)
    assert sl["wr"].shape == (3, 4, 256, 1024)
    assert sl["w_ff1"].shape == (3, 1024, 2730)
    assert sl["w_ff2"].shape == (3, 1365, 1024)
    n = sum(b.numel() for _, b in pl)
    assert abs(n - 0.33e9) < 0.01e9, n


def test_params_from_jax_carries_the_xlstm_tree():
    jcfg, _ = _configs(dtype="bfloat16")
    jp, pp = _params(jcfg)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves_with_path(pp)
    assert len(jl) == len(pl)
    for (path, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert len(pp["slots"]) == 8
    for j in range(8):
        assert set(pp["slots"][j]) == {"ln1", "mixer"}
    assert set(pp["slots"][0]["mixer"]) == {
        "up_proj", "conv", "wq", "wk", "wv", "w_if", "b_i", "b_f",
        "norm_scale", "down_proj"}
    assert set(pp["slots"][7]["mixer"]) == {"wx", "wr", "b", "norm_scale",
                                            "w_ff1", "w_ff2"}
    ml, sl = pp["slots"][0]["mixer"], pp["slots"][7]["mixer"]
    assert ml["wq"].dtype == ml["up_proj"].dtype == torch.bfloat16
    assert ml["w_if"].dtype == sl["wr"].dtype == torch.float32


def test_init_xlstm_draws_from_the_jax_distributions():
    """b_f = 3, fp32 w_if and wr, wr at 0.1 / sqrt(dh), the sLSTM bias
    (forget gate 3), unit norm scales; the same keys, shapes and dtypes
    as JAX's init, and the same scales within sampling error."""
    jcfg, pcfg = get_arch(ARCH).reduced(dtype="bfloat16"), \
        port_arch(ARCH).reduced(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    for name, jinit, pinit in (("mlstm", jxlstm.init_mlstm,
                                xlstm.init_mlstm),
                               ("slstm", jxlstm.init_slstm,
                                xlstm.init_slstm)):
        jp = jax.device_get(jinit(jax.random.PRNGKey(1), jcfg, jnp.bfloat16))
        pp = pinit(gen, pcfg, torch.bfloat16, "cpu")
        assert set(jp) == set(pp), name
        for k in jp:
            ja = jax.tree_util.tree_leaves(jp[k])
            pa = jax.tree_util.tree_leaves(pp[k])
            for a, b in zip(ja, pa):
                assert tuple(a.shape) == tuple(b.shape), (name, k)
                assert str(a.dtype) == str(b.dtype).replace("torch.", ""), k
                a32 = np.asarray(a, np.float32)
                if a32.std() == 0:
                    np.testing.assert_array_equal(a32, _np(b), err_msg=k)
                else:
                    assert abs(float(_np(b).std()) / a32.std() - 1) < 0.15, k
    ml = xlstm.init_mlstm(gen, pcfg, torch.float32, "cpu")
    assert bool((ml["b_f"] == 3).all()) and not bool(ml["b_i"].any())
    sl = xlstm.init_slstm(gen, pcfg, torch.float32, "cpu")
    d = pcfg.d_model
    assert bool((sl["b"][d:2 * d] == 3).all())
    assert not bool(sl["b"][:d].any()) and not bool(sl["b"][2 * d:].any())
    assert abs(float(sl["wr"].std()) - 0.1 / 16 ** 0.5) < 0.005


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


def _mlstm_inputs(rng, b, hh, dh):
    q, v = (rng.standard_normal((b, hh, dh)).astype(np.float32)
            for _ in range(2))
    k = (rng.standard_normal((b, hh, dh)) * dh ** -0.5).astype(np.float32)
    li = rng.standard_normal((b, hh)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.normal(3, 1, (b, hh))))
                ).astype(np.float32)
    m = rng.normal(0, 2, (b, hh)).astype(np.float32)
    c = rng.standard_normal((b, hh, dh, dh)).astype(np.float32)
    n = rng.standard_normal((b, hh, dh)).astype(np.float32)
    return (q, k, v, li, lf, m, c, n)


@pytest.mark.parametrize("b,hh,dh", [(3, 4, 32), (1, 1, 512)])
def test_mlstm_decode_matches_jax(b, hh, dh):
    """The port's plain mLSTM step, called directly and through the
    ``ssm_decode`` op on CPU tensors, against JAX's ref and the Pallas
    kernel in interpret mode: at the reduced shape and at xlstm-350m's
    head dim of 512."""
    rng = np.random.default_rng(41 + dh)
    ops = _mlstm_inputs(rng, b, hh, dh)
    got_h, got_s = ssm_decode_ref(*map(_t, ops))
    via_op = xaif.call("ssm_decode", "auto", *map(_t, ops))
    for a_, w_ in zip((got_h,) + got_s, (via_op[0],) + via_op[1]):
        assert torch.equal(a_, w_)
    assert got_h.shape == (b, hh, dh) and got_s[0].shape == (b, hh, dh, dh)
    for want_h, want_s in (
            jax_sd_ref.ssm_decode_ref(*map(jnp.asarray, ops)),
            jax_sd_ops.ssm_decode_pallas_op(*map(jnp.asarray, ops),
                                            interpret=True)):
        for a_, w_ in zip((got_h,) + got_s, (want_h,) + want_s):
            scale = max(1.0, float(np.abs(np.asarray(w_)).max()))
            np.testing.assert_allclose(a_.numpy(), np.asarray(w_),
                                       rtol=TOL_OP, atol=TOL_OP * scale)


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
def test_gemm_heads_head_major_matches_einsum(wdtype):
    """The head-major layout [H, K, N] (xLSTM's block-diagonal q/k/v and
    sLSTM's recurrent weights) against the einsum, and row-chunked (a
    long prefill's rows) against whole."""
    rng = np.random.default_rng(42)
    x = _t(rng.standard_normal((5, 3, 8)))
    w = _t(rng.standard_normal((3, 8, 12))).to(wdtype)
    want = torch.einsum("mhk,hkn->mhn", x, w.float())
    got = gemm_heads_ref(x, w, head_major=True)
    assert got.dtype == torch.float32 and got.shape == (5, 3, 12)
    torch.testing.assert_close(got, want, rtol=TOL_OP, atol=TOL_OP)
    via_op = xaif.call("gemm_heads", "auto", x, w, head_major=True)
    assert torch.equal(via_op, got)
    # rows one at a time == all rows (the chunking cuts the rows only)
    rows = torch.cat([gemm_heads_ref(x[i:i + 1], w, head_major=True)
                      for i in range(5)])
    assert torch.equal(rows, got)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _mixer(jcfg, init, seed=0, dtype=jnp.float32):
    jp = init(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _port_mlstm_state(pcfg, b, dtype=torch.float32):
    return xlstm.MLSTMState(*(s[0] for s in xlstm.init_mlstm_state(
        pcfg, b, dtype, "cpu", layers=1)))


def _port_slstm_state(pcfg, b):
    return xlstm.SLSTMState(*(s[0] for s in xlstm.init_slstm_state(
        pcfg, b, "cpu", layers=1)))


def _random_mlstm_state(rng, jcfg, pcfg, b):
    """A carried state as a prefill leaves it (m of either sign, c and n
    of the cell's scale) in both packages."""
    jst = jxlstm.init_mlstm_state(jcfg, b, jnp.float32)
    arrs = [rng.standard_normal(np.shape(a)).astype(np.float32) * 0.5
            for a in jst]
    jst = jxlstm.MLSTMState(*map(jnp.asarray, arrs))
    pst = _port_mlstm_state(pcfg, b)
    for dst, a in zip(pst, arrs):
        dst.copy_(_t(a))
    return jst, pst


@pytest.mark.parametrize("t", [16, 12, 20, 17])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_mlstm_prefill_and_decode_match_jax(t, carried):
    """Chunkwise prefill at T = 16 (one chunk of the configured 16), 12
    (one chunk of 12), 20 (the chunk halves to 4) and 17 (a prime: it
    halves down to chunks of 1), from a zero or a carried state, then 3
    decode steps; outputs and states agree with the JAX mixer."""
    jcfg, pcfg = _configs()
    jp, pp = _mixer(jcfg, jxlstm.init_mlstm)
    assert xlstm._chunk_len(pcfg, t) == {16: 16, 12: 12, 20: 4, 17: 1}[t]
    rng = np.random.default_rng(43 + t)
    b = 2
    x = rng.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    if carried:
        jst, pst = _random_mlstm_state(rng, jcfg, pcfg, b)
    else:
        jst = jxlstm.init_mlstm_state(jcfg, b, jnp.float32)
        pst = _port_mlstm_state(pcfg, b)
    jy, jst = jxlstm.apply_mlstm(jp, jnp.asarray(x), jcfg, POLICY, jst)
    py, pst = xlstm.apply_mlstm(pp, _t(x), pcfg, "auto", pst)
    _close(py, jy, TOL)
    for a_, w_ in zip(pst, jst):
        _close(a_, w_, TOL)
    for _ in range(3):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jxlstm.apply_mlstm_decode(jp, jnp.asarray(xt), jcfg,
                                            POLICY, jst)
        py, pst = xlstm.apply_mlstm_decode(pp, _t(xt), pcfg, "auto", pst)
        assert py.shape == (b, 1, jcfg.d_model)
        _close(py, jy, TOL)
        for a_, w_ in zip(pst, jst):
            _close(a_, w_, TOL)
    if not carried:     # without a state: the same output, none returned
        jy0, _ = jxlstm.apply_mlstm(jp, jnp.asarray(x), jcfg, POLICY)
        py0, st0 = xlstm.apply_mlstm(pp, _t(x), pcfg, "auto")
        assert st0 is None
        _close(py0, jy0, TOL)


def test_apply_mlstm_bf16_matches_jax():
    """bf16 activations and weights: q, k, v rounded to bf16 as JAX's
    einsums round them, k scaled after the rounding."""
    jcfg, pcfg = _configs("bfloat16")
    jp, pp = _mixer(jcfg, jxlstm.init_mlstm, dtype=jnp.bfloat16)
    rng = np.random.default_rng(44)
    x = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    jst = jxlstm.init_mlstm_state(jcfg, 2, jnp.bfloat16)
    pst = _port_mlstm_state(pcfg, 2, torch.bfloat16)
    jy, jst = jxlstm.apply_mlstm(jp, jnp.asarray(x, jnp.bfloat16), jcfg,
                                 POLICY, jst)
    py, pst = xlstm.apply_mlstm(pp, _t(x).to(torch.bfloat16), pcfg, "auto",
                                pst)
    assert py.dtype == torch.bfloat16
    _close(py, jy, TOL_BF16)
    xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jy, _ = jxlstm.apply_mlstm_decode(jp, jnp.asarray(xt, jnp.bfloat16),
                                      jcfg, POLICY, jst)
    py, _ = xlstm.apply_mlstm_decode(pp, _t(xt).to(torch.bfloat16), pcfg,
                                     "auto", pst)
    _close(py, jy, TOL_BF16)


def test_mlstm_prefill_then_decode_equals_longer_prefill():
    """The chunkwise form against the recurrence: a prefill of 9 tokens
    then 3 decode steps gives the outputs and the state of one prefill of
    the 12 (chunks of 4)."""
    _, pcfg = _configs()
    gen = torch.Generator().manual_seed(3)
    pp = xlstm.init_mlstm(gen, pcfg, torch.float32, "cpu")
    x = _t(np.random.default_rng(45).standard_normal((2, 12, 64)))
    whole = _port_mlstm_state(pcfg, 2)
    y_whole, _ = xlstm.apply_mlstm(pp, x, pcfg, "auto", whole)
    st = _port_mlstm_state(pcfg, 2)
    y9, _ = xlstm.apply_mlstm(pp, x[:, :9], pcfg, "auto", st)
    ys = [y9]
    for i in range(9, 12):
        y, _ = xlstm.apply_mlstm_decode(pp, x[:, i:i + 1], pcfg, "auto", st)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_whole, rtol=TOL,
                               atol=TOL)
    for a_, w_ in zip(st, whole):
        torch.testing.assert_close(a_, w_, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_slstm_prefill_and_decode_match_jax(dtype):
    """sLSTM: a 6-token prefill from a zero state, then 3 decode steps;
    outputs and states agree with the JAX mixer."""
    jcfg, pcfg = _configs(dtype)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp, pp = _mixer(jcfg, jxlstm.init_slstm, dtype=jd)
    tol = TOL if dtype == "float32" else TOL_BF16
    rng = np.random.default_rng(46)
    b = 3
    x = rng.standard_normal((b, 6, jcfg.d_model)).astype(np.float32)
    jst = jxlstm.init_slstm_state(jcfg, b, jd)
    pst = _port_slstm_state(pcfg, b)
    jy, jst = jxlstm.apply_slstm(jp, jnp.asarray(x, jd), jcfg, POLICY, jst)
    py, pst = xlstm.apply_slstm(pp, _t(x).to(td), pcfg, "auto", pst)
    assert py.dtype == td
    _close(py, jy, tol)
    for a_, w_ in zip(pst, jst):
        _close(a_, w_, tol)
    for _ in range(3):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jxlstm.apply_slstm_decode(jp, jnp.asarray(xt, jd), jcfg,
                                            POLICY, jst)
        py, pst = xlstm.apply_slstm_decode(pp, _t(xt).to(td), pcfg, "auto",
                                           pst)
        _close(py, jy, tol)
        for a_, w_ in zip(pst, jst):
            _close(a_, w_, tol)
    jy0, _ = jxlstm.apply_slstm(jp, jnp.asarray(x, jd), jcfg, POLICY)
    py0, st0 = xlstm.apply_slstm(pp, _t(x).to(td), pcfg, "auto")
    assert st0 is None
    _close(py0, jy0, tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_caches_hold_no_attention_state():
    """No attention layer: no K/V tensors, no pools; the mLSTM and sLSTM
    stacks are slot-indexed, [21 | 14, B, ...] and [3 | 2, B, d]."""
    _, pcfg = _configs()
    cache = lm.init_cache(pcfg, 3, 16, device="cpu")
    paged = lm.init_paged_cache(pcfg, 3, 16, 4, 13, device="cpu")
    for c in (cache, paged):
        assert c.mlstm.c.shape == (14, 3, 4, 32, 32)
        assert c.mlstm.conv.shape == (14, 3, 3, 128)
        assert c.slstm.h.shape == (2, 3, 64)
        assert len(c.recurrent) == 8
        assert c.conv is None and c.ssm is None
    assert cache.states == () and cache.k is None and cache.c_kv is None
    assert paged.pools == () and paged.k_pages is None
    assert paged.page_table.shape == (3, 4)
    assert isinstance(cache.layer(7), xlstm.SLSTMState)
    assert isinstance(cache.layer(8), xlstm.MLSTMState)
    assert cache.layer(15).c.data_ptr() == cache.slstm.c[1].data_ptr()


def test_prefill_layers_match_teacher_forced():
    """Layer by layer: each layer takes JAX's hidden state as its input;
    its output and the state it leaves agree with JAX's layer to TOL."""
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    prompt = np.random.default_rng(47).integers(0, 256, (3, 12), np.int32)
    jc = jlm.init_cache(jcfg, 3, 16)
    pc = lm.init_cache(pcfg, 3, 16, device="cpu")
    x = jlm._embed(jp, jnp.asarray(prompt), jcfg)
    for i in range(jcfg.num_layers):
        sb, j = divmod(i, jcfg.period)
        at = jax.tree_util.tree_map(lambda a: a[sb], (jp["slots"][j],
                                                      jc.slots[j]))
        y, _, jst = jlm._apply_layer(at[0], x, jcfg.layer_spec(i), jcfg,
                                     POLICY, state=at[1], mode="prefill")
        py = lm._apply_layer(lm._layer(pp, pcfg, i), _t(x), pcfg,
                             pcfg.layer_spec(i), "auto", pc.layer(i),
                             "prefill")
        _close(py, y, TOL)
        for a_, w_ in zip(pc.layer(i), jst):
            _close(a_, w_, TOL)
        x = y


def test_prefill_and_decode_logits_match():
    """End to end: prefill then 4 decode steps; final and exit logits
    and every layer's state agree with JAX from the same params."""
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(47)
    prompt = rng.integers(0, 256, (3, 12), np.int32)
    feed = rng.integers(0, 256, (4, 3), np.int32)
    jlog, jc = jlm.forward_prefill(jp, jnp.asarray(prompt), jcfg, POLICY,
                                   jlm.init_cache(jcfg, 3, 16))
    plog, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg,
                                  "auto",
                                  lm.init_cache(pcfg, 3, 16, device="cpu"))
    _close(plog, jlog, TOL_MODEL)
    for step in range(4):
        tok = feed[step][:, None]
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(tok), jcfg,
                                           POLICY, jc)
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(tok), pcfg,
                                          "auto", pc)
        _close(plog, jlog, TOL_MODEL)
        assert len(pex) == len(jex) == 1
        _close(pex[0], jex[0], TOL_MODEL)
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    for i in range(pcfg.num_layers):
        sb, j = divmod(i, pcfg.period)
        want = jax.tree_util.tree_map(lambda a: np.asarray(a)[sb],
                                      jc.slots[j])
        for a_, w_ in zip(pc.layer(i), want):
            _close(a_, w_, TOL_MODEL)


def test_greedy_tokens_match_jax_generate():
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    prompt = np.random.default_rng(48).integers(0, 256, (2, 7), np.int32)
    jtok = np.asarray(jax_generate(run, jp, jnp.asarray(prompt), 8)[0])
    ptok, _ = generate(pcfg, pp, prompt, 8, device="cpu")
    np.testing.assert_array_equal(ptok.numpy(), jtok)


def _requests(seed=49):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=6)
            for i, n in enumerate((5, 9, 13, 3, 7, 11))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_engine_tokens_equal_generate(dtype):
    """6 requests of ragged lengths through 3 slots (backfill: a slot's
    mLSTM and sLSTM states are overwritten by its next occupant's
    prefill): every request's tokens equal ``generate`` on its prompt
    alone. Recurrent archs prefill at the exact prompt length."""
    _, pcfg = _configs(dtype)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    reqs = _requests()
    engine = SlotEngine(pcfg, capacity=3, max_len=24, chunk=3, device="cpu")
    assert engine.prompt_bucket == 1
    report = serve(engine, pp, reqs)
    assert len(report.served) == 6
    assert engine.prefill_tokens == sum(len(r.prompt) for r in reqs)
    for r in reqs:
        want, _ = generate(pcfg, pp, r.prompt[None], 6, device="cpu")
        assert r.tokens == want[0].tolist(), r.rid


def test_paged_tokens_equal_contiguous():
    """The paged engine on an arch with no attention pool: admission and
    page accounting as in JAX (a pool of 9 usable pages of 4 for 3 slots
    that could ask for 18), nothing stored in pages; tokens equal the
    contiguous engine's per request."""
    _, pcfg = _configs()
    pp = lm.init_lm(pcfg, seed=2, device="cpu")
    tokens = {}
    for paged in (False, True):
        reqs = _requests(50)
        kw = dict(paged=True, page_size=4, num_pages=10) if paged else {}
        engine = SlotEngine(pcfg, capacity=3, max_len=24, chunk=3,
                            device="cpu", **kw)
        report = serve(engine, pp, reqs)
        assert len(report.served) == 6
        if paged:
            assert 0 < report.stats["peak_pages"] <= 9
            cache, _ = engine.init_state()
            assert cache.pools == ()
        tokens[paged] = [r.tokens for r in reqs]
    assert tokens[True] == tokens[False]


def test_fill_reset_fill_round_trip():
    """fill_slot / reset_slot and fill_slot_paged / free_slot_paged carry
    every mLSTM and sLSTM stack: a slot filled, reset and filled again
    holds exactly the second source, and no other row is touched."""
    _, pcfg = _configs()
    src1 = lm.init_cache(pcfg, 1, 5, device="cpu")
    src2 = lm.init_cache(pcfg, 1, 7, device="cpu")
    for i, t in enumerate(src1.recurrent):
        t.fill_(1.0 + i)
    for i, t in enumerate(src2.recurrent):
        t.fill_(-2.0 - i)
    cache = lm.init_cache(pcfg, 3, 8, device="cpu")
    paged = lm.init_paged_cache(pcfg, 3, 8, 4, 7, device="cpu")
    lm.fill_slot(cache, src1, 1, 5)
    lm.fill_slot_paged(paged, src1, 1, 5, torch.tensor([3, 5]))
    for c in (cache, paged):
        assert all(bool((t[:, 1] == 1.0 + i).all())
                   for i, t in enumerate(c.recurrent))
        assert not any(bool(t[:, 0].any()) or bool(t[:, 2].any())
                       for t in c.recurrent)
        assert c.pos.tolist() == [0, 5, 0]
    assert paged.page_table[1].tolist() == [3, 5]
    lm.reset_slot(cache, 1)
    lm.free_slot_paged(paged, 1)
    for c in (cache, paged):
        assert not any(bool(t.any()) for t in c.recurrent)
        assert c.pos.tolist() == [0, 0, 0]
    assert paged.page_table[1].tolist() == [-1, -1]
    lm.fill_slot(cache, src2, 1, 7)
    lm.fill_slot_paged(paged, src2, 1, 7, torch.tensor([2, 6]))
    for c in (cache, paged):
        assert all(bool((t[:, 1] == -2.0 - i).all())
                   for i, t in enumerate(c.recurrent))
        assert c.pos.tolist() == [0, 7, 0]


# ---------------------------------------------------------------------------
# the CLI, refusals, and no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--paged"]], ids=["contiguous",
                                                          "paged"])
def test_launcher_serves_xlstm(flags, capsys):
    report = launcher.main(["--arch", ARCH, "--device", "cpu", "--requests",
                            "3", "--capacity", "2", "--new-tokens", "3",
                            "--prompt-len-min", "5", "--prompt-len-max",
                            "5", "--max-len", "16"] + flags)
    assert report.completion_rate == 1.0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    assert ("pages: peak" in out) == bool(flags)


def test_launcher_refuses_a_draft_for_xlstm(capsys):
    with pytest.raises(SystemExit):
        launcher.main(["--arch", ARCH, "--device", "cpu", "--draft",
                       "yi-9b"])
    assert "speculative decoding for recurrent" in capsys.readouterr().err


def test_mlstm_decode_kernel_raises_on_cpu_tensors():
    """The mLSTM mode of the ``ssm_decode`` wrapper launches its kernel or
    raises: on CPU tensors it raises and counts no launch (no fallback to
    the plain version); a rank-3 x without n, or n with a rank-2 x, is
    refused as a mode mismatch."""
    from repro_torch.kernels.ssm_decode.ops import mlstm_decode, ssm_decode
    ops = [_t(a) for a in _mlstm_inputs(np.random.default_rng(51), 2, 3, 8)]
    before = xaif.launch_counts()
    for fn in (lambda: ssm_decode(*ops), lambda: mlstm_decode(*ops)):
        with pytest.raises(ValueError, match="CUDA kernel got a tensor on "
                                             "cpu"):
            fn()
    with pytest.raises(ValueError, match="mLSTM mode"):
        ssm_decode(*ops[:7])
    with pytest.raises(ValueError, match="Mamba mode"):
        ssm_decode(ops[0][:, 0], *ops[1:])
    assert xaif.launch_counts() == before


# ---------------------------------------------------------------------------
# the decode step's new cell, written in place
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("via_op", [False, True], ids=["plain", "op"])
def test_mlstm_decode_writes_c_in_place(via_op):
    """``out=c``: C' lands in c itself, bitwise the values of a separate
    output, with the same h, n' and m' (those two always new tensors); a
    separate ``out`` is filled and returned and leaves c as it was. Plain
    version, directly and through the ``ssm_decode`` op on CPU tensors."""
    rng = np.random.default_rng(44)
    args = tuple(map(_t, _mlstm_inputs(rng, 2, 3, 16)))
    want_h, want_s = ssm_decode_ref(*args)
    call = (lambda *a, **k: xaif.call("ssm_decode", "auto", *a, **k)) \
        if via_op else ssm_decode_ref
    c = args[6].clone()
    ptr = c.data_ptr()
    h, (c_new, n_new, m_new) = call(*args[:6], c, args[7], out=c)
    assert c_new is c and c.data_ptr() == ptr
    assert n_new is not args[7] and m_new is not args[5]
    for got, want in zip((h, c, n_new, m_new), (want_h,) + want_s):
        assert torch.equal(got, want)
    assert not torch.equal(c, args[6])           # the cell did move
    dst = torch.empty_like(c)
    h2, (c2, _, _) = call(*args, out=dst)
    assert c2 is dst and torch.equal(dst, want_s[0])
    assert torch.equal(h2, want_h)


def test_mlstm_decode_steps_advance_the_cache_stack_in_place():
    """Decode steps through one layer's view of the stacked mLSTM state
    write the stack's own memory: after 5 steps from a carried state the
    views keep their storage, row 1 of the stacks agrees with the JAX
    mixer's state (C written in place, n, m and the conv window copied
    back) and row 0 is untouched."""
    jcfg, pcfg = _configs()
    jp, pp = _mixer(jcfg, jxlstm.init_mlstm)
    rng = np.random.default_rng(45)
    b = 2
    stack = xlstm.init_mlstm_state(pcfg, b, torch.float32, "cpu", layers=2)
    jst, one = _random_mlstm_state(rng, jcfg, pcfg, b)
    for s_, o_ in zip(stack, one):
        s_[1].copy_(o_)
        s_[0].copy_(o_ * 0.5)
    row0 = [s_[0].clone() for s_ in stack]
    pst = xlstm.MLSTMState(*(s_[1] for s_ in stack))
    ptrs = [t_.data_ptr() for t_ in pst]
    for _ in range(5):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jxlstm.apply_mlstm_decode(jp, jnp.asarray(xt), jcfg,
                                            POLICY, jst)
        py, pst = xlstm.apply_mlstm_decode(pp, _t(xt), pcfg, "auto", pst)
        _close(py, jy, TOL)
    assert [t_.data_ptr() for t_ in pst] == ptrs
    for s_, w_, r_ in zip(stack, jst, row0):
        _close(s_[1], w_, TOL)
        assert torch.equal(s_[0], r_)
