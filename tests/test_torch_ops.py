"""The port's plain ops against the JAX package, op by op.

Inputs are made from a seed with numpy and handed to both packages. Each
plain PyTorch op is held against the JAX ``ref`` backend and against the
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it).
Tolerances: float32 1e-5 (both sides compute in fp32 and differ only in
summation order); bfloat16 1e-2 relative, because the result is rounded
to bf16 (2^-8 relative spacing) and an fp32 difference in the last place
can move that rounding by one step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_decode import ops as jax_ad_ops
from repro.kernels.attn_decode import ref as jax_ad_ref
from repro.kernels.entropy_exit import ops as jax_ee_ops
from repro.kernels.entropy_exit import ref as jax_ee_ref
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.flash_attention import ref as jax_fa_ref
from repro.kernels.gemm import ops as jax_gemm_ops
from repro.kernels.gemm import ref as jax_gemm_ref
from repro.kernels.rmsnorm import ops as jax_rn_ops
from repro.kernels.rmsnorm import ref as jax_rn_ref
from repro_torch.core import xaif
from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.entropy_exit.ref import entropy_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gemm.ref import gemm_ref
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _close(torch_out, jax_outs, dtype):
    tol = TOL[dtype]
    got = torch_out.float().numpy()
    for want in jax_outs:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_gemm_matches_jax(activation, with_bias, dtype):
    """Ragged M, K and N (no multiple of 8 or of any block)."""
    m, k, n = 5, 33, 70
    rng = np.random.default_rng(len(activation) * 2 + with_bias)
    x, tx = _pair(rng.standard_normal((m, k), np.float32), dtype)
    w, tw = _pair((rng.standard_normal((k, n)) * k ** -0.5)
                  .astype(np.float32), dtype)
    b = tb = None
    if with_bias:
        b, tb = _pair(rng.standard_normal(n).astype(np.float32), dtype)
    out = gemm_ref(tx, tw, tb, activation)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    _close(out, [jax_gemm_ref.gemm_ref(x, w, b, activation),
                 jax_gemm_ops.gemm_pallas_op(x, w, b, activation,
                                             interpret=True)], dtype)


def test_gemm_leading_dims_and_dispatch():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40), np.float32)
    w = rng.standard_normal((40, 24), np.float32)
    out = xaif.call("gemm", "auto", torch.from_numpy(x), torch.from_numpy(w),
                    activation="silu")
    assert out.shape == (2, 3, 24)
    _close(out, [jax_gemm_ref.gemm_ref(jnp.asarray(x), jnp.asarray(w),
                                       None, "silu")], "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 48), (4, 512), (4, 1024),
                                   (4, 2048), (4, 4096)])
def test_rmsnorm_matches_jax(shape, dtype):
    """The reduced configs' widths and the served ones (4 live slots at d
    = 512, 1024, 2048, 4096), with an fp32 scale (the layer norms) and a
    scale in x's dtype (the exit heads: bf16 in a bf16 model)."""
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x, tx = _pair(rng.standard_normal(shape, np.float32) * 3.0, dtype)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    for sdt in dict.fromkeys(("float32", dtype)):
        js, ts = _pair(s, sdt)
        out = rmsnorm_ref(tx, ts, 1e-5)
        assert out.dtype == tx.dtype
        _close(out, [jax_rn_ref.rmsnorm_ref(x, js, 1e-5),
                     jax_rn_ops.rmsnorm_pallas_op(x, js, 1e-5,
                                                  interpret=True)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 5])
def test_rmsnorm_over_the_head_dim_matches_jax(t, dtype):
    """The QK-norm shape: JAX normalises q [B, H, T, 128] over the head
    dim; the port normalises [B, T, H, 128] (a head's row contiguous, as
    the kernel takes it) before the transpose. Both against JAX's ref and
    interpret-mode kernel on [B, H, T, 128], with a non-unit fp32 scale."""
    rng = np.random.default_rng(40 + t)
    a = rng.standard_normal((2, 4, t, 128), np.float32) * 3.0
    x, tx = _pair(a, dtype)
    js, ts = _pair(1 + rng.uniform(-0.5, 0.5, 128).astype(np.float32),
                   "float32")
    port = rmsnorm_ref(tx.transpose(1, 2).contiguous(), ts, 1e-5)
    assert port.dtype == tx.dtype
    _close(port.transpose(1, 2), [
        jax_rn_ref.rmsnorm_ref(x, js, 1e-5),
        jax_rn_ops.rmsnorm_pallas_op(x, js, 1e-5, interpret=True)], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,s,hd,g", [
    pytest.param(7, 7, 16, 2, id="7-7"), pytest.param(5, 12, 16, 2, id="5-12"),
    pytest.param(12, 12, 64, 1, id="12-12-d64g1")])
def test_attention_matches_jax(t, s, hd, g, causal, dtype):
    """GQA with g = 2 at head dim 16, and g = 1 at musicgen's head dim 64;
    t < s exercises the bottom-right causal offset."""
    rng = np.random.default_rng(t * 31 + s)
    q, tq = _pair(rng.standard_normal((2, 4, t, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((2, 4 // g, s, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((2, 4 // g, s, hd), np.float32), dtype)
    out = attention_ref(tq, tk, tv, causal=causal)
    assert out.shape == (2, 4, t, hd) and out.dtype == tq.dtype
    _close(out, [jax_fa_ref.attention_ref(q, k, v, causal),
                 jax_fa_ops.attention_pallas_op(q, k, v, causal,
                                                interpret=True)], dtype)


@pytest.mark.parametrize("dtype,hd,g", [
    pytest.param("float32", 16, 2, id="float32"),
    pytest.param("bfloat16", 16, 2, id="bfloat16"),
    pytest.param("float32", 64, 1, id="float32-d64g1"),
    pytest.param("bfloat16", 64, 1, id="bfloat16-d64g1")])
def test_attn_decode_matches_jax(dtype, hd, g):
    """Ragged cache positions, GQA g = 2 at head dim 16 and g = 1 at
    musicgen's head dim 64, fp32 output. The JAX ref and the port round
    the softmax weights to bf16 alike; the Pallas kernel keeps them fp32,
    which bf16's tolerance covers."""
    rng = np.random.default_rng(11)
    q, tq = _pair(rng.standard_normal((3, 4, hd), np.float32), dtype)
    k, tk = _pair(rng.standard_normal((3, 4 // g, 24, hd), np.float32), dtype)
    v, tv = _pair(rng.standard_normal((3, 4 // g, 24, hd), np.float32), dtype)
    cp = np.array([0, 10, 23], np.int32)
    out = attn_decode_ref(tq, tk, tv, torch.from_numpy(cp))
    assert out.dtype == torch.float32 and out.shape == (3, 4, hd)
    jcp = jnp.asarray(cp)
    _close(out, [jax_ad_ref.attn_decode_ref(q, k, v, jcp),
                 jax_ad_ops.attn_decode_pallas_op(q, k, v, jcp,
                                                  interpret=True)], dtype)


def test_precise_paged_plain_equals_contiguous_plain():
    """Both precise (MLA) modes are ported, contiguous and paged
    (tests/test_torch_mla.py and tests/test_torch_paged_hybrid.py hold
    them against JAX): on the latent of one page the paged plain version
    equals the contiguous one bit for bit."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8), np.float32))
    lat = torch.from_numpy(rng.standard_normal((2, 1, 4, 8), np.float32))
    cp = torch.tensor([2], dtype=torch.int32)
    got = paged_attention_ref(q, lat, lat, torch.ones(1, 1, dtype=torch.int32),
                              cp, precise=True)
    want = attn_decode_ref(q, lat[1:], lat[1:], cp, precise=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,v,nan_row", [
    pytest.param(3, 1000, None, id="3-1000"),
    pytest.param(2, 2500, None, id="2-2500"),
    # the served vocabularies at 4 live slots
    pytest.param(4, 50304, None, id="4-50304-xlstm-350m"),
    pytest.param(4, 64000, None, id="4-64000-yi-9b"),
    pytest.param(4, 65536, None, id="4-65536-jamba-v0.1-52b"),
    pytest.param(4, 102400, None, id="4-102400-deepseek-v2-lite-16b"),
    # a slot whose logits hold a NaN (a quarantined slot)
    pytest.param(4, 64000, 2, id="4-64000-nan-row")])
def test_entropy_matches_jax(m, v, nan_row, dtype):
    """V not a multiple of the Pallas vocab block (masked tail), and the
    served vocabularies. A row holding a NaN gives NaN on both sides, on
    exactly that row; the other rows agree."""
    rng = np.random.default_rng(m + v)
    a = rng.standard_normal((m, v), np.float32) * 4.0
    if nan_row is not None:
        a[nan_row, v // 3] = np.nan
    lg, tlg = _pair(a, dtype)
    out = entropy_ref(tlg)
    assert out.dtype == torch.float32 and out.shape == (m,)
    want = [jax_ee_ref.entropy_ref(lg),
            jax_ee_ops.entropy_pallas_op(lg, interpret=True)]
    nan = [r == nan_row for r in range(m)]
    for o in [out.numpy()] + want:
        assert np.isnan(np.asarray(o)).tolist() == nan
    # the entropy is computed in fp32 from the same (rounded) logits on
    # both sides, so fp32's tolerance holds for either input dtype (NaN
    # equals NaN here)
    _close(out, want, "float32")


def test_plain_ops_keep_jax_names():
    """Every op ported from the JAX package keeps its XAIF name; the one
    op of the port's own is ``gemm_heads`` (MLA's absorbed per-head
    products, plain einsums in JAX)."""
    assert xaif.ops() == ("attention", "attn_decode", "attn_decode_paged",
                          "entropy_exit", "gemm", "gemm_heads", "moe_decode",
                          "rmsnorm", "ssm_decode", "ssm_scan",
                          "verify_decode", "verify_decode_paged")
    with pytest.raises(ValueError):
        xaif.call("gemm", "pallas", torch.zeros(2, 2), torch.zeros(2, 2))


def test_require_aligned_refuses_offset_data():
    """The flash and verify kernels copy rows by 16-byte cp.async: a
    tensor whose data starts off a 16-byte boundary is refused."""
    from repro_torch.kernels._build import require_aligned
    base = torch.zeros(4, 128, dtype=torch.bfloat16)
    require_aligned("x", base, base[1:])          # rows of 256 bytes
    with pytest.raises(ValueError, match="16-byte boundary"):
        require_aligned("x", base.view(-1)[1:])


@pytest.mark.parametrize("case", ["attention_unaligned", "attention_dims",
                                  "verify_unaligned", "verify_rows",
                                  "verify_paged_unaligned"])
def test_flash_and_verify_wrappers_refuse_what_the_kernels_do_not_take(
        case, monkeypatch):
    """With the device check stubbed out (the kernels run only on the
    card), each wrapper raises before it launches, and counts no launch,
    on data off a 16-byte boundary, on head dims the flash kernel has no
    instance for ((96, 96)), and on more than 64 verify rows (g * K1)."""
    from repro_torch.kernels.attn_decode import ops as ad_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.verify_decode import ops as vd_ops
    monkeypatch.setattr(ad_ops, "require_cuda", lambda *a: None)
    monkeypatch.setattr(fa_ops, "require_cuda", lambda *a: None)
    bf = dict(dtype=torch.bfloat16)
    i32 = dict(dtype=torch.int32)

    def off(*shape):            # contiguous, data 2 bytes off a boundary
        n = int(np.prod(shape))
        return torch.zeros(n + 1, **bf)[1:].view(*shape)

    q4, kv = torch.zeros(1, 8, 4, 128, **bf), torch.zeros(1, 1, 32, 128, **bf)
    pools, table = torch.zeros(3, 1, 16, 128, **bf), torch.ones(1, 2, **i32)
    cp = torch.zeros(1, **i32)
    fa_q = torch.zeros(1, 4, 8, 128, **bf)
    calls = {
        "attention_unaligned": (fa_ops.attention, "16-byte", lambda: fa_ops
                                .attention(fa_q, off(1, 2, 8, 128),
                                           torch.zeros(1, 2, 8, 128, **bf))),
        "attention_dims": (fa_ops.attention, "head dims", lambda: fa_ops
                           .attention(*(torch.zeros(1, 2, 8, 96, **bf),) * 3)),
        "verify_unaligned": (vd_ops.verify_decode, "16-byte", lambda: vd_ops
                             .verify_decode(q4, off(1, 1, 32, 128), kv, cp)),
        "verify_rows": (vd_ops.verify_decode, "at most 64", lambda: vd_ops
                        .verify_decode(torch.zeros(1, 8, 9, 128, **bf), kv,
                                       kv, cp)),
        "verify_paged_unaligned": (
            vd_ops.verify_decode_paged, "16-byte",
            lambda: vd_ops.verify_decode_paged(q4, pools, off(3, 1, 16, 128),
                                               table, cp)),
    }
    fn, match, call = calls[case]
    before = fn.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert fn.launches == before


@pytest.mark.parametrize("case", ["gqa", "gqa_paged", "precise",
                                  "precise_paged"])
def test_decode_wrappers_refuse_unaligned_caches(case, monkeypatch):
    """The decode kernels (GQA and precise, contiguous and paged) stage
    their K/V or latent rows by 16-byte cp.async: with the device check
    stubbed out, each wrapper raises on a cache whose data starts off a
    16-byte boundary, before it launches, and counts no launch."""
    from repro_torch.kernels.attn_decode import ops as ad_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    monkeypatch.setattr(ad_ops, "require_cuda", lambda *a: None)
    bf, f32 = dict(dtype=torch.bfloat16), dict(dtype=torch.float32)
    i32 = dict(dtype=torch.int32)

    def off(*shape):            # contiguous, data 2 bytes off a boundary
        n = int(np.prod(shape))
        return torch.zeros(n + 1, **bf)[1:].view(*shape)

    cp, table = torch.zeros(1, **i32), torch.ones(1, 2, **i32)
    q, kv = torch.zeros(1, 8, 128, **bf), torch.zeros(1, 1, 32, 128, **bf)
    pools = torch.zeros(3, 1, 16, 128, **bf)
    qa, q2 = torch.zeros(1, 4, 512, **f32), torch.zeros(1, 4, 64, **f32)
    lat, kr = off(1, 1, 32, 512), torch.zeros(1, 1, 32, 64, **bf)
    cpool, kpool = off(3, 1, 16, 512), torch.zeros(3, 1, 16, 64, **bf)
    calls = {
        "gqa": (ad_ops.attn_decode,
                lambda: ad_ops.attn_decode(q, off(1, 1, 32, 128), kv, cp)),
        "gqa_paged": (pa_ops.attn_decode_paged,
                      lambda: pa_ops.attn_decode_paged(
                          q, pools, off(3, 1, 16, 128), table, cp)),
        "precise": (ad_ops.attn_decode,
                    lambda: ad_ops.attn_decode(qa, lat, lat, cp, q2=q2,
                                               k2=kr, precise=True)),
        "precise_paged": (pa_ops.attn_decode_paged,
                          lambda: pa_ops.attn_decode_paged(
                              qa, cpool, cpool, table, cp, q2=q2,
                              k2_pages=kpool, precise=True)),
    }
    fn, call = calls[case]
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte"):
        call()
    assert fn.launches == before
