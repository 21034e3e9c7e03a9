"""The port's MLA and the reduced deepseek-v2-lite-16b against the JAX
package's, from the same seeded numpy inputs and the same parameters.

Tolerances: 1e-5 for the precise (MLA) decode attention op: both sides
compute in fp32 from the same inputs and differ only in summation order.
1e-4 for the MLA mixer and the model at fp32, as in
``test_torch_model.py``: the projections go through XLA's and PyTorch's
CPU matmuls. Greedy tokens at fp32 must be equal; the slot engine's tokens
must equal ``generate``'s exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (SHAPES_BY_NAME, AccelConfig, RunConfig,
                                get_arch)
from repro.kernels.attn_decode import ops as jax_ad_ops
from repro.kernels.attn_decode import ref as jax_ad_ref
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import generate as jax_generate
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.gemm.ref import gemm_heads_ref
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve.engine import SlotEngine, SpecConfig, generate
from repro_torch.serve.scheduler import Request, serve

POLICY = AccelConfig()            # the JAX package's all-ref policy
TOL = 1e-4
TOL_OP = 1e-5
ARCH = "deepseek-v2-lite-16b"


def _configs(dtype="float32"):
    return (get_arch(ARCH).reduced(dtype=dtype),
            port_arch(ARCH).reduced(dtype=dtype))


def _params(jcfg, seed=0):
    jp = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _np(t):
    return t.float().numpy()


def test_configs_match_the_jax_package():
    for jcfg, pcfg in (_configs(), (get_arch(ARCH), port_arch(ARCH))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta", "dtype",
                  "norm_eps", "first_k_dense", "family"):
            assert getattr(jcfg, f) == getattr(pcfg, f), f
        assert dataclasses.asdict(jcfg.moe) == dataclasses.asdict(pcfg.moe)
        assert dataclasses.asdict(jcfg.mla) == dataclasses.asdict(pcfg.mla)
        assert jcfg.early_exit.exit_layers == pcfg.early_exit.exit_layers
        for i in range(jcfg.num_layers):
            assert (jcfg.layer_spec(i).mixer, jcfg.layer_spec(i).ffn) == \
                (pcfg.layer_spec(i).mixer, pcfg.layer_spec(i).ffn)
    assert lm._segments(_configs()[1]) == jlm._segments(_configs()[0])


def test_full_size_parameter_shapes_match_jax():
    """The full-size tree's shapes and dtypes equal ``jax.eval_shape`` of
    the JAX ``init_lm``, with nothing allocated on either side (the port
    builds it on the meta device): 15.7 B parameters."""
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
    assert isinstance(got["prefix"], list) and len(got["prefix"]) == 1
    assert got["slots"][0]["ffn"]["router"].dtype == torch.float32
    n = sum(b.numel() for _, b in pl)
    assert 15.6e9 < n < 15.8e9, n


def test_params_from_jax_carries_prefix_and_moe_mla_leaves():
    jcfg, _ = _configs(dtype="bfloat16")
    jp, pp = _params(jcfg)
    jl = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    pl = jax.tree_util.tree_leaves_with_path(pp)
    assert len(jl) == len(pl)
    for (path, a), (_, b) in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert isinstance(pp["prefix"], list)
    assert pp["slots"][0]["ffn"]["router"].dtype == torch.float32
    assert pp["slots"][0]["ffn"]["w_gate_e"].dtype == torch.bfloat16
    assert set(pp["prefix"][0]["mixer"]) == {"wq", "w_dkv", "kv_norm",
                                             "w_kr", "w_uk", "w_uv", "wo"}


# ---------------------------------------------------------------------------
# the precise (MLA) decode attention op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precise_attn_decode_matches_jax(dtype):
    """q fp32 [B, H, r] and q2 [B, H, rd] against a latent that is both K
    and V [B, 1, S, r] plus a rotary key [B, 1, S, rd], ragged lengths."""
    b, h, r, rd, s = 3, 4, 32, 8, 24
    rng = np.random.default_rng(21)
    q = rng.standard_normal((b, h, r), np.float32)
    q2 = rng.standard_normal((b, h, rd), np.float32)
    lat = jnp.asarray(rng.standard_normal((b, 1, s, r), np.float32),
                      jnp.dtype(dtype))
    kr = jnp.asarray(rng.standard_normal((b, 1, s, rd), np.float32),
                     jnp.dtype(dtype))
    cp = np.array([0, 11, 23], np.int32)
    scale = 0.2
    tl = torch.from_numpy(np.array(lat.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tk = torch.from_numpy(np.array(kr.astype(jnp.float32))).to(
        getattr(torch, dtype))
    out = attn_decode_ref(torch.from_numpy(q), tl, tl, torch.from_numpy(cp),
                          scale=scale, q2=torch.from_numpy(q2), k2=tk,
                          precise=True)
    assert out.dtype == torch.float32 and out.shape == (b, h, r)
    args = (jnp.asarray(q), lat, lat, jnp.asarray(cp))
    kw = dict(scale=scale, q2=jnp.asarray(q2), k2=kr, precise=True)
    for want in (jax_ad_ref.attn_decode_ref(*args, **kw),
                 jax_ad_ops.attn_decode_pallas_op(*args, **kw, bs=8,
                                                  interpret=True)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=TOL_OP, atol=TOL_OP)


@pytest.mark.parametrize("transpose_w", [True, False])
def test_gemm_heads_matches_the_jax_einsums(transpose_w):
    """The absorbed decode's per-head products: "bhd,lhd->bhl" (absorb
    W_uk into the query) and "bhl,lhd->bhd" (decompress the pooled
    latent), fp32."""
    rng = np.random.default_rng(22)
    w = rng.standard_normal((32, 4, 16), np.float32)
    x = rng.standard_normal((3, 4, 16 if transpose_w else 32), np.float32)
    eq = "bhd,lhd->bhl" if transpose_w else "bhl,lhd->bhd"
    want = jnp.einsum(eq, jnp.asarray(x), jnp.asarray(w))
    got = gemm_heads_ref(torch.from_numpy(x), torch.from_numpy(w),
                         transpose_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_OP,
                               atol=TOL_OP)


# ---------------------------------------------------------------------------
# the MLA mixer
# ---------------------------------------------------------------------------


def _mla(jcfg, seed=0):
    jp = jattn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def test_apply_mla_prefill_and_decode_match_jax():
    """Prefill 7 tokens into a 16-position cache, then 4 absorbed decode
    steps at ragged positions; outputs and cached latents agree."""
    jcfg, pcfg = _configs()
    jp, pp = _mla(jcfg)
    rng = np.random.default_rng(23)
    b, t, s = 3, 7, 16
    x = rng.standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    jc = jattn.init_mla_cache(jcfg, b, s, jnp.float32)
    pc = attn.MLACache(*(c[0] for c in attn.init_mla_cache(
        pcfg, b, s, torch.float32, "cpu", layers=1)))
    jy, jc = jattn.apply_mla(jp, jnp.asarray(x), jcfg, POLICY, cache=jc)
    py, pc = attn.apply_mla(pp, torch.from_numpy(x), pcfg, "auto", pc)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for a, c in ((pc.c_kv, jc.c_kv), (pc.k_rope, jc.k_rope)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=TOL,
                                   atol=TOL)
    pos = np.array([7, 3, 5], np.int32)
    for step in range(4):
        xt = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jattn.apply_mla_decode(jp, jnp.asarray(xt), jcfg, POLICY,
                                        jc, jnp.asarray(pos))
        py, pc = attn.apply_mla_decode(pp, torch.from_numpy(xt), pcfg,
                                       "auto", pc, torch.from_numpy(pos))
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(pc.c_kv.numpy(), np.asarray(jc.c_kv),
                                   rtol=TOL, atol=TOL)
        pos = pos + 1


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_prefill_and_decode_logits_match():
    """Teacher-forced: prefill then 6 decode steps with a live mask (slot
    1 dead); final and exit logits agree at every step."""
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    rng = np.random.default_rng(24)
    prompt = rng.integers(0, 256, (3, 8), np.int32)
    feed = rng.integers(0, 256, (6, 3), np.int32)
    live = np.array([True, False, True])
    jlog, jc = jlm.forward_prefill(jp, jnp.asarray(prompt), jcfg, POLICY,
                                   jlm.init_cache(jcfg, 3, 16))
    plog, pc = lm.forward_prefill(pp, torch.from_numpy(prompt), pcfg, "auto",
                                  lm.init_cache(pcfg, 3, 16, device="cpu"))
    np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(pc.c_kv[0]),
                               np.asarray(jc.prefix[0].c_kv), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(pc.c_kv[1:]), np.asarray(jc.slots[0].c_kv),
                               rtol=TOL, atol=TOL)
    for step in range(6):
        tok = feed[step][:, None]
        jlog, jex, jc = jlm.forward_decode(jp, jnp.asarray(tok), jcfg,
                                           POLICY, jc,
                                           live=jnp.asarray(live))
        plog, pex, pc = lm.forward_decode(pp, torch.from_numpy(tok), pcfg,
                                          "auto", pc,
                                          live=torch.from_numpy(live))
        np.testing.assert_allclose(_np(plog), np.asarray(jlog), rtol=TOL,
                                   atol=TOL)
        assert len(pex) == len(jex) == 1
        np.testing.assert_allclose(_np(pex[0]), np.asarray(jex[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))


def test_greedy_tokens_match_jax_generate():
    jcfg, pcfg = _configs()
    jp, pp = _params(jcfg)
    run = RunConfig(arch=jcfg, shape=SHAPES_BY_NAME["decode_32k"],
                    accel=POLICY)
    prompt = np.random.default_rng(25).integers(0, 256, (2, 6), np.int32)
    jtok = np.asarray(jax_generate(run, jp, jnp.asarray(prompt), 8)[0])
    ptok, _ = generate(pcfg, pp, prompt, 8, device="cpu")
    np.testing.assert_array_equal(ptok.numpy(), jtok)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_engine_tokens_equal_generate(dtype):
    """6 requests of ragged lengths through 3 slots (backfill): every
    request's tokens equal ``generate`` on its prompt alone. MoE archs
    prefill at the exact prompt length (no bucket)."""
    _, pcfg = _configs(dtype)
    pp = lm.init_lm(pcfg, seed=0, device="cpu")
    rng = np.random.default_rng(26)
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


def test_paged_spec_and_verify_raise_for_mla():
    """The paged engine serves MLA (latent page pools, no GQA pools);
    speculative decoding and verify stay refused for MLA, as in JAX."""
    _, pcfg = _configs()
    engine = SlotEngine(pcfg, capacity=2, max_len=16, device="cpu",
                        paged=True, page_size=4)
    cache, _ = engine.init_state()
    m = pcfg.mla
    assert cache.c_kv_pages.shape == (pcfg.num_layers, 9, 4, m.kv_lora_rank)
    assert cache.k_rope_pages.shape == (pcfg.num_layers, 9, 4,
                                        m.qk_rope_head_dim)
    assert cache.k_pages is None and cache.conv is None
    with pytest.raises(ValueError, match="MLA"):
        SlotEngine(dataclasses.replace(pcfg, early_exit=None), capacity=2,
                   max_len=16, device="cpu",
                   spec=SpecConfig(draft_arch=port_arch("yi-9b").reduced(
                       early_exit=None), k=2))
    pp = lm.init_lm(pcfg, device="cpu")
    for cache in (lm.init_cache(pcfg, 2, 16, device="cpu"),
                  lm.init_paged_cache(pcfg, 2, 16, 4, 9, device="cpu")):
        with pytest.raises(ValueError, match="MLA"):
            lm.forward_verify(pp, torch.zeros(2, 3, dtype=torch.int32), pcfg,
                              "auto", cache)


# ---------------------------------------------------------------------------
# no fallback: the new kernel wrappers refuse CPU tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["attn_decode_mla", "gemm_heads",
                                  "moe_decode", "attention_192_128"])
def test_new_kernel_wrappers_raise_on_cpu_tensors(name):
    """The wrapper of each kernel this slice adds raises on a CPU tensor
    and counts no launch: on the card ``policy="auto"`` launches the
    kernel or fails, it never falls back to the plain version."""
    from repro_torch.core import xaif
    from repro_torch.kernels.attn_decode.ops import attn_decode
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.gemm.ops import gemm_heads
    from repro_torch.kernels.moe_decode.ops import moe_decode
    f32, i32 = torch.float32, torch.int32
    lat = torch.zeros(1, 1, 8, 512, dtype=torch.bfloat16)
    calls = {
        "attn_decode_mla": lambda: attn_decode(
            torch.zeros(1, 16, 512), lat, lat, torch.zeros(1, dtype=i32),
            scale=0.1, q2=torch.zeros(1, 16, 64),
            k2=torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16), precise=True),
        "gemm_heads": lambda: gemm_heads(torch.zeros(2, 4, 8),
                                         torch.zeros(16, 4, 8), True),
        "moe_decode": lambda: moe_decode(
            torch.zeros(2, 8), torch.zeros(2, 2, dtype=i32),
            torch.ones(2, 2, dtype=f32), torch.zeros(4, 8, 6),
            torch.zeros(4, 8, 6), torch.zeros(4, 6, 8)),
        "attention_192_128": lambda: attention(
            torch.zeros(1, 2, 4, 192), torch.zeros(1, 2, 4, 192),
            torch.zeros(1, 2, 4, 128)),
    }
    before = xaif.launch_counts()
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        calls[name]()
    assert xaif.launch_counts() == before
