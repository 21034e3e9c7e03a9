"""The port's shape-aware dispatch (``repro_torch.core.xaif``: buckets,
``DispatchPolicy``, the ``supports`` fallback, the ``blockwise`` and
``assoc`` backends) and measured autotune (``repro_torch.core.autotune``,
the launcher's ``--policy`` / ``--autotune``) against the JAX package's.

On the CPU, at reduced sizes: bucket classes at every boundary, the
lookup chain and the fallback order for the same table (JAX's ``pallas``
named ``kernel``, ``pallas_int8`` named ``int8``), JSON round trips and
the refusal of a JAX-written file, the cost functions, ``blockwise`` and
``assoc`` from the same numpy inputs (fp32 1e-5, bf16 1e-2), the generic
and per-arch autotune cells' shapes, and reduced chatglm3 served under a
DispatchPolicy with JAX's tokens under the mapped policy (fp32, so the
tokens are held exactly). About 35 s alone (one torch thread).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES_BY_NAME, RunConfig, get_arch
from repro.core import autotune as jtune
from repro.core import xaif as jxaif
from repro.kernels.attn_decode import ops as jax_ad_ops
from repro.kernels.entropy_exit import ops as jax_ee_ops
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.gemm import ops as jax_gemm_ops
from repro.kernels.moe_decode import ops as jax_moe_ops
from repro.kernels.paged_attention import ops as jax_pa_ops
from repro.kernels.rmsnorm import ops as jax_rn_ops
from repro.kernels.ssm_decode import ops as jax_sd_ops
from repro.kernels.ssm_scan import ops as jax_ss_ops
from repro.kernels.verify_decode import ops as jax_vd_ops
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import SlotEngine as JaxSlotEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import serve as jax_serve
from repro_torch.configs.base import RunConfig as PortRunConfig
from repro_torch.configs.base import get_arch as port_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune, xaif
from repro_torch.kernels.attn_decode import ops as ad_ops
from repro_torch.kernels.entropy_exit import ops as ee_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gemm import ops as gemm_ops
from repro_torch.kernels.moe_decode import ops as moe_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.ssm_decode import ops as sd_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.verify_decode import ops as vd_ops
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as attn
from repro_torch.serve.engine import SlotEngine
from repro_torch.serve.scheduler import Request, serve

# JAX backend name -> the port's
TO_PORT = {"pallas": "kernel", "pallas_int8": "int8"}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-350m",
         "qwen3-moe-30b-a3b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU runs here are many small ops: one intra-op thread
    each (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _shapes(args):
    return tuple(tuple(a.shape) for a in args)


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------

_D = (4, 4, 32)                  # a decode query [B, Hq, D]
_V = (4, 4, 3, 32)               # a verify query [B, Hq, K1, D]
_MOE = lambda e: ((4, 64), (4, 2), (4, 2), (e, 64, 32), (e, 64, 32),  # noqa
                  (e, 32, 64))
BUCKET_CASES = [
    ("gemm", ((32, 64), (64, 64))), ("gemm", ((33, 64), (64, 64))),
    ("gemm", ((4, 8, 64), (64, 64))), ("gemm", ((4, 9, 64), (64, 64))),
    ("gemm", ((2048, 64), (64, 8))), ("gemm", ((2049, 64), (64, 8))),
    ("rmsnorm", ((32, 16), (16,))), ("rmsnorm", ((1, 33, 16), (16,))),
    ("rmsnorm", ((2048, 16), (16,))), ("rmsnorm", ((2049, 16), (16,))),
    ("entropy_exit", ((4, 1, 100),)), ("entropy_exit", ((2049, 100),)),
    ("attention", ((2, 4, 1, 32), (2, 2, 64, 32), (2, 2, 64, 32))),
    ("attention", ((2, 4, 2, 32), (2, 2, 64, 32), (2, 2, 64, 32))),
    ("ssm_scan", ((2, 1, 16),)), ("ssm_scan", ((2, 2, 16),)),
    ("ssm_decode", ((4, 32), (4, 32))), ("ssm_decode", ((4, 4, 16),)),
    ("attn_decode", (_D, (4, 2, 1024, 32), (4, 2, 1024, 32), (4,))),
    ("attn_decode", (_D, (4, 2, 1025, 32), (4, 2, 1025, 32), (4,))),
    # the precise (MLA) call: q fp32 [B, H, r], the latent [B, 1, S, r]
    ("attn_decode", ((4, 16, 512), (4, 1, 160, 512), (4, 1, 160, 512),
                     (4,))),
    ("attn_decode_paged", (_D, (9, 2, 16, 32), (9, 2, 16, 32), (4, 64),
                           (4,))),
    ("attn_decode_paged", (_D, (9, 2, 1, 32), (9, 2, 1, 32), (4, 1025),
                           (4,))),
    ("attn_decode_paged", ((4, 16, 512), (41, 1, 16, 512),
                           (41, 1, 16, 512), (4, 10), (4,))),
    ("verify_decode", (_V, (4, 2, 1024, 32), (4, 2, 1024, 32), (4,))),
    ("verify_decode", (_V, (4, 2, 1025, 32), (4, 2, 1025, 32), (4,))),
    ("verify_decode_paged", (_V, (9, 2, 16, 32), (9, 2, 16, 32), (4, 64),
                             (4,))),
    ("verify_decode_paged", (_V, (9, 2, 16, 32), (9, 2, 16, 32), (4, 65),
                             (4,))),
    ("moe_decode", _MOE(16)), ("moe_decode", _MOE(17)),
    # the port's own op: JAX gives an unknown op the row classes
    ("gemm_heads", ((4, 8, 64), (64, 8, 16))),
    ("gemm_heads", ((5, 8, 64), (8, 64, 16))),
    # malformed -> the wildcard
    ("gemm", ()), ("attention", ((2, 4),)), ("ssm_scan", ((2,),)),
    ("attn_decode_paged", (_D,)), ("moe_decode", ((4, 64),)),
    ("verify_decode", ((4, 4, 3, 32),)),
]


@pytest.mark.parametrize("op,shapes", BUCKET_CASES,
                         ids=[f"{o}-{i}" for i, (o, _) in
                              enumerate(BUCKET_CASES)])
def test_shape_bucket_matches_jax(op, shapes):
    want = jxaif.shape_bucket(op, shapes)
    assert xaif.shape_bucket(op, shapes) == want
    # memoised: the same answer again, from torch.Size shapes too
    assert xaif.shape_bucket(op, [torch.Size(s) for s in shapes],
                             torch.bfloat16) == want


def test_op_buckets_match_jax():
    for op in set(xaif.ops()) | set(jxaif._OP_BUCKETS):
        assert xaif.op_buckets(op) == jxaif.op_buckets(op), op
    assert xaif.shape_bucket("gemm", None) == xaif.WILDCARD


def test_call_sites_give_jax_buckets():
    """The MLA absorbed decode, contiguous and paged, dispatches the same
    (op, bucket) sequence in both packages: the port's argument positions
    (the latent as k and v, the page table fourth) are JAX's."""
    jcfg = get_arch("deepseek-v2-lite-16b").reduced(dtype="float32")
    pcfg = port_arch("deepseek-v2-lite-16b").reduced(dtype="float32")
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    m = pcfg.mla
    rng = np.random.default_rng(3)
    b, ps, s = 3, 4, 16
    lat = rng.standard_normal((b, s, m.kv_lora_rank), np.float32)
    kr = rng.standard_normal((b, s, m.qk_rope_head_dim), np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    pos = np.array([6, 11, 2], np.int32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    seen = {"jax": [], "port": []}

    def spy(mod, key, shapes_of):
        real = mod.call

        def call(op, policy, *args, **kwargs):
            seen[key].append((op, mod.shape_bucket(op, shapes_of(args))))
            return real(op, policy, *args, **kwargs)
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(jxaif, "call", spy(jxaif, "jax", jxaif._shapes_of))
    mp.setattr(xaif, "call", spy(xaif, "port", xaif._shapes_of))
    try:
        # JAX's side traced abstractly (its calls see the shapes only)
        jax.eval_shape(lambda: jattn.apply_mla_decode(
            jp, jnp.asarray(x), jcfg, jxaif.AccelConfig(),
            jattn.MLACache(jnp.asarray(lat), jnp.asarray(kr)),
            jnp.asarray(pos)))
        attn.apply_mla_decode(pp, _t(x), pcfg, "ref",
                              attn.MLACache(_t(lat), _t(kr)), _t(pos, "int32"))
        pool = (b * 4 + 1, ps)
        jax.eval_shape(lambda: jattn.apply_mla_decode_paged(
            jp, jnp.asarray(x), jcfg, jxaif.AccelConfig(),
            jattn.PagedMLACache(jnp.zeros(pool + (m.kv_lora_rank,)),
                                jnp.zeros(pool + (m.qk_rope_head_dim,))),
            jnp.asarray(pos), jnp.asarray(table)))
        attn.apply_mla_decode_paged(
            pp, _t(x), pcfg, "ref",
            attn.PagedMLACache(torch.zeros(pool + (m.kv_lora_rank,)),
                               torch.zeros(pool + (m.qk_rope_head_dim,))),
            _t(pos, "int32"), _t(table, "int32"))
    finally:
        mp.undo()
    # the port runs MLA's two absorbed products as gemm_heads (plain
    # einsums in JAX): the rest is JAX's sequence
    port = [c for c in seen["port"] if c[0] != "gemm_heads"]
    assert port == seen["jax"]
    assert ("attn_decode", "kv_s") in port
    assert ("attn_decode_paged", "kv_s") in port


# ---------------------------------------------------------------------------
# DispatchPolicy: lookup chain, fallback, JSON, lossy rules
# ---------------------------------------------------------------------------


def _mapped(table):
    return {k: TO_PORT.get(v, v) for k, v in table.items()}


TABLE = {("gemm", "rows_s"): "pallas", "gemm": "ref",
         ("attention", "prefill"): "blockwise",
         ("rmsnorm", "rows_m"): "ref", ("ssm_scan", "scan"): "assoc",
         "moe_decode": "pallas"}


@pytest.mark.parametrize("default", ["ref", "pallas"])
def test_lookup_chain_matches_jax(default):
    jpol = jxaif.DispatchPolicy.make(TABLE, default=default)
    ppol = xaif.DispatchPolicy.make(_mapped(TABLE),
                                    default=TO_PORT.get(default, default))
    for op in set(xaif.ops()) & set(jxaif.ops()):
        for bucket in jxaif.op_buckets(op) + (xaif.WILDCARD, "other"):
            want = jpol.backend_for(op, bucket)
            assert ppol.backend_for(op, bucket) == TO_PORT.get(want, want), \
                (op, bucket)


def _probe_backends(mp):
    """A throwaway op with the same backends and ``supports`` in both
    registries: the default kernel takes at most 8 rows, ``alt`` at most
    32, ``lossy`` anything; the registries are put back afterwards."""
    def rows_at_most(n):
        return lambda shapes, dtype: shapes[0][0] <= n

    def plain(x):
        return x

    def kernel(x):
        return x + 1
    kernel.launches = 0
    for name, fn, sup, lossy in (("ref", plain, None, False),
                                 ("pallas", kernel, rows_at_most(8), False),
                                 ("alt", plain, rows_at_most(32), False),
                                 ("lossy", plain, None, True)):
        mp.setitem(jxaif._REGISTRY, ("_probe", name), jxaif.BackendEntry(
            "_probe", name, fn, supports=sup, lossy=lossy))
    mp.setitem(xaif._REGISTRY, "_probe",
               xaif.OpEntry("_probe", plain, kernel,
                            supports=rows_at_most(8)))
    mp.setitem(xaif._NAMED, ("_probe", "alt"),
               xaif.OpEntry("_probe", plain, plain,
                            supports=rows_at_most(32)))
    mp.setitem(xaif._NAMED, ("_probe", "lossy"),
               xaif.OpEntry("_probe", plain, plain, lossy=True))
    xaif._route.cache_clear()


@pytest.mark.parametrize("default", ["ref", "pallas"])
def test_supports_fallback_order_matches_jax(default, monkeypatch):
    """For each rule and each shape, the backend both packages resolve is
    the same (names mapped): a rejecting rule falls to the default, then
    to ref; every fallback of a call is counted by (op, bucket, from,
    to)."""
    _probe_backends(monkeypatch)
    try:
        for rule in ("pallas", "alt", "ref", "lossy"):
            table = {"_probe": rule}
            jpol = jxaif.DispatchPolicy.make(table, default=default)
            ppol = xaif.DispatchPolicy.make(
                _mapped(table), default=TO_PORT.get(default, default),
                allow_lossy=True)
            for rows in (4, 16, 64):
                shapes = ((rows, 8),)
                want = jxaif.resolve("_probe", jpol, shapes).name
                got = xaif.resolve("_probe", ppol, shapes)
                assert got.name == TO_PORT.get(want, want), (rule, rows)
                xaif.reset_launch_counts()
                out = xaif.call("_probe", ppol, torch.zeros(rows, 8))
                assert torch.equal(out, torch.zeros(rows, 8))  # CPU: plain
                moved = xaif.fallback_counts()
                name = TO_PORT.get(rule, rule)
                if got.name == name:
                    assert moved == {}
                else:
                    bucket = xaif.shape_bucket("_probe", shapes)
                    assert moved == {("_probe", bucket, name, got.name): 1}
        xaif.reset_launch_counts()
        assert xaif.fallback_counts() == {}
    finally:
        xaif._route.cache_clear()


def test_kernel_supports_fall_back_as_jax_on_mla_heads():
    """JAX's own case (``test_supports_predicate_falls_back``): v's head
    dim differs from q's and no kernel instance takes it, so the prefill
    rule falls back to ref in both packages, also when the default is the
    kernel itself; shapes the fp32 kernel has an instance for stay on
    it."""
    q, k, v = (1, 2, 4, 16), (1, 2, 8, 16), (1, 2, 8, 8)
    for default in ("ref", "pallas"):
        jpol = jxaif.DispatchPolicy.make({("attention", "prefill"): "pallas"},
                                         default=default)
        ppol = xaif.DispatchPolicy.make({("attention", "prefill"): "kernel"},
                                        default=TO_PORT.get(default, default))
        assert jxaif.resolve("attention", jpol, (q, k, v)).name == "ref"
        assert xaif.resolve("attention", ppol, (q, k, v),
                            torch.float32).name == "ref"
    assert xaif.resolve("attention", ppol, (q, k, (1, 2, 8, 16)),
                        torch.float32).name == "kernel"
    # the port's kernel has MLA's (192, 128) instance, which JAX's lacks
    mla = ((1, 2, 4, 192), (1, 2, 8, 192), (1, 2, 8, 128))
    assert xaif.resolve("attention", ppol, mla,
                        torch.bfloat16).name == "kernel"
    assert jxaif.resolve("attention", jpol, mla).name == "ref"


def test_policy_json_roundtrip_lossless(tmp_path):
    pol = xaif.DispatchPolicy.make(
        {("gemm", "rows_s"): "kernel",
         ("gemm", "rows_l"): "int8", ("attention", "decode"): "blockwise",
         ("ssm_scan", "scan"): "assoc", "rmsnorm": "ref"},
        default="ref", allow_lossy=True)
    doc = pol.to_json()
    assert json.loads(doc)["package"] == "repro_torch"
    back = xaif.DispatchPolicy.from_json(doc)
    assert back == pol and hash(back) == hash(pol)
    assert back.to_json() == doc                   # a fixpoint
    meta = pol.to_json(measurements=[{"op": "gemm", "us": 1.0}])
    assert xaif.DispatchPolicy.from_json(meta) == pol
    path = tmp_path / "p.json"
    pol.save(path)
    assert xaif.DispatchPolicy.load(path) == pol
    assert xaif.DispatchPolicy() == xaif.DispatchPolicy.make({})
    assert {xaif.DispatchPolicy(): 1}[xaif.DispatchPolicy.from_policy(
        "auto")] == 1


def test_policy_json_refuses_a_jax_file():
    jpol = jxaif.DispatchPolicy.make({("gemm", "rows_s"): "pallas",
                                      "rmsnorm": "ref"})
    with pytest.raises(ValueError, match="pallas -> kernel, pallas_int8 "
                                         "-> int8"):
        xaif.DispatchPolicy.from_json(jpol.to_json())


def test_lossy_rule_needs_allow_lossy():
    with pytest.raises(ValueError, match="lossy"):
        xaif.DispatchPolicy.make({("gemm", "rows_m"): "int8"})
    pol = xaif.DispatchPolicy.make({("gemm", "rows_m"): "int8"},
                                   allow_lossy=True)
    assert pol.backend_for("gemm", "rows_m") == "int8"
    with pytest.raises(ValueError, match="has no backend"):
        xaif.DispatchPolicy.make({"gemm": "pallas"})
    with pytest.raises(ValueError, match="default"):
        xaif.DispatchPolicy(default="int8")
    with pytest.raises(ValueError, match="lossy"):
        xaif.DispatchPolicy.from_policy(xaif.Policy({"gemm": "int8"},
                                                    allow_lossy=True,
                                                    mode="ref"))
    assert xaif.DispatchPolicy.from_policy(
        xaif.Policy({"gemm": "int8"}, allow_lossy=True)) == pol.make(
        {"gemm": "int8"}, allow_lossy=True)
    assert xaif.DispatchPolicy.from_policy("ref").default == "ref"


def test_other_policies_compute_no_bucket(monkeypatch):
    """Under "auto", "ref" and a Policy, call takes its earlier path: no
    bucket is computed (the memoised bucket function is never reached)."""
    def no_bucket(*args):
        raise AssertionError("a bucket was computed")
    monkeypatch.setattr(xaif, "_bucket", no_bucket)
    xaif._route.cache_clear()
    x, s = torch.randn(3, 8), torch.rand(8) + 0.5
    want = xaif.entry("rmsnorm").plain(x, s)
    for policy in ("auto", "ref", xaif.Policy()):
        assert torch.equal(xaif.call("rmsnorm", policy, x, s), want)
    with pytest.raises(AssertionError, match="bucket"):
        xaif.call("rmsnorm", xaif.DispatchPolicy(), x, s)


def test_empty_dispatch_policy_equals_auto():
    """An empty DispatchPolicy runs what "auto" runs, bitwise, on every
    generic autotune cell; it falls back to ref (counted, once a call)
    exactly on the cells whose shapes no kernel instance takes."""
    xaif.reset_launch_counts()
    want = {}
    for (op, bucket), build in autotune.CELLS.items():
        args, kwargs = build("cpu")
        a = xaif.call(op, "auto", *args, **kwargs)
        b = xaif.call(op, xaif.DispatchPolicy(), *args, **kwargs)
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert torch.equal(x, y), op
        if not xaif.backend(op, "kernel").accepts(_shapes(args),
                                                  args[0].dtype):
            want[(op, bucket, "kernel", "ref")] = 1
    assert xaif.fallback_counts() == want
    # the generic cells the kernels take (fp32, JAX's toy sizes)
    assert {(o, b) for o, b in autotune.CELLS} - {k[:2] for k in want} == {
        ("gemm", "rows_s"), ("gemm", "rows_m"), ("gemm", "rows_l"),
        ("rmsnorm", "rows_s"), ("rmsnorm", "rows_m"), ("rmsnorm", "rows_l"),
        ("entropy_exit", "rows_s"), ("entropy_exit", "rows_m"),
        ("entropy_exit", "rows_l"), ("ssm_decode", "mlstm"),
        ("moe_decode", "e_s"), ("moe_decode", "e_l")}


# ---------------------------------------------------------------------------
# Cost functions, blockwise, assoc
# ---------------------------------------------------------------------------

COSTS = [
    (gemm_ops.gemm_cost, jax_gemm_ops.gemm_cost, (4, 4096, 11008)),
    (rn_ops.rmsnorm_cost, jax_rn_ops.rmsnorm_cost, (4, 4096)),
    (ee_ops.entropy_cost, jax_ee_ops.entropy_cost, (4, 64000)),
    (fa_ops.attention_cost, jax_fa_ops.attention_cost, (4, 32, 128, 128,
                                                        128)),
    (ad_ops.attn_decode_cost, jax_ad_ops.attn_decode_cost, (4, 32, 160,
                                                            128)),
    (pa_ops.paged_attention_cost, jax_pa_ops.paged_attention_cost,
     (4, 32, 10, 16, 128)),
    (vd_ops.verify_decode_cost, jax_vd_ops.verify_decode_cost,
     (4, 32, 5, 160, 128)),
    (vd_ops.verify_decode_paged_cost, jax_vd_ops.verify_decode_paged_cost,
     (4, 32, 5, 10, 16, 128)),
    (moe_ops.moe_decode_cost, jax_moe_ops.moe_decode_cost,
     (4, 6, 2048, 1408, 64)),
    (ss_ops.ssm_cost, jax_ss_ops.ssm_cost, (1, 120, 8192, 16)),
    (sd_ops.ssm_decode_cost, jax_sd_ops.ssm_decode_cost, (4, 8192, 16)),
]


@pytest.mark.parametrize("port,jax_fn,dims", COSTS,
                         ids=[c[0].__name__ for c in COSTS])
def test_cost_functions_match_jax(port, jax_fn, dims):
    assert port(*dims) == jax_fn(*dims)
    assert port(*dims, dtype_bytes=4) == jax_fn(*dims, dtype_bytes=4)
    op = {"gemm_cost": "gemm", "rmsnorm_cost": "rmsnorm",
          "entropy_cost": "entropy_exit", "attention_cost": "attention",
          "attn_decode_cost": "attn_decode",
          "paged_attention_cost": "attn_decode_paged",
          "verify_decode_cost": "verify_decode",
          "verify_decode_paged_cost": "verify_decode_paged",
          "moe_decode_cost": "moe_decode", "ssm_cost": "ssm_scan",
          "ssm_decode_cost": "ssm_decode"}[port.__name__]
    assert xaif.entry(op).cost_fn is port


BLOCKWISE = {  # (b, hq, hkv, t, s, d, dv, causal, bq, bkv)
    "gqa": (2, 4, 2, 8, 8, 16, 16, True, 4, 4),
    "mla_dv": (1, 2, 2, 6, 6, 24, 16, True, 512, 1024),
    "s_gt_t": (2, 4, 1, 5, 12, 16, 16, True, 4, 4),
    "noncausal": (1, 2, 2, 4, 12, 8, 8, False, 2, 8),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BLOCKWISE))
def test_blockwise_matches_jax(case, dtype):
    b, hq, hkv, t, s, d, dv, causal, bq, bkv = BLOCKWISE[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, hq, t, d), np.float32)
    k = rng.standard_normal((b, hkv, s, d), np.float32)
    v = rng.standard_normal((b, hkv, s, dv), np.float32)
    jd = jnp.dtype(dtype)
    want = jax_fa_ops.attention_blockwise_op(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal,
        None, bq=bq, bkv=bkv)
    got = fa_ops.attention_blockwise(_t(q, dtype), _t(k, dtype),
                                     _t(v, dtype), causal, bq=bq, bkv=bkv)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, hq, t, dv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    # and through the op, on the registry's name
    pol = xaif.DispatchPolicy.make({"attention": "blockwise"})
    out = xaif.call("attention", pol, _t(q, dtype), _t(k, dtype),
                    _t(v, dtype), causal)
    ref = xaif.entry("attention").plain(_t(q, dtype), _t(k, dtype),
                                        _t(v, dtype), causal)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_assoc_scan_matches_jax(with_h0, dtype):
    bsz, t, din, n, chunk = 2, 12, 8, 4, 4          # three chunks of 4
    rng = np.random.default_rng(9)
    u = rng.standard_normal((bsz, t, din), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, din)))).astype(
        np.float32)
    a = -np.abs(rng.standard_normal((din, n), np.float32))
    b = rng.standard_normal((bsz, t, n), np.float32)
    c = rng.standard_normal((bsz, t, n), np.float32)
    d = rng.standard_normal((din,), np.float32)
    h0 = rng.standard_normal((bsz, din, n), np.float32) if with_h0 else None
    jd = jnp.dtype(dtype)
    jy, jh = jax_ss_ops.ssm_assoc_op(
        jnp.asarray(u, jd), jnp.asarray(dt, jd), jnp.asarray(a),
        jnp.asarray(b, jd), jnp.asarray(c, jd), jnp.asarray(d),
        None if h0 is None else jnp.asarray(h0), chunk=chunk)
    args = (_t(u, dtype), _t(dt, dtype), _t(a), _t(b, dtype), _t(c, dtype),
            _t(d), None if h0 is None else _t(h0))
    py, ph = ss_ops.ssm_scan_assoc(*args, chunk=chunk)
    assert py.dtype == getattr(torch, dtype) and ph.dtype == torch.float32
    np.testing.assert_allclose(py.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # against the sequential plain version, through the op
    pol = xaif.DispatchPolicy.make({("ssm_scan", "scan"): "assoc"})
    y2, h2 = xaif.call("ssm_scan", pol, *args)
    y1, h1 = ss_ops.ssm_scan_assoc(*args)          # one chunk of 12
    assert torch.equal(y2, y1) and torch.equal(h2, h1)
    ry, rh = xaif.entry("ssm_scan").plain(*args)
    for got, want in ((py, ry), (ph, rh), (y1, ry), (h1, rh)):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


def test_backends_without_a_kernel_have_no_counter():
    counters = set(xaif.launch_counts())
    assert not any("blockwise" in c or "assoc" in c for c in counters)
    for op, name in (("attention", "blockwise"), ("ssm_scan", "assoc")):
        e = xaif.entry(op, name)
        assert e.plain is e.kernel and not e.lossy


# ---------------------------------------------------------------------------
# Autotune cells
# ---------------------------------------------------------------------------


def _jax_cell(build):
    """A JAX cell's (args, kwargs) at its scale 1 as shapes and dtypes
    (traced abstractly: nothing is drawn)."""
    return jax.eval_shape(lambda: build(1))


def _same_kwargs(kw, jkw):
    """The same keywords; the tensors among them of JAX's shapes."""
    assert set(kw) == set(jkw)
    for k, v in kw.items():
        if isinstance(v, torch.Tensor):
            assert tuple(v.shape) == tuple(jkw[k].shape), k


@pytest.mark.parametrize("key", list(jtune.CELLS), ids="/".join)
def test_generic_cells_match_jax(key):
    assert set(autotune.CELLS) == set(jtune.CELLS)
    jargs, jkw = _jax_cell(jtune.CELLS[key])
    args, kw = autotune.CELLS[key]("cpu")
    assert _shapes(args) == _shapes(jargs), key
    _same_kwargs(kw, jkw)
    assert all(a.dtype in (torch.float32, torch.int32) for a in args)
    assert xaif.shape_bucket(key[0], _shapes(args)) == key[1]
    assert autotune._cost_args(key[0], _shapes(args)) == \
        jtune._cost_args(key[0], _shapes(jargs)) is not None


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_cells_match_jax(arch):
    """Every arch cell's shapes are JAX's and land in the bucket they
    name; activations and weights are in the model's dtype, the operands
    the model passes in fp32 stay fp32."""
    geo = dict(capacity=4, bucket_len=48, max_len=64, page_size=16)
    jcells = jtune.arch_cells(get_arch(arch).reduced(), **geo)
    pcfg = port_arch(arch).reduced()
    cells = autotune.arch_cells(pcfg, **geo)
    assert set(cells) == set(jcells)
    dt = getattr(torch, pcfg.dtype)
    for key, build in cells.items():
        jargs, jkw = _jax_cell(jcells[key])
        args, kw = build("cpu")
        assert _shapes(args) == _shapes(jargs), key
        _same_kwargs(kw, jkw)
        assert xaif.shape_bucket(key[0], _shapes(args)) == key[1], key
        first = args[0].dtype
        if key[0] in ("ssm_decode",) or kw.get("precise"):
            assert first == torch.float32, key
        else:
            assert first == dt, key
    if ("rmsnorm", "rows_s") in cells:
        assert cells[("rmsnorm", "rows_s")]("cpu")[0][1].dtype == \
            torch.float32


# ---------------------------------------------------------------------------
# Autotune
# ---------------------------------------------------------------------------


def test_autotune_arch_sources_and_persistence(tmp_path):
    """JAX's ``test_autotune_arch_cells_record_source``: the arch overlay
    names its cells, the persisted file carries the sources, measurements
    and device and round-trips on that device only. On CPU tensors the
    kernel backend is skipped with its reason, so no cell writes a rule:
    a policy measured on the CPU is the default "kernel" everywhere."""
    cfg = port_arch("chatglm3-6b").reduced()
    res = autotune.autotune(ops=["rmsnorm"], iters=1, arch=cfg, capacity=4,
                            device="cpu")
    by_cell = {(c.op, c.bucket): c.source for c in res.cells}
    assert by_cell[("rmsnorm", "rows_s")] == cfg.name
    assert by_cell[("rmsnorm", "rows_l")] == "generic"
    for c in res.cells:
        assert c.winner() == min(c.measured_us, key=c.measured_us.get)
        assert c.skipped["kernel"].startswith("cpu")
        assert c.rule is None and c.no_rule.startswith(
            "kernel not measured (cpu")
        assert c.prior == rn_ops.rmsnorm_cost(*autotune._cost_args(
            c.op, c.shapes))
    assert res.policy == xaif.DispatchPolicy()
    path = str(tmp_path / "policy.json")
    res.persist(path)
    doc = json.loads(open(path).read())
    assert doc["cell_sources"]["rmsnorm/rows_s"] == cfg.name
    assert any(m["source"] == cfg.name for m in doc["measurements"])
    assert doc["device"] == "cpu"
    assert xaif.DispatchPolicy.load(path) == res.policy
    assert autotune.load_policy(path, "cpu") == res.policy
    # measured on another device, or not measured at all: refused
    doc["device"] = "NVIDIA H100 80GB HBM3"
    other = tmp_path / "other.json"
    other.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="measured on 'NVIDIA H100"):
        autotune.load_policy(str(other), "cpu")
    res.policy.save(other)
    with pytest.raises(ValueError, match="measured on None"):
        autotune.load_policy(str(other), "cpu")


def test_autotune_excludes_lossy_backends_by_default():
    cfg = port_arch("yi-9b").reduced()
    res = autotune.autotune(ops=["gemm"], iters=1, arch=cfg, capacity=4,
                            device="cpu")
    for cell in res.cells:
        assert cell.skipped["int8"] in ("lossy", "supports")
        assert "int8" not in cell.measured_us
    assert all(r.backend != "int8" for _, _, r in res.policy.rules)
    res = autotune.autotune(ops=["gemm"], iters=1, arch=cfg, capacity=4,
                            allow_lossy=True, device="cpu")
    # measured on the bf16 arch cells; the fp32 generic cells' activations
    # are outside the W8A8 kernel's supports
    by = {c.bucket: c for c in res.cells}
    assert "int8" in by["rows_s"].measured_us
    assert by["rows_l"].skipped["int8"] == "supports"
    assert res.policy.allow_lossy


def test_autotune_writes_rules_only_where_the_kernel_ran(monkeypatch):
    """A cell writes a rule, its argmin, only where "kernel" was measured
    on it; a cell whose kernel ``supports`` rejects writes none, and with
    ``arch=`` neither does a generic cell (its toy fp32 shapes are not the
    arch's calls), so the default "kernel" stands there. The card is
    stood in for by running each kernel as it would there."""
    _probe_backends(monkeypatch)       # the kernel takes at most 8 rows
    monkeypatch.setattr(xaif.Backend, "function", lambda self, a, k: (
        self.entry.plain if self.plain else self.entry.kernel))

    def rows(m):
        return lambda device: ((torch.zeros(m, 8, device=device),), {})
    monkeypatch.setitem(autotune.CELLS, ("_probe", "rows_s"), rows(4))
    monkeypatch.setitem(autotune.CELLS, ("_probe", "rows_m"), rows(64))
    res = autotune.autotune(ops=["_probe"], iters=1, device="cpu")
    by = {c.bucket: c for c in res.cells}
    assert set(by["rows_s"].measured_us) == {"kernel", "ref", "alt"}
    assert by["rows_s"].rule == by["rows_s"].winner() == \
        res.policy.backend_for("_probe", "rows_s")
    assert by["rows_m"].skipped == {"kernel": "supports", "alt": "supports",
                                    "lossy": "lossy"}
    assert by["rows_m"].rule is None
    assert by["rows_m"].no_rule == "kernel not measured (supports)"
    assert set(res.policy.rules) == {("_probe", "rows_s",
                                      xaif.DispatchRule(by["rows_s"].rule))}
    res = autotune.autotune(ops=["_probe"], iters=1, device="cpu",
                            arch=port_arch("yi-9b").reduced())
    by = {c.bucket: c for c in res.cells}
    assert by["rows_s"].source == "generic" and by["rows_s"].rule is None
    assert by["rows_s"].no_rule == "a generic cell, not yi-9b's"
    assert res.policy == xaif.DispatchPolicy()


def test_autotune_propagates_a_backend_error(monkeypatch):
    """A backend that raises on a cell is not dropped (JAX's is): the
    exception reaches the caller."""
    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setitem(xaif._NAMED, ("rmsnorm", "broken"),
                        xaif.OpEntry("rmsnorm", broken, broken))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        autotune.autotune(ops=["rmsnorm"], iters=1, device="cpu")


def test_autotune_warns_on_ops_without_cells():
    msgs = []
    res = autotune.autotune(ops=["gemm_heads"], iters=1, device="cpu",
                            print_fn=msgs.append)
    assert not res.cells and res.policy == xaif.DispatchPolicy()
    assert any("gemm_heads" in m and "WARNING" in m for m in msgs)


# ---------------------------------------------------------------------------
# Serving under a DispatchPolicy, against JAX's
# ---------------------------------------------------------------------------

SERVE_TABLE = {("attention", "prefill"): "blockwise",
               ("attention", "decode"): "blockwise",
               ("attn_decode", "kv_s"): "pallas",
               ("attn_decode_paged", "kv_s"): "pallas",
               "gemm": "ref", "rmsnorm": "ref", "entropy_exit": "ref"}


@pytest.fixture(scope="module")
def chatglm():
    # heads of 64: the decode kernels have an instance for them, so their
    # cells take the kernel backend (its plain version on the CPU)
    jcfg = get_arch("chatglm3-6b").reduced(dtype="float32", head_dim=64)
    pcfg = port_arch("chatglm3-6b").reduced(dtype="float32", head_dim=64)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    pp = params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, pcfg.vocab_size, (4 + 2 * i,)).astype(
        np.int32) for i in range(4)]
    return jcfg, pcfg, jp, pp, prompts


@pytest.mark.parametrize("paged", [False, True])
def test_serve_under_dispatch_policy_matches_jax(chatglm, paged):
    """Reduced chatglm3 (fp32) through the slot engine under a policy with
    blockwise prefill and the decode kernel's cells: the tokens equal
    JAX's serve under the same table (its Pallas decode in interpret
    mode) and the port's under "auto"; nothing falls back."""
    jcfg, pcfg, jp, pp, prompts = chatglm
    kw = dict(capacity=2, max_len=32, chunk=3)
    pkw = dict(kw, paged=True, page_size=8) if paged else kw
    jpol = jxaif.DispatchPolicy.make(SERVE_TABLE)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    jax_serve(JaxSlotEngine(RunConfig(arch=jcfg,
                                      shape=SHAPES_BY_NAME["decode_32k"],
                                      accel=jpol), **pkw), jp, jreqs)
    ppol = xaif.DispatchPolicy.make(_mapped(SERVE_TABLE))
    got = {}
    for name, policy in (("dispatch", ppol), ("auto", "auto")):
        reqs = [Request(i, p, 5) for i, p in enumerate(prompts)]
        xaif.reset_launch_counts()
        serve(SlotEngine(PortRunConfig(arch=pcfg, policy=policy),
                         device="cpu", **pkw), pp, reqs)
        got[name] = [r.tokens for r in reqs]
        assert xaif.fallback_counts() == {}, name
    assert got["dispatch"] == got["auto"] == [list(r.tokens) for r in jreqs]


def test_launcher_autotune_then_policy(tmp_path, capsys):
    """``--autotune`` writes the policy file and serves under it; a second
    run loads it and gives the same tokens. Measured on the CPU, the
    policy has no rule (no kernel was timed), so the tokens are those of
    the run without a policy."""
    path = tmp_path / "yi.json"
    base = ["--arch", "yi-9b", "--device", "cpu", "--requests", "4",
            "--capacity", "2", "--new-tokens", "4", "--max-len", "32",
            "--prompt-len-max", "12"]
    auto = launcher.main(base)
    tuned = launcher.main(base + ["--autotune", "--policy", str(path)])
    out = capsys.readouterr().out
    assert "autotuning XAIF backends" in out and path.exists()
    pol = xaif.DispatchPolicy.load(path)
    assert len(pol.rules) == len(json.loads(path.read_text())["rules"]) == 0
    loaded = launcher.main(base + ["--policy", str(path)])
    out = capsys.readouterr().out
    assert f"loaded dispatch policy from {path}" in out
    # the reduced heads (32 wide) have no kernel instance: on the CPU
    # those calls fall back to the plain version, counted
    assert "dispatch: 0 rules, default kernel" in out
    toks = [[r.tokens for r in rep.requests] for rep in (auto, tuned,
                                                        loaded)]
    assert toks[0] == toks[1] == toks[2]


def test_launcher_reads_no_policy_unasked(tmp_path, monkeypatch, capsys):
    """A policy file at the default path is not read without ``--policy``;
    ``--policy`` refuses a file measured on another device, and a missing
    one."""
    monkeypatch.chdir(tmp_path)
    doc = json.loads(xaif.DispatchPolicy.make({"rmsnorm": "ref"}).to_json(
        device="NVIDIA H100 80GB HBM3"))
    (tmp_path / autotune.DEFAULT_POLICY_PATH).write_text(json.dumps(doc))
    base = ["--arch", "yi-9b", "--device", "cpu", "--requests", "2",
            "--capacity", "2", "--new-tokens", "2", "--max-len", "32",
            "--prompt-len-max", "8"]
    launcher.main(base)
    out = capsys.readouterr().out
    assert "loaded dispatch policy" not in out and "dispatch:" not in out
    for path, why in ((autotune.DEFAULT_POLICY_PATH, "measured on 'NVIDIA"),
                      ("missing.json", "No such file")):
        with pytest.raises(SystemExit) as exc:
            launcher.main(base + ["--policy", path])
        assert exc.value.code == 2
        assert why in capsys.readouterr().err


def test_dispatch_policy_never_moves_a_device_call_off_the_kernel(
        monkeypatch):
    """On tensors off the CPU (the meta device stands in for the card), a
    call whose shapes the kernel rejects raises where the chain would run
    the plain version only because of that rejection, as the kernel's
    wrapper does under "auto"; under a policy whose default is "ref" the
    plain version is named, and the call falls back, counted. A
    ``supports`` predicate's own error propagates."""
    _probe_backends(monkeypatch)       # the kernel takes at most 8 rows
    try:
        x = torch.zeros(64, 8, device="meta")
        with pytest.raises(ValueError, match="does not take shapes"):
            xaif.call("_probe", xaif.DispatchPolicy(), x)
        xaif.reset_launch_counts()
        pol = xaif.DispatchPolicy.make({"_probe": "kernel"}, default="ref")
        assert xaif.call("_probe", pol, x).device.type == "meta"
        assert xaif.fallback_counts() == {("_probe", "rows_m", "kernel",
                                           "ref"): 1}

        def broken(shapes, dtype):
            raise IndexError("a predicate's own error")
        monkeypatch.setitem(xaif._REGISTRY, "_probe", dataclasses.replace(
            xaif._REGISTRY["_probe"], supports=broken))
        xaif._route.cache_clear()
        with pytest.raises(IndexError, match="own error"):
            xaif.call("_probe", xaif.DispatchPolicy(), torch.zeros(4, 8))
    finally:
        xaif.reset_launch_counts()
        xaif._route.cache_clear()
