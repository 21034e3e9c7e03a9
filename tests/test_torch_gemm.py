"""The tile and split choices of the port's GEMM kernels, which run only
on the card: ``gemm_plan`` (the bf16 and int8-weight tensor-core kernel
of ``csrc/gemm.cu``), ``f32_plan`` (its fp32 kernel of the routers,
``w_if`` and ``gemm_heads``) and ``int8_plan`` (the W8A8 kernel of
``csrc/gemm_int8.cu``, which quantizes the activations itself).

A row's bits must not depend on how many rows share a launch (the serve
engine's token identity with the one-request loop rests on it), so the
plans are functions of the shape of w alone: these tests hold that the
wrappers pass one plan for every M, that every decode shape of the
served models gets enough blocks to stream its weights on the H100's 132
SMs, that every plan is one the kernels can launch, and that the wrappers
still refuse what the kernels do not take. The kernels' arithmetic is
held against the plain versions on the card by ``chip_smoke.py``.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.gemm import ops
from repro_torch.kernels.gemm.ops import (HEAD_MAJOR, LHD, LHD_TRANSPOSED,
                                          f32_plan, gemm_plan, int8_plan)
from repro_torch.kernels.gemm.ref import WeightQ

# The decode GEMMs (x [4, K] @ w [K, N], bf16) of each served model at
# full width: its projections, MLPs / experts' shared paths and
# unembedding (the shapes chip_smoke.py times).
BF16_SHAPES = {
    "yi-9b": ((4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
              (4096, 64000)),
    "deepseek-v2-lite-16b": ((2048, 3072), (2048, 512), (2048, 64),
                             (2048, 2048), (2048, 2816), (2816, 2048),
                             (2048, 10944), (10944, 2048), (2048, 102400)),
    "jamba-v0.1-52b": ((4096, 16384), (8192, 288), (256, 8192),
                       (8192, 4096), (4096, 14336), (14336, 4096),
                       (4096, 1024), (4096, 65536)),
    "xlstm-350m": ((1024, 4096), (2048, 1024), (1024, 2730), (1365, 1024),
                   (1024, 50304)),
    "musicgen-medium": ((1536, 1536), (1536, 6144), (6144, 1536),
                        (1536, 2048)),
    "chatglm3-6b": ((4096, 4096), (4096, 256), (4096, 13696), (13696, 4096),
                    (4096, 65024)),
    "qwen1.5-32b": ((5120, 5120), (5120, 27392), (27392, 5120),
                    (5120, 152064)),
    "qwen3-moe-30b-a3b": ((2048, 4096), (4096, 2048), (2048, 512),
                          (2048, 151936)),
    "chameleon-34b": ((8192, 8192), (8192, 1024), (8192, 22016),
                      (22016, 8192)),
    "mistral-large-123b": ((12288, 12288), (12288, 1024), (12288, 28672),
                           (28672, 12288), (12288, 32768)),
}
# The fp32 kernel's decode products: (N, K, H, layout, bf16 weights)
F32_SHAPES = {
    "deepseek router": (64, 2048, 1, HEAD_MAJOR, False),
    "deepseek w_uk (absorbed q)": (512, 128, 16, LHD_TRANSPOSED, True),
    "deepseek w_uv (absorbed out)": (128, 512, 16, LHD, True),
    "jamba router": (16, 4096, 1, HEAD_MAJOR, False),
    "qwen3-moe router": (128, 2048, 1, HEAD_MAJOR, False),
    "xlstm w_if": (8, 2048, 1, HEAD_MAJOR, False),
    "xlstm q/k/v head-major": (512, 512, 4, HEAD_MAJOR, True),
    "xlstm sLSTM wr head-major": (1024, 256, 4, HEAD_MAJOR, False),
}
ROWS = (1, 4, 16, 20, 128)


def test_plans_take_no_m():
    assert list(inspect.signature(gemm_plan).parameters) == ["n", "k", "wq"]
    assert list(inspect.signature(f32_plan).parameters) == [
        "n", "k", "h", "layout", "w_bf16"]
    assert list(inspect.signature(int8_plan).parameters) == ["n", "k"]


class _FakeLib:
    """Records each C entry point's arguments in place of the library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def _stub_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(ops, "require_cuda", lambda *a: None)
    monkeypatch.setattr(ops, "_lib", lambda: lib)
    monkeypatch.setattr(ops, "_lib_int8", lambda: lib)
    monkeypatch.setattr(ops, "stream_ptr", lambda t: 0)
    return lib


def _launch(kind, m):
    """One wrapper call of ``kind`` at M = m rows on CPU tensors (the
    card stubbed out)."""
    bf, f32 = torch.bfloat16, torch.float32
    if kind == "bf16":
        ops.gemm(torch.zeros(m, 4096, dtype=bf),
                 torch.zeros(4096, 512, dtype=bf))
        return
    if kind == "int8-weight":
        ops.gemm(torch.zeros(m, 4096, dtype=bf),
                 WeightQ(torch.zeros(4096, 4096, dtype=torch.int8),
                         torch.ones(1, 4096)), None, "silu")
        return
    if kind == "fp32":
        ops.gemm(torch.zeros(m, 2048), torch.zeros(2048, 64, dtype=f32))
        return
    if kind == "fp32-narrow":
        ops.gemm(torch.zeros(m, 64), torch.zeros(64, 2, dtype=f32),
                 torch.zeros(2))
        return
    layout = {"heads-transposed": dict(transpose_w=True),
              "heads": {}, "heads-major": dict(head_major=True)}[kind]
    k = 128 if kind == "heads-transposed" else 512
    w = (torch.zeros(4, 512, 512, dtype=bf) if kind == "heads-major"
         else torch.zeros(512, 16, 128, dtype=bf))
    ops.gemm_heads(torch.zeros(m, w.shape[0] if kind == "heads-major"
                               else 16, k), w, **layout)


# where M is among each entry point's arguments, and the arguments after
# it: N, K, act and the plan (bf16); H, L, D, layout, wdtype, act and the
# plan (fp32); N, K and act (fp32 below 8 columns)
_M_ARG = {"gemm_bf16_launch": 5, "gemm_heads_launch": 6,
          "gemm_f32_narrow_launch": 4}
_PLAN_ARGS = {"gemm_bf16_launch": slice(6, 12),
              "gemm_heads_launch": slice(7, 18),
              "gemm_f32_narrow_launch": slice(5, 8)}
_ENTRY = {"bf16": "gemm_bf16_launch", "int8-weight": "gemm_bf16_launch",
          "fp32-narrow": "gemm_f32_narrow_launch"}


@pytest.mark.parametrize("kind", ["bf16", "int8-weight", "fp32",
                                  "fp32-narrow", "heads-transposed", "heads",
                                  "heads-major"])
def test_wrappers_pass_one_plan_for_every_m(kind, monkeypatch):
    """The C entry point gets the same plan (tile, stage, split) whatever
    the number of rows; only M and the pointers change, and each call
    counts one launch (an int8-weight one also as ``gemm_wq``)."""
    lib = _stub_card(monkeypatch)
    seen = set()
    for m in ROWS:
        wq_before = ops.gemm.instances["gemm_wq"]
        _launch(kind, m)
        name, args = lib.calls[-1]
        assert name == _ENTRY.get(kind, "gemm_heads_launch")
        assert args[_M_ARG[name]] == m
        seen.add((name, args[_PLAN_ARGS[name]]))
        assert ops.gemm.instances["gemm_wq"] == wq_before + (
            kind == "int8-weight")
    assert len(seen) == 1, seen
    assert len(lib.calls) == len(ROWS)


@pytest.mark.parametrize("n", range(1, 10))
def test_fp32_below_8_columns_runs_the_narrow_kernel(n, monkeypatch):
    """The fused fp32 GEMM takes the narrow kernel (a warp a row) at 1-7
    columns and the tiled kernel from 8 on; bf16 never the narrow one."""
    lib = _stub_card(monkeypatch)
    ops.gemm(torch.zeros(4, 64), torch.zeros(64, n), torch.zeros(n), "relu")
    ops.gemm(torch.zeros(4, 64, dtype=torch.bfloat16),
             torch.zeros(64, n, dtype=torch.bfloat16))
    (f32_name, f32_args), (bf_name, _) = lib.calls
    assert bf_name == "gemm_bf16_launch"
    if n < ops.F32_NARROW:
        assert f32_name == "gemm_f32_narrow_launch"
        assert f32_args[4:8] == (4, n, 64, ops.ACT_CODE["relu"])
        assert f32_args[2] is not None        # the bias
    else:
        assert f32_name == "gemm_heads_launch"


def test_launch_counters_count_each_call(monkeypatch):
    _stub_card(monkeypatch)
    for kind, wrapper in (("bf16", ops.gemm), ("fp32", ops.gemm),
                          ("fp32-narrow", ops.gemm),
                          ("heads", ops.gemm_heads)):
        before = wrapper.launches
        _launch(kind, 4)
        assert wrapper.launches == before + 1


@pytest.mark.parametrize("kind", ["fp32", "heads-major"])
def test_f32_scratch_only_where_k_is_split_and_kept(kind, monkeypatch):
    """The fp32 kernel gets scratch (partials, zeroed arrival counters)
    only where its plan splits K (the router 2048 -> 64, not the
    head-major q/k/v); the scratch is kept across calls, so a call at the
    same or fewer rows allocates nothing, and grows with M."""
    lib = _stub_card(monkeypatch)
    monkeypatch.setattr(ops, "_SCRATCH", {})
    ptrs = []
    for m in (4, 4, 1, 128):
        _launch(kind, m)
        ptrs.append(lib.calls[-1][1][4:6])
    if kind == "heads-major":
        assert all(p == (None, None) for p in ptrs)
        assert not ops._SCRATCH
        return
    assert all(None not in p for p in ptrs)
    assert ptrs[0] == ptrs[1] == ptrs[2]
    (part, arrived), = ops._SCRATCH.values()
    plan = ops.f32_plan(64, 2048)
    assert part.numel() >= plan.parts * 128 * 64
    assert arrived.numel() >= (128 // ops.F32_MT) * math.ceil(64 / plan.bn)
    assert arrived.dtype == torch.int32 and not arrived.any()


@pytest.mark.parametrize("model", sorted(BF16_SHAPES))
def test_bf16_plans_fill_the_card(model):
    """At every decode shape: >= 128 blocks where N allows it (N >=
    2048); narrower products give every 16 columns a block (the most a
    fixed K order allows: no split of K), and the int8-weight instance
    has the same tiles."""
    for k, n in BF16_SHAPES[model]:
        for wq in (False, True):
            bn = gemm_plan(n, k, wq)[0]
            blocks = math.ceil(n / bn)
            assert blocks >= min(128, math.ceil(n / 16)), (model, k, n, wq)
        assert gemm_plan(n, k, True)[0] == gemm_plan(n, k)[0]


@pytest.mark.parametrize("name", sorted(F32_SHAPES))
def test_f32_plans_fill_the_card(name):
    """>= 128 blocks a decode product (>= 32 at N <= 64), with the fewest
    K ranges that give them: none beside the routers and ``w_if``."""
    n, k, h, layout, bf = F32_SHAPES[name]
    p = f32_plan(n, k, h, layout, bf)
    assert p.blocks(n, h) >= (32 if n <= 64 else 128), (name, p)
    assert (p.parts > 1) == ("router" in name or "w_if" in name), (name, p)


def _f32_plan_ok(p, n, k, layout, bf):
    """The constraints gemm_f32_kernel's launch and loops rely on."""
    e = 8 if bf else 4
    assert p.threads in (128, 256)
    assert p.lanes_k & (p.lanes_k - 1) == 0 and p.threads % p.lanes_k == 0
    nt = p.threads // p.lanes_k
    if layout == LHD_TRANSPOSED:
        assert p.kc == p.lanes_k * e
        assert p.bn % nt == 0 and 1 <= p.bn // nt <= ops.F32_MAX_LOADS
    else:
        assert nt * e == p.bn and 32 <= p.bn * (2 if bf else 4)
        assert p.kc % p.lanes_k == 0
        assert 1 <= p.kc // p.lanes_k <= ops.F32_MAX_LOADS
    assert p.kc <= ops.F32_MAX_KC
    assert p.parts == math.ceil(k / p.kc)
    # dynamic shared memory at 16 rows (csrc/gemm.cu f32::run) <= 96 KB
    rs = 4 * p.bn + (1 if layout == LHD_TRANSPOSED else 4)
    assert 4 * (16 * p.kc + p.lanes_k * rs) <= 96 * 1024


def test_plans_are_launchable():
    """Every plan over a spread of shapes satisfies the kernels' limits:
    bf16 tiles of 16..128 columns (16 where K or N is ragged), stages of
    64..512 rows of K within the instance's shared memory (64 or 128 in
    the prefill tiles); fp32 thread
    maps, loads a thread, K ranges and shared memory."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        n, k = (int(v) for v in rng.integers(1, 20000, size=2))
        for wq in (False, True):
            bn, lbk, lbk_prefill = gemm_plan(n, k, wq)
            assert bn in (16, 32, 64, 128) and 6 <= lbk <= 9
            assert lbk_prefill == (7 if bn <= 32 else 6)
            if k % 8 or n % (16 if wq else 8):
                assert bn == 16
            stage = (1 << lbk) * bn * (1 if wq else 2)
            assert stage <= 16384 or (1 << lbk) == 64
        h = int(rng.integers(1, 17))
        for layout in (LHD, LHD_TRANSPOSED, HEAD_MAJOR):
            for bf in (False, True):
                _f32_plan_ok(f32_plan(n, k, h, layout, bf), n, k, layout, bf)
    for name, (n, k, h, layout, bf) in F32_SHAPES.items():
        _f32_plan_ok(f32_plan(n, k, h, layout, bf), n, k, layout, bf)


_REFUSALS = {
    "cpu tensor": (ValueError, "CUDA kernel got a tensor",
                   lambda: ops.gemm(torch.zeros(4, 64, dtype=torch.bfloat16),
                                    torch.zeros(64, 32,
                                                dtype=torch.bfloat16))),
    "heads cpu tensor": (ValueError, "CUDA kernel got a tensor",
                         lambda: ops.gemm_heads(torch.zeros(4, 2, 8),
                                                torch.zeros(8, 2, 16))),
}
_STUBBED_REFUSALS = {
    "dtype mismatch": (TypeError, "x is",
                       lambda: ops.gemm(torch.zeros(4, 64),
                                        torch.zeros(64, 32,
                                                    dtype=torch.bfloat16))),
    "fp16": (TypeError, "not supported",
             lambda: ops.gemm(torch.zeros(4, 64, dtype=torch.float16),
                              torch.zeros(64, 32, dtype=torch.float16))),
    "shapes": (ValueError, "shapes",
               lambda: ops.gemm(torch.zeros(4, 64, dtype=torch.bfloat16),
                                torch.zeros(32, 64, dtype=torch.bfloat16))),
    "activation": (ValueError, "unknown activation",
                   lambda: ops.gemm(torch.zeros(4, 64), torch.zeros(64, 32),
                                    activation="tanh")),
    "bias": (ValueError, "bias",
             lambda: ops.gemm(torch.zeros(4, 64), torch.zeros(64, 32),
                              torch.zeros(31))),
    "int8 fp32 x": (TypeError, "int8 weights take bf16 x",
                    lambda: ops.gemm(torch.zeros(4, 64), WeightQ(
                        torch.zeros(64, 32, dtype=torch.int8),
                        torch.ones(1, 32)))),
    "int8 scale": (ValueError, "scale",
                   lambda: ops.gemm(torch.zeros(4, 64, dtype=torch.bfloat16),
                                    WeightQ(torch.zeros(64, 32,
                                                        dtype=torch.int8),
                                            torch.ones(1, 16)))),
    "heads bf16 x": (TypeError, "float32",
                     lambda: ops.gemm_heads(
                         torch.zeros(4, 2, 8, dtype=torch.bfloat16),
                         torch.zeros(8, 2, 16))),
    "heads count": (ValueError, "against w",
                    lambda: ops.gemm_heads(torch.zeros(4, 3, 8),
                                           torch.zeros(8, 2, 16))),
    "heads transposed head-major": (
        ValueError, "against w",
        lambda: ops.gemm_heads(torch.zeros(4, 2, 8), torch.zeros(2, 8, 16),
                               transpose_w=True, head_major=True)),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_wrappers_refuse_cpu_tensors(case):
    """On a CPU tensor the kernel path raises: plain versions serve the
    CPU (through XAIF), never the wrappers."""
    err, match, call = _REFUSALS[case]
    before = ops.gemm.launches, ops.gemm_heads.launches
    with pytest.raises(err, match=match):
        call()
    assert (ops.gemm.launches, ops.gemm_heads.launches) == before


@pytest.mark.parametrize("case", sorted(_STUBBED_REFUSALS))
def test_wrappers_refuse_what_the_kernels_do_not_take(case, monkeypatch):
    """With the device check stubbed out, each wrapper raises before it
    launches, and counts no launch."""
    lib = _stub_card(monkeypatch)
    err, match, call = _STUBBED_REFUSALS[case]
    before = ops.gemm.launches, ops.gemm_heads.launches
    with pytest.raises(err, match=match):
        call()
    assert (ops.gemm.launches, ops.gemm_heads.launches) == before
    assert not lib.calls


# ----- the W8A8 kernel (csrc/gemm_int8.cu) -----------------------------------

# yi-9b's W8A8 decode GEMMs (K, N): projections, MLP, unembedding
INT8_SHAPES = BF16_SHAPES["yi-9b"]
# gemm_int8_launch(x, wq, ws, bias, out, part, arrived, xq, xs, M, N, K,
# act, bn, kc, parts, stream)
_I8_M, _I8_PLAN, _I8_SCRATCH, _I8_XQ = 9, slice(13, 16), slice(5, 7), \
    slice(7, 9)


def _launch_int8(m, k=4096, n=4096, bias=False, activation="silu"):
    """One W8A8 wrapper call at M = m on CPU tensors (the card stubbed
    out), on a WeightQ."""
    w = WeightQ(torch.zeros(k, n, dtype=torch.int8), torch.ones(1, n))
    return ops.gemm_int8(torch.zeros(m, k, dtype=torch.bfloat16), w,
                         torch.zeros(n) if bias else None, activation)


@pytest.mark.parametrize("shape", INT8_SHAPES + ((1000, 300),))
def test_int8_wrapper_passes_one_plan_for_every_m(shape, monkeypatch):
    """The C entry point gets the plan of (N, K) whatever the number of
    rows; only M changes, and each call counts one launch of
    ``gemm_int8``."""
    lib = _stub_card(monkeypatch)
    k, n = shape
    seen = set()
    for m in ROWS:
        before = ops.gemm_int8.launches
        out = _launch_int8(m, k, n, bias=(k, n) == (1000, 300))
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        assert ops.gemm_int8.launches == before + 1
        name, args = lib.calls[-1]
        assert name == "gemm_int8_launch"
        assert args[_I8_M] == m and args[10:12] == (n, k)
        # the quantized rows' scratch: only beyond one M tile (a prefill)
        assert (None in args[_I8_XQ]) == (m <= ops.INT8_MT), (m, args)
        seen.add(args[_I8_PLAN])
    assert seen == {tuple(int8_plan(n, k))}
    assert len(lib.calls) == len(ROWS)


def test_int8_wrapper_runs_no_torch_op_on_x(monkeypatch):
    """With a WeightQ the activations go to the kernel as they are: the
    wrapper never quantizes them (the kernel does), so neither
    ``quantize_int8`` nor ``int8_operands`` is called, and x is passed by
    its own pointer. A bare floating-point w is still quantized per column
    in PyTorch, and only it."""
    from repro_torch.kernels.gemm import ref

    lib = _stub_card(monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("the W8A8 wrapper quantized in PyTorch")
    monkeypatch.setattr(ops, "quantize_int8", refuse)
    monkeypatch.setattr(ref, "quantize_int8", refuse)
    monkeypatch.setattr(ref, "int8_operands", refuse)
    x = torch.zeros(4, 4096, dtype=torch.bfloat16)
    w = WeightQ(torch.zeros(4096, 512, dtype=torch.int8), torch.ones(1, 512))
    ops.gemm_int8(x, w)
    args = lib.calls[-1][1]
    assert args[0] == x.data_ptr() and args[1] == w.q.data_ptr()
    assert args[2] == w.scale.data_ptr()
    seen = []

    def per_column(t, dim):
        seen.append(dim)
        return torch.zeros(t.shape, dtype=torch.int8), torch.ones(1, t.shape[1])
    monkeypatch.setattr(ops, "quantize_int8", per_column)
    ops.gemm_int8(x, torch.zeros(4096, 512, dtype=torch.bfloat16))
    assert seen == [0]
    assert lib.calls[-1][1][0] == x.data_ptr()


def test_int8_plans_fill_the_card():
    """>= 128 blocks at every yi-9b W8A8 decode shape (one launch of at
    most 16 rows), with no more K ranges than the plan's target of 256
    blocks (two an SM) takes."""
    for k, n in INT8_SHAPES:
        p = int8_plan(n, k)
        assert p.blocks(n) >= 128, (k, n, p)
        if p.parts > 1:
            fewer = math.ceil(n / p.bn) * (p.parts - 1)
            assert fewer < ops.INT8_BLOCKS, (k, n, p)


def test_int8_plans_are_launchable():
    """The constraints gemm_int8_launch checks and its shared memory
    relies on, over a spread of shapes: 64 or 128 columns a block; a K
    range a whole number of ring stages (8192 / bn rows), at most 8192
    rows; the ranges cover K with none empty; the ring and 16 rows of
    quantized x fit the 227 KB a block may have."""
    rng = np.random.default_rng(1)
    shapes = list(INT8_SHAPES) + [(int(a), int(b)) for a, b in
                                  rng.integers(1, 40000, size=(300, 2))]
    for k, n in shapes:
        p = int8_plan(n, k)
        assert p.bn in (64, 128)
        bk = ops.INT8_STAGE // p.bn
        assert p.kc % bk == 0 and 0 < p.kc <= ops.INT8_MAX_KC
        assert p.kc * p.parts >= k > p.kc * (p.parts - 1), (k, n, p)
        smem = 4 * ops.INT8_STAGE + ops.INT8_MT * (p.kc + 16)
        assert smem + 64 <= 232448


def test_int8_scratch_only_where_k_is_split_and_kept(monkeypatch):
    """The split W8A8 kernel gets int32 sums and arrival counters, zeroed
    once and kept across calls (the kernel leaves them zero), grown with M;
    an unsplit plan (the 4096 -> 64000 unembedding) gets none."""
    lib = _stub_card(monkeypatch)
    monkeypatch.setattr(ops, "_SCRATCH_INT8", {})
    ptrs = []
    for m in (4, 4, 1, 128):
        _launch_int8(m)
        ptrs.append(lib.calls[-1][1][_I8_SCRATCH])
    assert all(None not in p for p in ptrs)
    assert ptrs[0] == ptrs[1] == ptrs[2]
    (part, arrived), = ops._SCRATCH_INT8.values()
    plan = int8_plan(4096, 4096)
    assert plan.parts > 1
    assert part.numel() >= 128 * 4096 and part.dtype == torch.int32
    assert arrived.numel() >= (128 // ops.INT8_MT) * math.ceil(4096 / plan.bn)
    assert not part.any() and not arrived.any()
    _launch_int8(4, 4096, 64000, activation="none")
    assert int8_plan(64000, 4096).parts == 1
    assert lib.calls[-1][1][_I8_SCRATCH] == (None, None)


_INT8_REFUSALS = {
    "fp32 x": (TypeError, "takes bf16 x",
               lambda: ops.gemm_int8(torch.zeros(4, 64), WeightQ(
                   torch.zeros(64, 32, dtype=torch.int8),
                   torch.ones(1, 32)))),
    "shapes": (ValueError, "against w",
               lambda: ops.gemm_int8(torch.zeros(4, 64, dtype=torch.bfloat16),
                                     WeightQ(torch.zeros(32, 64,
                                                         dtype=torch.int8),
                                             torch.ones(1, 64)))),
    "scale": (ValueError, "scale",
              lambda: ops.gemm_int8(torch.zeros(4, 64, dtype=torch.bfloat16),
                                    WeightQ(torch.zeros(64, 32,
                                                        dtype=torch.int8),
                                            torch.ones(1, 16)))),
    "activation": (ValueError, "unknown activation",
                   lambda: _launch_int8(4, activation="tanh")),
    "bias": (ValueError, "bias",
             lambda: ops.gemm_int8(torch.zeros(4, 64, dtype=torch.bfloat16),
                                   WeightQ(torch.zeros(64, 32,
                                                       dtype=torch.int8),
                                           torch.ones(1, 32)),
                                   torch.zeros(31))),
}


@pytest.mark.parametrize("case", sorted(_INT8_REFUSALS))
def test_int8_wrapper_refuses_what_the_kernel_does_not_take(case,
                                                            monkeypatch):
    """With the device check stubbed out, the W8A8 wrapper raises before
    it launches, and counts no launch."""
    lib = _stub_card(monkeypatch)
    err, match, call = _INT8_REFUSALS[case]
    before = ops.gemm_int8.launches
    with pytest.raises(err, match=match):
        call()
    assert ops.gemm_int8.launches == before
    assert not lib.calls
