"""Wrappers of the GEMM kernels (``csrc/gemm.cu``, ``csrc/gemm_int8.cu``)
and their XAIF ops: the fused GEMM (bf16 / fp32 weights, or int8
``WeightQ`` weights dequantized on the fly), its lossy W8A8 backend
``int8`` (activations quantized per row inside the kernel, integer
products), and ``gemm_heads``, the per-head fp32 products of MLA's
absorbed decode and of the xLSTM mixers' block-diagonal weights.

The kernels' tile and split choices are made here, by :func:`gemm_plan`
(the bf16 / int8-weight kernel), :func:`f32_plan` (the fp32 kernel) and
:func:`int8_plan` (the W8A8 kernel): functions of the shape of w alone,
never of M, so that every output element is reduced over K in one order
whatever the batch. The fused fp32 GEMM at fewer than ``F32_NARROW``
columns runs a kernel of its own (a warp a row), planless."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.gemm.ref import (WeightQ, gemm_heads_ref, gemm_ref,
                                          gemm_w8a8_ref, quantize_int8)

# csrc/gemm_epilogue.cuh Act
ACT_CODE = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
# csrc/gemm.cu HeadLayout
LHD, LHD_TRANSPOSED, HEAD_MAJOR = 0, 1, 2
SMS = 132                      # streaming multiprocessors of an H100 SXM


@functools.lru_cache(maxsize=None)
def gemm_plan(n: int, k: int, wq: bool = False) -> Tuple[int, int, int]:
    """(bn, lbk, lbk_prefill) of the bf16 tensor-core kernel for w [K, N]
    (int8 with ``wq``): bn columns a block (16 below N = 4096 so that
    narrow products still spread over N / 16 blocks; 32, 64, then 128 for
    the vocabulary heads); 2^lbk rows of K a ring stage at M <= 16, 16 KB
    of weights when the grid fits on the card in one wave (one block an
    SM), else 8 KB; and 2^lbk_prefill rows in the 64-row tiles beyond 16
    rows, 128 for tiles of <= 32 columns, else 64 (two blocks an SM).
    Shapes whose K or N the kernel's 16-byte copies cannot take (K or N not
    a multiple of 8, int8 N of 16) get 16 columns. The K order of an
    element (k16 steps from 0 up) is the same whatever the plan."""
    if k % 8 or n % (16 if wq else 8) or n < 4096:
        bn = 16
    else:
        bn = 32 if n < 8192 else 64 if n <= 16384 else 128
    stage = 16384 if math.ceil(n / bn) <= SMS else 8192
    bk = stage // (bn * (1 if wq else 2))
    bk = max(64, min(bk, 512, 1 << max(6, (k - 1).bit_length())))
    return bn, bk.bit_length() - 1, 7 if bn <= 32 else 6


class F32Plan(NamedTuple):
    """The fp32 kernel's launch: ``threads`` a block; ``bn`` columns a
    block; ``kc`` rows of K a block (its K range); ``parts`` K ranges;
    ``lanes_k`` threads along K (their per-thread chains are added by a
    fixed tree)."""
    threads: int
    bn: int
    kc: int
    parts: int
    lanes_k: int

    def blocks(self, n: int, h: int) -> int:
        """Blocks of one launch of at most 16 rows."""
        return math.ceil(n / self.bn) * self.parts * h


F32_MT = 16                    # rows of x a block (csrc/gemm.cu f32::kMT)
F32_NARROW = 8                 # the fused fp32 GEMM at fewer columns runs
                               # f32n::gemm_f32_narrow_kernel: a warp a row
F32_MAX_LOADS = 8              # 16-byte loads of w a thread
F32_MAX_KC = 512               # K rows a block stages (16 x 512 fp32 of x)


@functools.lru_cache(maxsize=None)
def f32_plan(n: int, k: int, h: int = 1, layout: int = HEAD_MAJOR,
             w_bf16: bool = False) -> F32Plan:
    """The fp32 kernel's tiles for the per-head product W_h [K, N] (h
    heads, ``layout`` as ``gemm_heads``; the fused GEMM is HEAD_MAJOR with
    h = 1): the fewest K ranges that still give >= 128 blocks (>= 32 at N
    <= 64, where the columns alone give a handful), then the widest column
    tile, so that enough of the card streams one decode product. Each
    thread loads 16 bytes of w up to 8 times, contiguous along N, or along
    K for LHD_TRANSPOSED (w read transposed)."""
    e = 8 if w_bf16 else 4                   # elements of 16 bytes of w
    target = 32 if n <= 64 else 128
    cands = []
    for threads in (256, 128):
        if layout == LHD_TRANSPOSED:
            kvt = min(32, 1 << max(0, math.ceil(k / e) - 1).bit_length())
            nt = threads // kvt
            for npt in (1, 2, 4, 8):
                if npt > 1 and nt * npt > n:
                    break
                cands.append(F32Plan(threads, nt * npt, kvt * e,
                                     math.ceil(k / (kvt * e)), kvt))
            continue
        lo = 32 // (4 if e == 4 else 2)      # at least 32 bytes of a row
        for bn in (8, 16, 32, 64, 128):
            if bn < lo or (bn > lo and bn > math.ceil(n / e) * e):
                continue
            kt = threads // (bn // e)
            for kpt in range(1, F32_MAX_LOADS + 1):
                kc = kt * kpt
                if kc > F32_MAX_KC:
                    break
                cands.append(F32Plan(threads, bn, kc, math.ceil(k / kc), kt))

    def key(p: F32Plan):
        b = p.blocks(n, h)
        return (b < target, p.parts if b >= target else -b, -p.bn,
                -p.threads, p.kc)
    return min(cands, key=key)


def _lib() -> ctypes.CDLL:
    lib = library("gemm")
    if lib.gemm_bf16_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_bf16_launch.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.gemm_bf16_launch.restype = i
        lib.gemm_heads_launch.argtypes = [p] * 6 + [i] * 12 + [p]
        lib.gemm_heads_launch.restype = i
        lib.gemm_f32_narrow_launch.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.gemm_f32_narrow_launch.restype = i
    return lib


# (device, stream) -> (fp32 partials, uint32 arrival counters): the split
# fp32 kernel's scratch, kept across calls and grown as needed. Launches
# on one stream run in order, so one buffer serves them all; the counters
# are zero between launches (the kernel re-arms them).
_SCRATCH: dict = {}


def _scratch(x: torch.Tensor, stream: int, parts: int, counters: int):
    key = (x.device, stream)
    part, arrived = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(1 << (parts - 1).bit_length(),
                           dtype=torch.float32, device=x.device)
    if arrived is None or arrived.numel() < counters:
        arrived = torch.zeros(1 << (counters - 1).bit_length(),
                              dtype=torch.int32, device=x.device)
    _SCRATCH[key] = part, arrived
    return part.data_ptr(), arrived.data_ptr()


def _launch_f32(lib, x, w, bias_ptr, out, m, h, l_, d, layout, act) -> int:
    """One launch of the fp32 kernel (``gemm_heads_launch``): its plan, and
    where K is split, the scratch of the K ranges' partial sums and the
    counters of the blocks that have arrived at each output tile."""
    k, n = (d, l_) if layout == LHD_TRANSPOSED else (l_, d)
    plan = f32_plan(n, k, h, layout, w.dtype == torch.bfloat16)
    stream = stream_ptr(x)
    part = arrived = None
    if plan.parts > 1:
        tiles = math.ceil(m / F32_MT) * math.ceil(n / plan.bn)
        part, arrived = _scratch(x, stream, plan.parts * h * m * n,
                                 h * tiles)
    return lib.gemm_heads_launch(
        x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), part, arrived,
        m, h, l_, d, layout, dtype_code("gemm_heads", w), act, *plan, stream)


def _bias(name: str, x: torch.Tensor, bias: Optional[torch.Tensor], n: int):
    if bias is None:
        return None
    if bias.shape != (n,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} for N={n}")
    b = bias.float().contiguous()
    require_cuda(name, x, b)
    return b


def gemm(x: torch.Tensor, w: Union[torch.Tensor, WeightQ],
         bias: Optional[torch.Tensor] = None,
         activation: str = "none") -> torch.Tensor:
    """act(x [..., K] @ w [K, N] + bias) on the card; output in x's dtype.
    A ``WeightQ`` w (bf16 x only) is read as int8 and dequantized in
    registers, bitwise as the bf16 kernel on ``dequantize(w)``; its
    launches are also counted apart (``gemm.instances["gemm_wq"]``)."""
    wq = isinstance(w, WeightQ)
    mat = w.q if wq else w
    require_cuda("gemm", x, *((mat, w.scale) if wq else (mat,)))
    code = dtype_code("gemm", x)
    if wq and (x.dtype != torch.bfloat16 or mat.dtype != torch.int8
               or w.scale.dtype != torch.float32):
        raise TypeError(f"gemm: int8 weights take bf16 x and an fp32 "
                        f"scale, got x {x.dtype}, q {mat.dtype}, scale "
                        f"{w.scale.dtype}")
    if not wq and mat.dtype != x.dtype:
        raise TypeError(f"gemm: x is {x.dtype} but w is {mat.dtype}")
    if mat.dim() != 2 or x.shape[-1] != mat.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} @ "
                         f"{tuple(mat.shape)}")
    if wq and w.scale.numel() != mat.shape[1]:
        raise ValueError(f"gemm: scale {tuple(w.scale.shape)} for N="
                         f"{mat.shape[1]}")
    if activation not in ACT_CODE:
        raise ValueError(f"gemm: unknown activation {activation!r}")
    k, n = mat.shape
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    b = _bias("gemm", x, bias, n)
    bp = None if b is None else b.data_ptr()
    lib = _lib()
    if code == 0 and n < F32_NARROW:         # fp32, 1-7 columns
        rc = lib.gemm_f32_narrow_launch(x.data_ptr(), mat.data_ptr(), bp,
                                        out.data_ptr(), m, n, k,
                                        ACT_CODE[activation], stream_ptr(x))
    elif code == 0:                          # fp32: gemm_heads' kernel, H = 1
        rc = _launch_f32(lib, x, mat, bp, out, m, 1, k, n, HEAD_MAJOR,
                         ACT_CODE[activation])
    else:
        rc = lib.gemm_bf16_launch(x.data_ptr(), mat.data_ptr(),
                                  w.scale.data_ptr() if wq else None, bp,
                                  out.data_ptr(), m, n, k,
                                  ACT_CODE[activation],
                                  *gemm_plan(n, k, wq), stream_ptr(x))
        if wq:
            gemm.instances["gemm_wq"] += 1
    gemm.launches += 1
    check(lib, rc, "gemm")
    return out


gemm.launches = 0
gemm.instances = {"gemm_wq": 0}


class Int8Plan(NamedTuple):
    """The W8A8 kernel's launch: ``bn`` columns a block, ``kc`` rows of K
    a block (its K range) and ``parts`` K ranges (blocks a column tile)."""
    bn: int
    kc: int
    parts: int

    def blocks(self, n: int) -> int:
        """Blocks of one launch of at most 16 rows."""
        return math.ceil(n / self.bn) * self.parts


INT8_MT = 16                   # rows of x a block (csrc/gemm_int8.cu kMT)
INT8_STAGE = 8192              # bytes of w a ring stage (kStageBytes)
INT8_MAX_KC = 8192             # K rows a block at most (kMaxKc)
INT8_BLOCKS = 256              # blocks a decode launch asks for


@functools.lru_cache(maxsize=None)
def int8_plan(n: int, k: int) -> Int8Plan:
    """The W8A8 kernel's tiles for wq [K, N]: 128 columns a block from N =
    4096 up, else 64; then the fewest K ranges that give >= 256 blocks (two
    an SM), a range at least two ring stages of 8192 / bn rows and at most
    8192 rows. A function of (N, K) alone: the integer sums are exact, so
    no plan changes a bit, and none depends on M."""
    bn = 128 if n >= 4096 else 64
    bk = INT8_STAGE // bn
    parts = min(math.ceil(INT8_BLOCKS / math.ceil(n / bn)),
                max(1, k // (2 * bk)))
    parts = max(parts, math.ceil(k / INT8_MAX_KC))
    kc = math.ceil(math.ceil(k / parts) / bk) * bk
    return Int8Plan(bn, kc, math.ceil(k / kc))


def _lib_int8() -> ctypes.CDLL:
    lib = library("gemm_int8")
    if lib.gemm_int8_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_int8_launch.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.gemm_int8_launch.restype = i
    return lib


# (device, stream) -> (int32 sums [M, N], uint32 arrival counters): the
# split W8A8 kernel's scratch, zero between launches (its last blocks zero
# what they used), kept across calls and grown as needed
_SCRATCH_INT8: dict = {}


def _scratch_int8(x: torch.Tensor, stream: int, sums: int, counters: int):
    key = (x.device, stream)
    part, arrived = _SCRATCH_INT8.get(key, (None, None))
    if part is None or part.numel() < sums:
        part = torch.zeros(1 << (sums - 1).bit_length(), dtype=torch.int32,
                           device=x.device)
    if arrived is None or arrived.numel() < counters:
        arrived = torch.zeros(1 << (counters - 1).bit_length(),
                              dtype=torch.int32, device=x.device)
    _SCRATCH_INT8[key] = part, arrived
    return part.data_ptr(), arrived.data_ptr()


def gemm_int8(x: torch.Tensor, w: Union[torch.Tensor, WeightQ],
              bias: Optional[torch.Tensor] = None,
              activation: str = "none") -> torch.Tensor:
    """W8A8 on the card (the JAX ``gemm_int8_pallas_op``): one launch that
    quantizes x [..., K] per row as ``quantize_int8`` does (JAX quantizes
    outside its kernel; here no PyTorch op runs on x) and runs the integer
    GEMM with int32 accumulation and the epilogue (acc * x_scale) *
    w_scale (+ bias) -> act. Beyond 16 rows (a prefill) the library runs
    two kernels, the rows' quantization first, into scratch allocated
    here. A ``WeightQ``'s int8 tiles and scales are used as they are; any
    other w is quantized per column here, in PyTorch. bf16 x and output
    (the serving path's dtype)."""
    require_cuda("gemm_int8", x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gemm_int8: the kernel takes bf16 x, got {x.dtype}")
    if activation not in ACT_CODE:
        raise ValueError(f"gemm_int8: unknown activation {activation!r}")
    if isinstance(w, WeightQ):
        wq, ws = w.q, w.scale
    else:
        wq, ws = quantize_int8(w, dim=0)
    k = x.shape[-1]
    if wq.dim() != 2 or wq.shape[0] != k or wq.dtype != torch.int8:
        raise ValueError(f"gemm_int8: x {tuple(x.shape)} against w "
                         f"{tuple(wq.shape)} {wq.dtype}")
    n = wq.shape[1]
    if ws.dtype != torch.float32 or ws.numel() != n:
        raise ValueError(f"gemm_int8: scale {tuple(ws.shape)} {ws.dtype} "
                         f"for N={n}")
    require_cuda("gemm_int8", x, wq, ws)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    m = x.numel() // k if k else 0
    if m == 0:
        return out
    b = _bias("gemm_int8", x, bias, n)
    plan = int8_plan(n, k)
    stream = stream_ptr(x)
    part = arrived = None
    if plan.parts > 1:
        part, arrived = _scratch_int8(
            x, stream, m * n, math.ceil(m / INT8_MT) * math.ceil(n / plan.bn))
    xq = xs = None
    if m > INT8_MT:          # a prefill: the rows are quantized first, once
        xq = torch.empty(m, -(-k // 16) * 16, dtype=torch.int8,
                         device=x.device)
        xs = torch.empty(m, dtype=torch.float32, device=x.device)
    lib = _lib_int8()
    rc = lib.gemm_int8_launch(x.data_ptr(), wq.data_ptr(), ws.data_ptr(),
                              None if b is None else b.data_ptr(),
                              out.data_ptr(), part, arrived,
                              None if xq is None else xq.data_ptr(),
                              None if xs is None else xs.data_ptr(), m, n, k,
                              ACT_CODE[activation], *plan, stream)
    gemm_int8.launches += 1
    check(lib, rc, "gemm_int8")
    return out


gemm_int8.launches = 0


def gemm_heads(x: torch.Tensor, w: torch.Tensor, transpose_w: bool = False,
               head_major: bool = False) -> torch.Tensor:
    """Per-head fp32 products on the card, one launch for all heads.
    x fp32 [M, H, K]; w fp32 or bf16, read in place, in one of three
    layouts: w [L, H, D] with ``transpose_w``: out[m, h, l] = sum_d
    x[m, h, d] w[l, h, d] (K = D); w [L, H, D]: out[m, h, d] = sum_l
    x[m, h, l] w[l, h, d] (K = L); w [H, K, N] with ``head_major``:
    out[m, h, n] = sum_k x[m, h, k] w[h, k, n]. fp32 out."""
    require_cuda("gemm_heads", x, w)
    if x.dtype != torch.float32:
        raise TypeError(f"gemm_heads: x must be float32, got {x.dtype}")
    dtype_code("gemm_heads", w)
    m, h, k = x.shape
    if head_major:
        hw, l_, d = w.shape
        n = d
    else:
        l_, hw, d = w.shape
        n = l_ if transpose_w else d
    if (hw != h or k != (d if transpose_w else l_)
            or (head_major and transpose_w)):
        raise ValueError(f"gemm_heads: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)} (transpose_w={transpose_w}, "
                         f"head_major={head_major})")
    out = torch.empty(m, h, n, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    layout = HEAD_MAJOR if head_major else int(transpose_w)
    rc = _launch_f32(lib, x, w, None, out, m, h, l_, d, layout, 0)
    gemm_heads.launches += 1
    check(lib, rc, "gemm_heads")
    return out


gemm_heads.launches = 0

def gemm_cost(m, k, n, dtype_bytes=2):
    """JAX's ``gemm_cost``: the products' flops and each operand moved
    once."""
    return {"flops": 2.0 * m * k * n,
            "hbm_bytes": dtype_bytes * (m * k + k * n + m * n)}


def _gemm_supports(shapes, dtype):
    # x [..., K] against a 2-D w [K, N] (a WeightQ's int8 tensor), in fp32
    # or bf16; the plans take any K and N
    x, w = shapes[0], shapes[1]
    return (dtype in (None, torch.float32, torch.bfloat16) and len(w) == 2
            and x[-1] == w[0])


def _int8_supports(shapes, dtype):
    # the W8A8 kernel takes bf16 activations only
    return dtype in (None, torch.bfloat16) and _gemm_supports(shapes, dtype)


def _heads_supports(shapes, dtype):
    # x fp32 [M, H, K]; w [L, H, D] or, head-major, [H, K, N]
    x, w = shapes[0], shapes[1]
    return (dtype in (None, torch.float32) and len(x) == 3 and len(w) == 3
            and x[1] in (w[0], w[1]))


xaif.register("gemm", gemm_ref, gemm, cost_fn=gemm_cost,
              supports=_gemm_supports,
              description="fused GEMM (bias, activation), bf16 tensor-core "
                          "or fp32 kernel, int8 weights dequantized in "
                          "registers")
xaif.register("gemm", gemm_w8a8_ref, gemm_int8, backend="int8", lossy=True,
              cost_fn=gemm_cost, supports=_int8_supports,
              description="W8A8: activations quantized per row in the "
                          "kernel, int32 products, fused dequant")
xaif.register("gemm_heads", gemm_heads_ref, gemm_heads,
              supports=_heads_supports,
              description="per-head fp32 products, one launch for all heads")
