"""Wrappers of the GEMM kernels (``csrc/gemm.cu``, ``csrc/gemm_int8.cu``)
and their XAIF ops: the fused GEMM (bf16 / fp32 weights, or int8
``WeightQ`` weights dequantized on the fly), its lossy W8A8 backend
``int8`` (activations quantized per row, integer products), and
``gemm_heads``, the per-head fp32 products of MLA's absorbed decode and of
the xLSTM mixers' block-diagonal weights."""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.gemm.ref import (WeightQ, gemm_heads_ref, gemm_ref,
                                          gemm_w8a8_ref, int8_operands)

# csrc/gemm_epilogue.cuh Act
ACT_CODE = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}


def _lib() -> ctypes.CDLL:
    lib = library("gemm")
    if lib.gemm_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.gemm_launch.restype = i
        lib.gemm_wq_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.gemm_wq_launch.restype = i
        lib.gemm_heads_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gemm_heads_launch.restype = i
    return lib


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
    if wq:
        rc = lib.gemm_wq_launch(x.data_ptr(), mat.data_ptr(),
                                w.scale.data_ptr(), bp, out.data_ptr(), m, n,
                                k, ACT_CODE[activation], stream_ptr(x))
        gemm.instances["gemm_wq"] += 1
    else:
        rc = lib.gemm_launch(x.data_ptr(), mat.data_ptr(), bp,
                             out.data_ptr(), m, n, k, code,
                             ACT_CODE[activation], stream_ptr(x))
    gemm.launches += 1
    check(lib, rc, "gemm")
    return out


gemm.launches = 0
gemm.instances = {"gemm_wq": 0}


def _lib_int8() -> ctypes.CDLL:
    lib = library("gemm_int8")
    if lib.gemm_int8_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_int8_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.gemm_int8_launch.restype = i
    return lib


def gemm_int8(x: torch.Tensor, w: Union[torch.Tensor, WeightQ],
              bias: Optional[torch.Tensor] = None,
              activation: str = "none") -> torch.Tensor:
    """W8A8 on the card (the JAX ``gemm_int8_pallas_op``): x [..., K]
    quantized per row in plain PyTorch, as JAX does outside its kernel;
    a ``WeightQ``'s int8 tiles and scales used as they are, any other w
    quantized per column; then the integer GEMM with int32 accumulation
    and the epilogue (acc * x_scale) * w_scale (+ bias) -> act. bf16 x
    and output (the serving path's dtype)."""
    require_cuda("gemm_int8", x)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gemm_int8: the kernel takes bf16 x, got {x.dtype}")
    if activation not in ACT_CODE:
        raise ValueError(f"gemm_int8: unknown activation {activation!r}")
    k = x.shape[-1]
    xq, xs, wq, ws = int8_operands(x.reshape(-1, k), w)
    if wq.dim() != 2 or wq.shape[0] != k or wq.dtype != torch.int8:
        raise ValueError(f"gemm_int8: x {tuple(x.shape)} against w "
                         f"{tuple(wq.shape)} {wq.dtype}")
    m, n = xq.shape[0], wq.shape[1]
    ws = ws.float().contiguous()
    if ws.numel() != n:
        raise ValueError(f"gemm_int8: scale {tuple(ws.shape)} for N={n}")
    require_cuda("gemm_int8", x, xq, xs, wq, ws)
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    b = _bias("gemm_int8", x, bias, n)
    lib = _lib_int8()
    rc = lib.gemm_int8_launch(xq.data_ptr(), wq.data_ptr(), xs.data_ptr(),
                              ws.data_ptr(),
                              None if b is None else b.data_ptr(),
                              out.data_ptr(), m, n, k, ACT_CODE[activation],
                              stream_ptr(x))
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
    wcode = dtype_code("gemm_heads", w)
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
    layout = 2 if head_major else int(transpose_w)   # csrc/gemm.cu HeadLayout
    rc = lib.gemm_heads_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), m,
                               h, l_, d, layout, wcode, stream_ptr(x))
    gemm_heads.launches += 1
    check(lib, rc, "gemm_heads")
    return out


gemm_heads.launches = 0

xaif.register("gemm", gemm_ref, gemm)
xaif.register("gemm", gemm_w8a8_ref, gemm_int8, backend="int8", lossy=True)
xaif.register("gemm_heads", gemm_heads_ref, gemm_heads)
