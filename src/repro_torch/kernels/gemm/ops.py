"""Wrappers of the GEMM kernels (``csrc/gemm.cu``) and their XAIF ops: the
fused GEMM, and ``gemm_heads``, the per-head fp32 products of MLA's
absorbed decode and of the xLSTM mixers' block-diagonal weights."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.gemm.ref import gemm_heads_ref, gemm_ref

ACT_CODE = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}   # csrc/gemm.cu Act


def _lib() -> ctypes.CDLL:
    lib = library("gemm")
    if lib.gemm_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.gemm_launch.restype = i
        lib.gemm_heads_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.gemm_heads_launch.restype = i
    return lib


def gemm(x: torch.Tensor, w: torch.Tensor,
         bias: Optional[torch.Tensor] = None,
         activation: str = "none") -> torch.Tensor:
    """act(x [..., K] @ w [K, N] + bias) on the card; output in x's dtype."""
    require_cuda("gemm", x, w)
    code = dtype_code("gemm", x)
    if w.dtype != x.dtype:
        raise TypeError(f"gemm: x is {x.dtype} but w is {w.dtype}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if activation not in ACT_CODE:
        raise ValueError(f"gemm: unknown activation {activation!r}")
    k, n = w.shape
    m = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    b = None
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"gemm: bias {tuple(bias.shape)} for N={n}")
        b = bias.float().contiguous()
        require_cuda("gemm", x, b)
    lib = _lib()
    rc = lib.gemm_launch(x.data_ptr(), w.data_ptr(),
                         None if b is None else b.data_ptr(), out.data_ptr(),
                         m, n, k, code, ACT_CODE[activation], stream_ptr(x))
    gemm.launches += 1
    check(lib, rc, "gemm")
    return out


gemm.launches = 0


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
xaif.register("gemm_heads", gemm_heads_ref, gemm_heads)
