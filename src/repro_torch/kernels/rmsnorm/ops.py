"""Wrapper of the fused RMSNorm kernel (``csrc/rmsnorm.cu``) and its op."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (DTYPE_CODE, check, dtype_code,
                                        library, require_cuda, stream_ptr)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def _lib() -> ctypes.CDLL:
    lib = library("rmsnorm")
    if lib.rmsnorm_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [p, p, p, i, i, ctypes.c_float, i, i, p]
        lib.rmsnorm_launch.restype = i
        lib.rmsnorm_threads_per_row.argtypes = [i, i]
        lib.rmsnorm_threads_per_row.restype = i
    return lib


def rmsnorm_plan(d: int, dtype: torch.dtype) -> str:
    """The thread map the kernel takes for rows of d values of ``dtype``,
    as the card's library computes it: threads a row and rows a block (a
    row of fewer than 256 threads shares its block)."""
    tpr = _lib().rmsnorm_threads_per_row(d, DTYPE_CODE[dtype])
    rows = max(1, 256 // tpr)
    return f"{tpr} threads a row, {rows} row{'s' if rows > 1 else ''} a block"


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] normalized over d and scaled, in x's dtype, on the card."""
    require_cuda("rmsnorm", x, scale)
    code, scode = dtype_code("rmsnorm", x), dtype_code("rmsnorm", scale)
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for d={d}")
    m = x.numel() // d
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib = _lib()
    rc = lib.rmsnorm_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                            m, d, eps, code, scode, stream_ptr(x))
    rmsnorm.launches += 1
    check(lib, rc, "rmsnorm")
    return out


rmsnorm.launches = 0

xaif.register("rmsnorm", rmsnorm_ref, rmsnorm)
