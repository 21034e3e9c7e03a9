"""Wrapper of the selective-scan kernel (``csrc/ssm_scan.cu``) and its op."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_aligned, require_cuda,
                                        stream_ptr)
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

STATE_SIZE = 16              # the d_state the kernel is built for (Jamba's)


def _lib() -> ctypes.CDLL:
    lib = library("ssm_scan")
    if lib.ssm_scan_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssm_scan_launch.argtypes = [p] * 9 + [i] * 5 + [p]
        lib.ssm_scan_launch.restype = i
    return lib


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt [B, T, Din] and b, c [B, T, N] in one dtype; a [Din, N], d
    [Din] and h0 [B, Din, N] (optional) fp32 -> (y [B, T, Din] in u's
    dtype, h_T [B, Din, N] fp32), on the card."""
    tensors = [u, dt, a, b, c, d] + ([] if h0 is None else [h0])
    require_cuda("ssm_scan", *tensors)
    code = dtype_code("ssm_scan", u)
    if any(t.dtype != u.dtype for t in (dt, b, c)):
        raise TypeError("ssm_scan: u, dt, b and c must share one dtype")
    if any(t.dtype != torch.float32 for t in [a, d] + tensors[6:]):
        raise TypeError("ssm_scan: a, d and h0 must be float32")
    bsz, t, din = u.shape
    n = a.shape[-1]
    if (dt.shape != u.shape or a.shape != (din, n) or b.shape != (bsz, t, n)
            or c.shape != (bsz, t, n) or d.shape != (din,)
            or (h0 is not None and h0.shape != (bsz, din, n))):
        raise ValueError(f"ssm_scan: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if n != STATE_SIZE:
        raise ValueError(f"ssm_scan: d_state {n}, the kernel is built for "
                         f"{STATE_SIZE}")
    # u, dt, b and c are staged by 16-byte copies, a and h0 read 4 values
    # at a time
    require_aligned("ssm_scan", u, dt, a, b, c, *tensors[6:])
    if din % (16 // u.element_size()):
        raise ValueError(f"ssm_scan: d_inner {din} must be a multiple of "
                         f"{16 // u.element_size()} (16-byte rows)")
    y = torch.empty_like(u)
    h = torch.empty(bsz, din, n, dtype=torch.float32, device=u.device)
    if bsz == 0 or din == 0:
        return y, h
    lib = _lib()
    rc = lib.ssm_scan_launch(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h.data_ptr(), bsz, t, din, n, code, stream_ptr(u))
    ssm_scan.launches += 1
    check(lib, rc, "ssm_scan")
    return y, h


ssm_scan.launches = 0

xaif.register("ssm_scan", selective_scan_ref, ssm_scan)
