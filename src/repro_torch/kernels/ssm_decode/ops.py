"""Wrapper of the Mamba decode kernel (``csrc/ssm_decode.cu``) and the
``ssm_decode`` op. The op's mLSTM mode (``x`` rank 3) has its plain
version only: its kernel waits for the xLSTM slice."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, library, require_cuda,
                                        stream_ptr)
from repro_torch.kernels.ssm_decode.ref import ssm_decode_ref

STATE_SIZE = 16              # the d_state the kernel is built for (Jamba's)


def _lib() -> ctypes.CDLL:
    lib = library("ssm_decode")
    if lib.mamba_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mamba_decode_launch.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.mamba_decode_launch.restype = i
    return lib


def ssm_decode(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
               h: torch.Tensor, n: Optional[torch.Tensor] = None):
    """Mamba mode, on the card: x, g [B, Din]; a [Din, N]; b, c [B, N]; m
    [Din]; h [B, Din, N], all fp32 -> (y [B, Din], h_new [B, Din, N])."""
    if n is not None or x.dim() != 2:
        raise NotImplementedError(
            "ssm_decode: the mLSTM mode has no CUDA kernel yet (ROADMAP.md "
            "queue 1.4, xlstm-350m)")
    require_cuda("ssm_decode", x, g, a, b, c, m, h)
    if any(t.dtype != torch.float32 for t in (x, g, a, b, c, m, h)):
        raise TypeError("ssm_decode: the Mamba mode takes float32 tensors")
    bsz, din = x.shape
    ns = a.shape[-1]
    if (g.shape != x.shape or a.shape != (din, ns) or b.shape != (bsz, ns)
            or c.shape != (bsz, ns) or m.shape != (din,)
            or h.shape != (bsz, din, ns)):
        raise ValueError(f"ssm_decode: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, m "
                         f"{tuple(m.shape)}, h {tuple(h.shape)}")
    if ns != STATE_SIZE:
        raise ValueError(f"ssm_decode: d_state {ns}, the kernel is built "
                         f"for {STATE_SIZE}")
    if h.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError("ssm_decode: h and a must be 16-byte aligned (the "
                         "state is read 4 values at a time)")
    y = torch.empty_like(x)
    h_new = torch.empty_like(h)
    if bsz == 0 or din == 0:
        return y, h_new
    lib = _lib()
    rc = lib.mamba_decode_launch(
        x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        m.data_ptr(), h.data_ptr(), y.data_ptr(), h_new.data_ptr(), bsz, din,
        ns, stream_ptr(x))
    ssm_decode.launches += 1
    check(lib, rc, "ssm_decode")
    return y, h_new


ssm_decode.launches = 0

xaif.register("ssm_decode", ssm_decode_ref, ssm_decode)
