"""Wrapper of the dropless MoE decode kernel (``csrc/moe_decode.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.moe_decode.ref import moe_decode_ref


def _lib() -> ctypes.CDLL:
    lib = library("moe_decode")
    if lib.moe_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_decode_launch.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.moe_decode_launch.restype = i
        lib.moe_decode_max_assignments.restype = i
    return lib


def moe_decode(x: torch.Tensor, expert_idx: torch.Tensor, gate: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """x [B, d]; expert_idx [B, K] int32; gate [B, K] fp32; w_gate / w_up
    [E, d, h], w_down [E, h, d] in x's dtype -> fp32 [B, d], on the card.
    Routing stays on the device: only experts that received an assignment
    with a nonzero gate are read."""
    require_cuda("moe_decode", x, expert_idx, gate, w_gate, w_up, w_down)
    code = dtype_code("moe_decode", x)
    if any(w.dtype != x.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError("moe_decode: the expert weights must be in x's dtype")
    if expert_idx.dtype != torch.int32 or gate.dtype != torch.float32:
        raise TypeError("moe_decode: expert_idx must be int32 and gate "
                        "float32")
    b, d = x.shape
    k = expert_idx.shape[1]
    e, _, h = w_gate.shape
    if (expert_idx.shape != (b, k) or gate.shape != (b, k)
            or w_gate.shape != (e, d, h) or w_up.shape != (e, d, h)
            or w_down.shape != (e, h, d)):
        raise ValueError(f"moe_decode: x {tuple(x.shape)}, expert_idx "
                         f"{tuple(expert_idx.shape)}, gate "
                         f"{tuple(gate.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    if d % 2 or h % 2:
        raise ValueError(f"moe_decode: d ({d}) and h ({h}) must be even "
                         f"(the panels are read two columns at a time)")
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    if b == 0 or k == 0:
        return out.zero_()
    lib = _lib()
    if b * k > lib.moe_decode_max_assignments():
        raise ValueError(f"moe_decode: {b * k} assignments, at most "
                         f"{lib.moe_decode_max_assignments()}")
    hidden = torch.empty(b * k, h, dtype=torch.float32, device=x.device)
    tok = torch.empty(b * k, d, dtype=torch.float32, device=x.device)
    rc = lib.moe_decode_launch(
        x.data_ptr(), expert_idx.data_ptr(), gate.data_ptr(),
        w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        hidden.data_ptr(), tok.data_ptr(), out.data_ptr(), b, k, e, d, h,
        code, stream_ptr(x))
    moe_decode.launches += 1
    check(lib, rc, "moe_decode")
    return out


moe_decode.launches = 0

xaif.register("moe_decode", moe_decode_ref, moe_decode)
