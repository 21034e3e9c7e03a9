"""Wrapper of the dropless MoE decode kernel (``csrc/moe_decode.cu``) and
:func:`moe_plan`, the count of its column tiles at (d, h). The tile width
is one constant, never a function of the batch or of the routing, so an
assignment's sums go in one order whatever the step routes beside it."""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_aligned, require_cuda,
                                        stream_ptr)
from repro_torch.kernels.moe_decode.ref import moe_decode_ref

# csrc/moe_decode.cu
MAX_ROWS = 4                   # kMaxRows: assignments a block at once
MAX_ASSIGN = 2048              # kMaxAssign: B * K a launch
MAX_EXPERTS = 1024             # kMaxExperts: E a launch
STAGES, STAGE_ROWS = 4, 64     # kStages, kRows: the weight ring
CHUNKS = 8                     # kCH: 16-byte chunks a tile row


class MoEPlan(NamedTuple):
    """Column tiles of one expert's bf16 panels: of the up pass (the [d, h]
    panels of Wg and Wu) and of the down pass (Wd)."""
    up_tiles: int
    down_tiles: int

    def blocks(self, experts: int):
        """Blocks that read weights when ``experts`` experts are touched:
        (up, down)."""
        return self.up_tiles * experts, self.down_tiles * experts


def moe_smem(itemsize: int = 2):
    """Shared memory a block of each pass asks for, static arrays included
    (the expert bitmap, the assignment list, two ints), with panels of
    ``itemsize`` bytes: (up, down) bytes."""
    static = 4 * (MAX_EXPERTS // 32) + 4 * MAX_ASSIGN + 8

    def ring(mats, x_itemsize):
        return STAGES * (mats * STAGE_ROWS * CHUNKS * 16
                         + MAX_ROWS * STAGE_ROWS * x_itemsize)
    return ring(2, itemsize) + static, ring(1, 4) + static


def moe_plan(d: int, h: int) -> MoEPlan:
    """The kernel's tiles at (d, h): 64 bf16 columns each (``CHUNKS``
    chunks of 16 bytes), the same width at every shape. d is never split:
    at every served shape the touched experts' tiles fill the card, and
    one block reduces a whole column."""
    cols = CHUNKS * 8
    return MoEPlan(math.ceil(h / cols), math.ceil(d / cols))


def _lib() -> ctypes.CDLL:
    lib = library("moe_decode")
    if lib.moe_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_decode_launch.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.moe_decode_launch.restype = i
        for limit in (lib.moe_decode_max_assignments,
                      lib.moe_decode_max_experts):
            limit.argtypes, limit.restype = [], i
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
    if d % 8 or h % 8:
        raise ValueError(f"moe_decode: d ({d}) and h ({h}) must be multiples "
                         f"of 8 (the panels are copied 16 bytes at a time)")
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_decode: {e} experts, at most {MAX_EXPERTS}")
    require_aligned("moe_decode", x, w_gate, w_up, w_down)
    out = torch.empty(b, d, dtype=torch.float32, device=x.device)
    if b == 0 or k == 0:
        return out.zero_()
    if b * k > MAX_ASSIGN:
        raise ValueError(f"moe_decode: {b * k} assignments, at most "
                         f"{MAX_ASSIGN}")
    lib = _lib()
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

def moe_decode_cost(b, k, d, h, e, dtype_bytes=2):
    """JAX's ``moe_decode_cost``: the (at most) min(B K, E) touched
    experts' three panels read once."""
    flops = 6.0 * b * k * d * h
    touched = min(b * k, e)
    return {"flops": flops,
            "hbm_bytes": dtype_bytes * (3 * touched * d * h + 2 * b * d)}


def _supports(shapes, dtype):
    # x [B, d], expert_idx / gate [B, K], w_gate / w_up [E, d, h], w_down
    # [E, h, d]; d and h multiples of 8, E <= 1024, B K <= 2048
    x, idx, gate, wg, wu, wd = shapes[:6]
    b, d = x
    k = idx[1]
    e, _, h = wg
    return (dtype in (None, torch.float32, torch.bfloat16)
            and tuple(idx) == tuple(gate) == (b, k)
            and tuple(wg) == tuple(wu) == (e, d, h) and tuple(wd) == (e, h, d)
            and d % 8 == 0 and h % 8 == 0 and e <= MAX_EXPERTS
            and b * k <= MAX_ASSIGN)


xaif.register("moe_decode", moe_decode_ref, moe_decode,
              cost_fn=moe_decode_cost, supports=_supports,
              description="dropless MoE decode: routing on the card, only "
                          "touched experts' panels read")
