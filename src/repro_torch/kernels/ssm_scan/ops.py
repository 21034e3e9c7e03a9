"""Wrapper of the selective-scan kernel (``csrc/ssm_scan.cu``) and its op."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (DTYPE_CODE, check, dtype_code,
                                        library, require_aligned,
                                        require_cuda, stream_ptr)
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

def ssm_cost(b, t, din, n, dtype_bytes=2):
    """JAX's ``ssm_cost``."""
    return {"flops": 9.0 * b * t * din * n,
            "hbm_bytes": dtype_bytes * b * t * (3 * din + 2 * n)}


def _supports(shapes, dtype):
    # u [B, T, Din] in fp32 or bf16 with 16-byte rows; a [Din, 16], the
    # d_state the kernel is built for
    u, a = shapes[0], shapes[2]
    return (dtype in (None,) + tuple(DTYPE_CODE) and len(u) == 3
            and tuple(a) == (u[2], STATE_SIZE)
            and u[2] % (4 if dtype == torch.float32 else 8) == 0)


def ssm_scan_assoc(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *, chunk: int = 512
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``ssm_assoc_op`` (backend ``assoc``): the recurrence h' =
    A h + B prefix-combined within each chunk of ``chunk`` steps (halved
    until it divides T) in log2(chunk) levels, the state carried between
    chunks; fp32. Takes and returns what :func:`selective_scan_ref` does.
    PyTorch on every device: no kernel, no launch counter."""
    bsz, t, din = u.shape
    n = a.shape[-1]
    ch = min(chunk, t)
    while t % ch:
        ch //= 2
    uf, dtf, bf, cf = u.float(), dt.float(), b.float(), c.float()
    af = a.float()
    h = (torch.zeros(bsz, din, n, dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t0 in range(0, t, ch):
        dt_c, u_c = dtf[:, t0:t0 + ch], uf[:, t0:t0 + ch]
        da = torch.exp(dt_c[..., None] * af)            # [B, ch, Din, N]
        db = (dt_c * u_c)[..., None] * bf[:, t0:t0 + ch, None, :]
        step = 1
        while step < ch:      # (x then y) combine to (ax ay, ay bx + by)
            da, db = (torch.cat([da[:, :step], da[:, step:] * da[:, :-step]],
                                dim=1),
                      torch.cat([db[:, :step],
                                 da[:, step:] * db[:, :-step] + db[:, step:]],
                                dim=1))
            step *= 2
        hs = da * h[:, None] + db                        # [B, ch, Din, N]
        ys.append((hs * cf[:, t0:t0 + ch, None, :]).sum(dim=-1))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1) + d.float() * uf
    return y.to(u.dtype), h


xaif.register("ssm_scan", selective_scan_ref, ssm_scan, cost_fn=ssm_cost,
              supports=_supports,
              description="selective scan, fp32 state in registers, chunks "
                          "of T split over blocks")
xaif.register("ssm_scan", ssm_scan_assoc, ssm_scan_assoc, backend="assoc",
              cost_fn=ssm_cost,
              description="chunked associative scan in PyTorch on every "
                          "device, log-depth within a chunk")
