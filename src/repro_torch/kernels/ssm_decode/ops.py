"""Wrapper of the recurrent decode kernels and the ``ssm_decode`` op, in
two modes told apart by the rank of ``x`` (as the plain version,
``ref.py``): the Mamba step (``csrc/ssm_decode.cu``) and the mLSTM step
(``csrc/mlstm_decode.cu``). One launch counter counts both. Both take
``out=``, the new state's destination, which may be the state itself."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, library, require_aligned,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.ssm_decode.ref import check_out, ssm_decode_ref

STATE_SIZE = 16              # the d_state the kernel is built for (Jamba's)


def _lib() -> ctypes.CDLL:
    lib = library("ssm_decode")
    if lib.mamba_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mamba_decode_launch.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.mamba_decode_launch.restype = i
    return lib


def _mlstm_lib() -> ctypes.CDLL:
    lib = library("mlstm_decode")
    if lib.mlstm_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mlstm_decode_launch.argtypes = [p] * 12 + [i] * 3 + [p]
        lib.mlstm_decode_launch.restype = i
    return lib


def _new_state(out: Optional[torch.Tensor], state: torch.Tensor
               ) -> torch.Tensor:
    """The tensor the kernel writes the new state into: ``out`` (the state
    itself, or a tensor that shares none of its memory), else a new one."""
    if out is None:
        return torch.empty_like(state)
    check_out("ssm_decode", out, state)
    require_cuda("ssm_decode", out)
    require_aligned("ssm_decode", out)
    if out.data_ptr() != state.data_ptr():
        lo, hi = state.data_ptr(), state.data_ptr() + state.nbytes
        if out.data_ptr() < hi and lo < out.data_ptr() + out.nbytes:
            raise ValueError("ssm_decode: out overlaps the state without "
                             "being it")
    return out


def ssm_decode(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
               h: torch.Tensor, n: Optional[torch.Tensor] = None, *,
               out: Optional[torch.Tensor] = None):
    """On the card. Mamba mode (``x`` rank 2, no ``n``): x, g [B, Din]; a
    [Din, N]; b, c [B, N]; m [Din]; h [B, Din, N], all fp32 -> (y [B, Din],
    h_new [B, Din, N]). mLSTM mode (``x`` rank 3, with ``n``): see
    :func:`mlstm_decode`. ``out`` receives the new state (h_new, or C' in
    the mLSTM mode) and is returned in its place; it may be the state
    itself (the step then updates it in place)."""
    if (n is not None) != (x.dim() == 3) or x.dim() not in (2, 3):
        raise ValueError(f"ssm_decode: x of rank {x.dim()} "
                         f"{'with' if n is not None else 'without'} n: the "
                         f"Mamba mode takes x [B, Din] and no n, the mLSTM "
                         f"mode x [B, H, dh] and n")
    if n is not None:
        return mlstm_decode(x, g, a, b, c, m, h, n, out=out)
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
    if any(t.data_ptr() % 16 for t in (h, a, b, c)):
        raise ValueError("ssm_decode: h, a, b and c must be 16-byte aligned "
                         "(they are read 4 values at a time)")
    y = torch.empty_like(x)
    h_new = _new_state(out, h)
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


def mlstm_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 li: torch.Tensor, lf: torch.Tensor, m: torch.Tensor,
                 c: torch.Tensor, n: torch.Tensor, *,
                 out: Optional[torch.Tensor] = None):
    """The mLSTM mode of ``ssm_decode``, on the card: q, k, v [B, H, dh];
    li, lf, m [B, H]; c [B, H, dh, dh]; n [B, H, dh], all fp32 -> (h [B,
    H, dh], (c_new, n_new, m_new)). c_new is ``out`` when given (c itself
    for an update in place), else new; n_new and m_new are always new:
    other blocks of a launch read n and m while the first column block
    writes them. Counted in ``ssm_decode.launches``."""
    require_cuda("ssm_decode", q, k, v, li, lf, m, c, n)
    if any(t.dtype != torch.float32 for t in (q, k, v, li, lf, m, c, n)):
        raise TypeError("ssm_decode: the mLSTM mode takes float32 tensors")
    bsz, hh, dh = q.shape
    if (k.shape != q.shape or v.shape != q.shape or n.shape != q.shape
            or any(t.shape != (bsz, hh) for t in (li, lf, m))
            or c.shape != (bsz, hh, dh, dh)):
        raise ValueError(f"ssm_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, li "
                         f"{tuple(li.shape)}, lf {tuple(lf.shape)}, m "
                         f"{tuple(m.shape)}, c {tuple(c.shape)}, n "
                         f"{tuple(n.shape)}")
    if dh % 4 or c.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("ssm_decode: the mLSTM mode reads c and v 4 values "
                         "at a time: dh % 4 == 0, 16-byte aligned c and v")
    h_out = torch.empty_like(q)
    c_new, n_new, m_new = (_new_state(out, c), torch.empty_like(n),
                           torch.empty_like(m))
    if h_out.numel() == 0:
        return h_out, (c_new, n_new, m_new)
    lib = _mlstm_lib()
    rc = lib.mlstm_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), li.data_ptr(),
        lf.data_ptr(), m.data_ptr(), c.data_ptr(), n.data_ptr(),
        h_out.data_ptr(), c_new.data_ptr(), n_new.data_ptr(),
        m_new.data_ptr(), bsz, hh, dh, stream_ptr(q))
    ssm_decode.launches += 1
    check(lib, rc, "ssm_decode (mLSTM)")
    return h_out, (c_new, n_new, m_new)


ssm_decode.launches = 0

xaif.register("ssm_decode", ssm_decode_ref, ssm_decode)
