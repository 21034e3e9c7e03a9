"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (DTYPE_CODE, check, dtype_code,
                                        library, require_aligned,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.flash_attention.ref import attention_ref

# (q/k head dim, v head dim) the kernel is instantiated for: GQA, MLA
# prefill (128 decompressed + 64 rotary dims per head, values of 128) and,
# in bf16, musicgen's heads of 64; the fp32 instance also for the seizure
# transformer's heads of 16
HEAD_DIMS = ((128, 128), (192, 128), (64, 64))
HEAD_DIMS_FP32 = ((128, 128), (192, 128), (16, 16))


def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.flash_attention_launch.restype = i
    return lib


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, T, Dqk], k [B, Hkv, S, Dqk], v [B, Hkv, S, Dv] ->
    [B, Hq, T, Dv] on the card, causal mask bottom-right; (Dqk, Dv) is one
    of ``HEAD_DIMS`` (fp32: ``HEAD_DIMS_FP32``). bf16 runs the tensor-core
    kernel; fp32 runs the scalar one, whose launches are also counted
    apart (``attention.instances["attention_fp32"]``)."""
    require_cuda("attention", q, k, v)
    code = dtype_code("attention", q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("attention: q, k, v must share one dtype")
    b, hq, t, d = q.shape
    dv = v.shape[-1]
    dims = HEAD_DIMS_FP32 if code == DTYPE_CODE[torch.float32] else HEAD_DIMS
    if ((d, dv) not in dims or k.shape[-1] != d
            or v.shape[:-1] != k.shape[:-1]):
        raise ValueError(f"attention: the kernel takes (q/k, v) head dims "
                         f"{dims} in {q.dtype}; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hkv, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or hq % hkv:
        raise ValueError(f"attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    require_aligned("attention", q, k, v)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, t, dv, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
        t, s, d, dv, int(causal), scale, code, stream_ptr(q))
    attention.launches += 1
    if code == DTYPE_CODE[torch.float32]:
        attention.instances["attention_fp32"] += 1
    check(lib, rc, "attention")
    return out


attention.launches = 0
attention.instances = {"attention_fp32": 0}

xaif.register("attention", attention_ref, attention)
