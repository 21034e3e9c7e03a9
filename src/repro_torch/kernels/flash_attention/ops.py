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

def attention_cost(b, hq, t, s, d, dtype_bytes=2):
    """JAX's ``attention_cost``."""
    flops = 4.0 * b * hq * t * s * d
    return {"flops": flops,
            "hbm_bytes": dtype_bytes * b * (2 * hq * t * d + 2 * hq * s * d)}


def _supports(shapes, dtype):
    # the instances' (q/k, v) head dims in this dtype (JAX's Pallas kernel
    # needs dv == d and so rejects MLA's (192, 128), which this kernel
    # has; it has no fp32 (64, 64)); one batch, GQA groups
    q, k, v = shapes[0], shapes[1], shapes[2]
    dims = {torch.float32: HEAD_DIMS_FP32, torch.bfloat16: HEAD_DIMS,
            None: HEAD_DIMS + HEAD_DIMS_FP32}.get(dtype, ())
    return (len(q) == len(k) == len(v) == 4 and (q[3], v[3]) in dims
            and k[3] == q[3] and v[:3] == k[:3] and k[0] == q[0]
            and q[1] % k[1] == 0)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        *, bq: int = 512, bkv: int = 1024) -> torch.Tensor:
    """The JAX ``attention_blockwise_op`` (backend ``blockwise``): online
    softmax over q blocks of ``bq`` and kv blocks of ``bkv`` rows (each
    halved until it divides T / S), in fp32, never materialising [T, S].
    q [B, Hq, T, Dqk], k [B, Hkv, S, Dqk], v [B, Hkv, S, Dv] (Dv may
    differ: MLA) -> [B, Hq, T, Dv] in q's dtype, the causal mask
    bottom-right (query t sees keys <= t + S - T). PyTorch on every
    device: no kernel, no launch counter."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    bq_ = min(bq, t)
    while t % bq_:
        bq_ //= 2
    bkv_ = min(bkv, s)
    while s % bkv_:
        bkv_ //= 2
    offset = s - t
    rows = torch.arange(bq_, device=q.device)[:, None]
    cols = torch.arange(bkv_, device=q.device)[None, :]
    outs = []
    for q0 in range(0, t, bq_):
        qblk = q[:, :, q0:q0 + bq_].float() * scale
        m = torch.full((b, hq, bq_, 1), -1e30, device=q.device)
        l_ = torch.zeros(b, hq, bq_, 1, device=q.device)
        o = torch.zeros(b, hq, bq_, dv, device=q.device)
        for k0 in range(0, s, bkv_):
            kr = k[:, :, k0:k0 + bkv_].float().repeat_interleave(g, dim=1)
            vr = v[:, :, k0:k0 + bkv_].float().repeat_interleave(g, dim=1)
            sc = torch.einsum("bhtd,bhsd->bhts", qblk, kr)
            if causal:
                keep = k0 + cols <= q0 + rows + offset
                sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
            m_n = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_n)
            alpha = torch.exp(m - m_n)
            l_ = l_ * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bhts,bhsd->bhtd", p, vr)
            m = m_n
        outs.append(o / l_.clamp_min(1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


xaif.register("attention", attention_ref, attention, cost_fn=attention_cost,
              supports=_supports,
              description="flash attention, online softmax, GQA: the bf16 "
                          "tensor-core kernel or the fp32 scalar one")
xaif.register("attention", attention_blockwise, attention_blockwise,
              backend="blockwise", cost_fn=attention_cost,
              description="PyTorch online softmax over q / kv blocks on "
                          "every device; never materialises [T, S]")
