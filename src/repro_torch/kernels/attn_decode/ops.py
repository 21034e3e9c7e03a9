"""Wrapper of the decode attention kernel (``csrc/attn_decode.cu``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (check, dtype_code, library,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.attn_decode.ref import attn_decode_ref

HEAD_DIM = 128
MAX_GROUP = 16      # query heads per KV head one block serves


def _lib() -> ctypes.CDLL:
    lib = library("attn_decode")
    if lib.attn_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_decode_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.attn_decode_launch.restype = i
    return lib


def check_decode(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cache_pos: torch.Tensor, max_rows: int,
                 *more: torch.Tensor) -> int:
    """Validate what every decode-attention kernel takes; returns the dtype
    code. q is [B, Hq, D] or [B, Hq, K1, D]; k/v are a cache [B, Hkv, S, D]
    or page pools [P, Hkv, ps, D]; each block serves Hq / Hkv * K1 query
    rows, at most ``max_rows``. ``more`` must lie on the card too."""
    require_cuda(name, q, k, v, cache_pos, *more)
    code = dtype_code(name, q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype")
    if cache_pos.dtype != torch.int32:
        raise TypeError(f"{name}: cache_pos must be int32")
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    hkv = k.shape[1]
    rows = hq // hkv * (q.shape[2] if q.dim() == 4 else 1)
    if (d != HEAD_DIM or k.dim() != 4 or k.shape[-1] != d
            or v.shape != k.shape or cache_pos.shape != (b,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                         f"/ {tuple(v.shape)}, cache_pos "
                         f"{tuple(cache_pos.shape)} (head dim must be "
                         f"{HEAD_DIM})")
    if hq % hkv or rows > max_rows:
        raise ValueError(f"{name}: {hq} query heads over {hkv} KV heads "
                         f"give {rows} rows a block; at most {max_rows}")
    return code


def check_contiguous(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cache_pos: torch.Tensor,
                     max_rows: int) -> int:
    """``check_decode`` for a contiguous cache: one row per sequence."""
    code = check_decode(name, q, k, v, cache_pos, max_rows)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and a cache "
                         f"{tuple(k.shape)} of another batch")
    return code


def attn_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cache_pos: torch.Tensor, scale: Optional[float] = None,
                precise: bool = False) -> torch.Tensor:
    """q [B, Hq, 128]; k/v [B, Hkv, S, 128]; cache_pos [B] int32 ->
    fp32 [B, Hq, 128], on the card. GQA mode only."""
    if precise:
        raise NotImplementedError("attn_decode: precise (MLA) mode is not "
                                  "ported yet")
    code = check_contiguous("attn_decode", q, k, v, cache_pos, MAX_GROUP)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, d, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = _lib()
    rc = lib.attn_decode_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                cache_pos.data_ptr(), out.data_ptr(), b, hq,
                                hkv, s, scale, code, stream_ptr(q))
    attn_decode.launches += 1
    check(lib, rc, "attn_decode")
    return out


attn_decode.launches = 0

xaif.register("attn_decode", attn_decode_ref, attn_decode)
