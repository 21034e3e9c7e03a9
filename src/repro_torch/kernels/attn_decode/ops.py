"""Wrappers of the decode attention kernels: GQA mode
(``csrc/attn_decode.cu``) and precise (MLA) mode
(``csrc/attn_decode_mla.cu``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (DTYPE_CODE, check, dtype_code,
                                        library, require_aligned,
                                        require_cuda, stream_ptr)
from repro_torch.kernels.attn_decode.ref import attn_decode_ref

HEAD_DIMS = (128, 64)   # the GQA kernel's instances (csrc/decode_tile.cuh)
MAX_GROUP = 16      # query heads per KV head the wrappers take
MLA_LATENT, MLA_ROPE, MLA_MAX_HEADS = 512, 64, 16   # csrc/attn_decode_mla.cu


def _lib() -> ctypes.CDLL:
    lib = library("attn_decode")
    if lib.attn_decode_hd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_decode_hd_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        lib.attn_decode_hd_launch.restype = i
        lib.decode_rows_per_block.argtypes = [i, i, i]
        lib.decode_rows_per_block.restype = i
    return lib


def _lib_mla() -> ctypes.CDLL:
    lib = library("attn_decode_mla")
    if lib.attn_decode_mla_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attn_decode_mla_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        lib.attn_decode_mla_launch.restype = i
        lib.mla_tiles_per_round.argtypes = [i]
        lib.mla_tiles_per_round.restype = i
    return lib


def check_decode(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, cache_pos: torch.Tensor, max_rows: int,
                 *more: torch.Tensor) -> int:
    """Validate what every GQA decode-attention kernel takes; returns the
    dtype code. q is [B, Hq, D] or [B, Hq, K1, D], D one of ``HEAD_DIMS``;
    k/v are a cache [B, Hkv, S, D] or page pools [P, Hkv, ps, D], 16-byte
    aligned (the kernel stages them by cp.async); a KV head has Hq / Hkv *
    K1 query rows, at most ``max_rows``. ``more`` must lie on the card
    too."""
    require_cuda(name, q, k, v, cache_pos, *more)
    require_aligned(name, k, v)
    code = dtype_code(name, q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype")
    if cache_pos.dtype != torch.int32:
        raise TypeError(f"{name}: cache_pos must be int32")
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    hkv = k.shape[1]
    rows = hq // hkv * (q.shape[2] if q.dim() == 4 else 1)
    if (d not in HEAD_DIMS or k.dim() != 4 or k.shape[-1] != d
            or v.shape != k.shape or cache_pos.shape != (b,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k/v {tuple(k.shape)} "
                         f"/ {tuple(v.shape)}, cache_pos "
                         f"{tuple(cache_pos.shape)} (head dim must be one "
                         f"of {HEAD_DIMS})")
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


def check_precise(name: str, q: torch.Tensor, q2: torch.Tensor,
                  c: torch.Tensor, k2: torch.Tensor, cache_pos: torch.Tensor,
                  *more: torch.Tensor) -> int:
    """Validate what both precise (MLA) kernels take; returns the dtype code.
    q fp32 [B, H, 512] and q2 fp32 [B, H, 64], at most 16 heads; the latent
    c [N, 1, R, 512] (K and V at once) and the rotary key k2 [N, 1, R, 64]
    in one dtype, 16-byte aligned (the kernel stages them by cp.async), N
    x R being sequences x positions or pool pages x page size; cache_pos
    [B] int32. ``more`` must lie on the card too."""
    require_cuda(name, q, c, cache_pos, q2, k2, *more)
    require_aligned(name, c, k2)
    code = dtype_code(name, c)
    if q.dtype != torch.float32 or q2.dtype != torch.float32:
        raise TypeError(f"{name}: q and q2 must be float32")
    if k2.dtype != c.dtype or cache_pos.dtype != torch.int32:
        raise TypeError(f"{name}: k2 must share the latent's dtype and "
                        f"cache_pos be int32")
    b, h = q.shape[0], q.shape[1]
    n, r = c.shape[0], c.shape[2] if c.dim() == 4 else -1
    if (q.shape != (b, h, MLA_LATENT) or q2.shape != (b, h, MLA_ROPE)
            or c.shape != (n, 1, r, MLA_LATENT)
            or k2.shape != (n, 1, r, MLA_ROPE) or cache_pos.shape != (b,)
            or h > MLA_MAX_HEADS):
        raise ValueError(f"{name}: q {tuple(q.shape)}, q2 {tuple(q2.shape)}, "
                         f"latent {tuple(c.shape)}, k2 {tuple(k2.shape)}, "
                         f"cache_pos {tuple(cache_pos.shape)} (the kernel "
                         f"takes a {MLA_LATENT}-d latent, a {MLA_ROPE}-d "
                         f"rotary key and at most {MLA_MAX_HEADS} heads)")
    return code


def _attn_decode_precise(q: torch.Tensor, c: torch.Tensor,
                         cache_pos: torch.Tensor, scale: float,
                         q2: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Precise (MLA absorbed) decode on the card: q fp32 [B, H, 512], q2
    fp32 [B, H, 64], the latent c [B, 1, S, 512] (K and V at once) and the
    rotary key k2 [B, 1, S, 64] in the model dtype, cache_pos [B] int32 ->
    fp32 [B, H, 512]."""
    name = "attn_decode(precise)"
    code = check_precise(name, q, q2, c, k2, cache_pos)
    b, h, _ = q.shape
    s = c.shape[2]
    if c.shape[0] != b:
        raise ValueError(f"{name}: q {tuple(q.shape)} and a latent "
                         f"{tuple(c.shape)} of another batch")
    out = torch.empty(b, h, MLA_LATENT, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = _lib_mla()
    rc = lib.attn_decode_mla_launch(q.data_ptr(), q2.data_ptr(), c.data_ptr(),
                                    k2.data_ptr(), cache_pos.data_ptr(),
                                    out.data_ptr(), b, h, s, scale, code,
                                    stream_ptr(q))
    attn_decode.launches += 1
    check(lib, rc, name)
    return out


def decode_plan(b: int, hq: int, hkv: int, k1: int = 1, d: int = 128) -> str:
    """The block plan the GQA decode kernel (csrc/decode_tile.cuh, all four
    wrappers) takes at these shapes and head dim ``d``, as the card's
    library computes it, with the thread map of the instance."""
    rows = hq // hkv * k1
    rb = _lib().decode_rows_per_block(b, hkv, rows)
    z = -(-rows // rb)
    split = ("a warp a position's score, V dims of 2 row sets" if d == 128
             else "8 lanes a position's score, V over 4 position spans")
    return (f"D {d}: grid ({hkv}, {b}, {z}) = {hkv * b * z} blocks of {rb} "
            f"row{'s' if rb > 1 else ''}; {split}")


def mla_plan(b: int, h: int, dtype: torch.dtype) -> str:
    """The block plan the precise (MLA) decode kernel (csrc/mla_tile.cuh,
    both instances) takes at these shapes, as the card's library computes
    it."""
    tpr = _lib_mla().mla_tiles_per_round(DTYPE_CODE[dtype])
    return (f"grid ({h}, {b}) = {h * b} blocks of 1 head, rounds of {tpr} "
            f"tile{'s' if tpr > 1 else ''} of 32")


def attn_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cache_pos: torch.Tensor, scale: Optional[float] = None,
                q2: Optional[torch.Tensor] = None,
                k2: Optional[torch.Tensor] = None,
                precise: bool = False) -> torch.Tensor:
    """GQA mode: q [B, Hq, D]; k/v [B, Hkv, S, D]; cache_pos [B] int32 ->
    fp32 [B, Hq, D], on the card, D one of ``HEAD_DIMS``. ``precise=True``
    (MLA) launches the MLA kernel (same counter): v must be k itself (the
    latent is both), and q2 / k2 the rotary query and key."""
    if precise:
        if v.data_ptr() != k.data_ptr() or v.shape != k.shape:
            raise ValueError("attn_decode(precise): the kernel reads the "
                             "latent once as K and V, so v must be k")
        if q2 is None or k2 is None:
            raise ValueError("attn_decode(precise): q2 and k2 are required")
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return _attn_decode_precise(q, k, cache_pos, scale, q2, k2)
    if q2 is not None or k2 is not None:
        raise ValueError("attn_decode: q2 / k2 belong to the precise mode")
    code = check_contiguous("attn_decode", q, k, v, cache_pos, MAX_GROUP)
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, d, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = _lib()
    rc = lib.attn_decode_hd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   cache_pos.data_ptr(), out.data_ptr(), b,
                                   hq, hkv, s, d, scale, code, stream_ptr(q))
    attn_decode.launches += 1
    check(lib, rc, "attn_decode")
    return out


attn_decode.launches = 0

xaif.register("attn_decode", attn_decode_ref, attn_decode)
