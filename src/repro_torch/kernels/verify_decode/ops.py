"""Wrappers of the verify attention kernels (``csrc/verify_decode.cu``) and
their XAIF ops ``verify_decode`` and ``verify_decode_paged``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import check, library, stream_ptr
from repro_torch.kernels.attn_decode.ops import check_contiguous
from repro_torch.kernels.paged_attention.ops import check_paged
from repro_torch.kernels.verify_decode.ref import (verify_decode_paged_ref,
                                                   verify_decode_ref)

MAX_ROWS = 64       # g * K1 query rows of one (sequence, KV head)


def _lib() -> ctypes.CDLL:
    lib = library("verify_decode")
    if lib.verify_decode_hd_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.verify_decode_hd_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.verify_decode_hd_launch.restype = i
        lib.verify_decode_paged_hd_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
        lib.verify_decode_paged_hd_launch.restype = i
    return lib


def verify_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cache_pos: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, K1, D]; k/v [B, Hkv, S, D]; cache_pos [B] int32 -> fp32
    [B, Hq, K1, D], on the card, D one of ``attn_decode.ops.HEAD_DIMS``."""
    code = check_contiguous("verify_decode", q, k, v, cache_pos, MAX_ROWS)
    b, hq, k1, d = q.shape
    _, hkv, s, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, k1, d, dtype=torch.float32, device=q.device)
    if b == 0 or s == 0 or k1 == 0:
        return out
    lib = _lib()
    rc = lib.verify_decode_hd_launch(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), cache_pos.data_ptr(),
                                     out.data_ptr(), b, hq, hkv, k1, s, d,
                                     scale, code, stream_ptr(q))
    verify_decode.launches += 1
    check(lib, rc, "verify_decode")
    return out


def verify_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        cache_pos: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, K1, D]; pools [P, Hkv, ps, D]; page_table [B, NP] int32;
    cache_pos [B] int32 -> fp32 [B, Hq, K1, D], on the card, D one of
    ``attn_decode.ops.HEAD_DIMS``."""
    code = check_paged("verify_decode_paged", q, k_pages, v_pages,
                       page_table, cache_pos, MAX_ROWS)
    b, hq, k1, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    np_ = page_table.shape[1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, k1, d, dtype=torch.float32, device=q.device)
    if b == 0 or np_ == 0 or k1 == 0:
        return out
    lib = _lib()
    rc = lib.verify_decode_paged_hd_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b, hq,
        hkv, k1, ps, np_, d, scale, code, stream_ptr(q))
    verify_decode_paged.launches += 1
    check(lib, rc, "verify_decode_paged")
    return out


verify_decode.launches = 0
verify_decode_paged.launches = 0

xaif.register("verify_decode", verify_decode_ref, verify_decode)
xaif.register("verify_decode_paged", verify_decode_paged_ref,
              verify_decode_paged)
