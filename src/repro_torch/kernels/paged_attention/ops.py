"""Wrapper of the paged decode attention kernel (``csrc/paged_attention.cu``)
and its XAIF op ``attn_decode_paged``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import check, library, stream_ptr
from repro_torch.kernels.attn_decode.ops import MAX_GROUP, check_decode
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TILE = 64           # positions per tile of csrc/decode_tile.cuh


def _lib() -> ctypes.CDLL:
    lib = library("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_launch.restype = i
    return lib


def check_paged(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_table: torch.Tensor,
                cache_pos: torch.Tensor, max_rows: int) -> int:
    """``check_decode`` for page pools behind a [B, NP] int32 page table
    whose page size divides the tile."""
    code = check_decode(name, q, k_pages, v_pages, cache_pos, max_rows,
                        page_table)
    if page_table.dtype != torch.int32:
        raise TypeError(f"{name}: page_table must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} "
                         f"for q {tuple(q.shape)}")
    if TILE % k_pages.shape[2]:
        raise ValueError(f"{name}: page size {k_pages.shape[2]} must divide "
                         f"the {TILE}-position tile")
    return code


def attn_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_table: torch.Tensor,
                      cache_pos: torch.Tensor, scale: Optional[float] = None,
                      precise: bool = False) -> torch.Tensor:
    """q [B, Hq, 128]; pools [P, Hkv, ps, 128]; page_table [B, NP] int32;
    cache_pos [B] int32 -> fp32 [B, Hq, 128], on the card. GQA mode only."""
    if precise:
        raise NotImplementedError("attn_decode_paged: precise (MLA) mode is "
                                  "not ported yet")
    code = check_paged("attn_decode_paged", q, k_pages, v_pages, page_table,
                       cache_pos, MAX_GROUP)
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    np_ = page_table.shape[1]
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty(b, hq, d, dtype=torch.float32, device=q.device)
    if b == 0 or np_ == 0:
        return out
    lib = _lib()
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b, hq,
        hkv, ps, np_, scale, code, stream_ptr(q))
    attn_decode_paged.launches += 1
    check(lib, rc, "attn_decode_paged")
    return out


attn_decode_paged.launches = 0

xaif.register("attn_decode_paged", paged_attention_ref, attn_decode_paged)
