"""Wrappers of the paged decode attention kernels: GQA mode
(``csrc/paged_attention.cu``) and precise (MLA) mode
(``csrc/paged_attention_mla.cu``), behind one XAIF op
``attn_decode_paged``."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import check, library, stream_ptr
from repro_torch.kernels.attn_decode.ops import (MAX_GROUP, MLA_LATENT,
                                                 check_decode, check_precise)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TILE = 64           # positions per tile of csrc/decode_tile.cuh
MLA_TILE = 32       # positions per tile of csrc/mla_tile.cuh


def _lib() -> ctypes.CDLL:
    lib = library("paged_attention")
    if lib.paged_attention_hd_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_hd_launch.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_hd_launch.restype = i
    return lib


def _lib_mla() -> ctypes.CDLL:
    lib = library("paged_attention_mla")
    if lib.paged_attention_mla_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_mla_launch.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, i, p]
        lib.paged_attention_mla_launch.restype = i
    return lib


def _check_table(name: str, q: torch.Tensor, page_table: torch.Tensor,
                 ps: int, tile: int) -> None:
    if page_table.dtype != torch.int32:
        raise TypeError(f"{name}: page_table must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != q.shape[0]:
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} "
                         f"for q {tuple(q.shape)}")
    if tile % ps:
        raise ValueError(f"{name}: page size {ps} must divide the "
                         f"{tile}-position tile")


def check_paged(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, page_table: torch.Tensor,
                cache_pos: torch.Tensor, max_rows: int) -> int:
    """``check_decode`` for page pools behind a [B, NP] int32 page table
    whose page size divides the tile."""
    code = check_decode(name, q, k_pages, v_pages, cache_pos, max_rows,
                        page_table)
    _check_table(name, q, page_table, k_pages.shape[2], TILE)
    return code


def _attn_decode_paged_precise(q: torch.Tensor, c_pages: torch.Tensor,
                               page_table: torch.Tensor,
                               cache_pos: torch.Tensor, scale: float,
                               q2: torch.Tensor,
                               kr_pages: torch.Tensor) -> torch.Tensor:
    """Precise (MLA absorbed) paged decode on the card: q fp32 [B, H, 512],
    q2 fp32 [B, H, 64], latent pages c_pages [P, 1, ps, 512] (K and V at
    once) and rotary pages kr_pages [P, 1, ps, 64] in the model dtype,
    page_table [B, NP] int32, cache_pos [B] int32 -> fp32 [B, H, 512]."""
    name = "attn_decode_paged(precise)"
    code = check_precise(name, q, q2, c_pages, kr_pages, cache_pos,
                         page_table)
    b, h, _ = q.shape
    ps = c_pages.shape[2]
    _check_table(name, q, page_table, ps, MLA_TILE)
    np_ = page_table.shape[1]
    out = torch.empty(b, h, MLA_LATENT, dtype=torch.float32, device=q.device)
    if b == 0 or np_ == 0:
        return out
    lib = _lib_mla()
    rc = lib.paged_attention_mla_launch(
        q.data_ptr(), q2.data_ptr(), c_pages.data_ptr(), kr_pages.data_ptr(),
        page_table.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b, h,
        ps, np_, scale, code, stream_ptr(q))
    attn_decode_paged.launches += 1
    check(lib, rc, name)
    return out


def attn_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_table: torch.Tensor,
                      cache_pos: torch.Tensor, scale: Optional[float] = None,
                      q2: Optional[torch.Tensor] = None,
                      k2_pages: Optional[torch.Tensor] = None,
                      precise: bool = False) -> torch.Tensor:
    """GQA mode: q [B, Hq, D]; pools [P, Hkv, ps, D]; page_table [B, NP]
    int32; cache_pos [B] int32 -> fp32 [B, Hq, D], on the card, D one of
    ``attn_decode.ops.HEAD_DIMS``.
    ``precise=True`` (MLA) launches the precise paged kernel (same
    counter): v_pages must be k_pages itself (the latent pages are both),
    and q2 / k2_pages the rotary query and the rotary key's pages."""
    if precise:
        if (v_pages.data_ptr() != k_pages.data_ptr()
                or v_pages.shape != k_pages.shape):
            raise ValueError("attn_decode_paged(precise): the kernel reads "
                             "the latent pages once as K and V, so v_pages "
                             "must be k_pages")
        if q2 is None or k2_pages is None:
            raise ValueError("attn_decode_paged(precise): q2 and k2_pages "
                             "are required")
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        return _attn_decode_paged_precise(q, k_pages, page_table, cache_pos,
                                          scale, q2, k2_pages)
    if q2 is not None or k2_pages is not None:
        raise ValueError("attn_decode_paged: q2 / k2_pages belong to the "
                         "precise mode")
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
    rc = lib.paged_attention_hd_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b, hq,
        hkv, ps, np_, d, scale, code, stream_ptr(q))
    attn_decode_paged.launches += 1
    check(lib, rc, "attn_decode_paged")
    return out


attn_decode_paged.launches = 0

xaif.register("attn_decode_paged", paged_attention_ref, attn_decode_paged)
