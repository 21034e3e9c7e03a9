"""Plain PyTorch version of paged decode attention (the JAX
``paged_attention_ref``): the pages are gathered through the page table
into a contiguous [B, Hkv, NP * ps, D] view and attended with the numerics
of ``attn_decode_ref`` in its two modes:

* GQA (default): cache-dtype operands, pre-scaled query, fp32
  accumulation, fp32 output;
* ``precise=True`` (MLA absorbed decode): the latent pages are both K and
  V (Hkv = 1), everything fp32, the scale applied after the dot products,
  and the optional second score component ``q2`` against ``k2_pages`` (the
  shared rotary key) added before it.

Positions past ``cache_pos`` and positions on an unallocated (-1) page are
masked, and their V rows are zeroed before the weighted sum (a masked
weight is exactly 0, but 0 * NaN is NaN), so junk in reused or unowned
pages and in the scratch page that every -1 entry gathers, where dead
slots write, never reaches a valid lane, as in the kernels, which never
read those rows. On the same KV (NP * ps equal to the contiguous extent)
each mode equals the contiguous plain version bit for bit: the paged
engine's token identity rests on it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attn_decode.ref import precise_attention

_NEG = -1e30


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pages [P, Hkv, ps, D], page_table [B, NP] -> [B, Hkv, NP * ps, D].
    Entries of -1 gather the scratch page 0; callers mask those lanes."""
    b, np_ = page_table.shape
    _, hkv, ps, d = pages.shape
    g = pages[page_table.clamp(min=0).long()]       # [B, NP, Hkv, ps, D]
    return g.transpose(1, 2).reshape(b, hkv, np_ * ps, d)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        cache_pos: torch.Tensor,
                        scale: Optional[float] = None,
                        q2: Optional[torch.Tensor] = None,
                        k2_pages: Optional[torch.Tensor] = None,
                        precise: bool = False) -> torch.Tensor:
    """q [B, Hq, D]; k_pages [P, Hkv, ps, D]; v_pages [P, Hkv, ps, Dv];
    page_table [B, NP] int32; cache_pos [B] int32 (positions <= cache_pos
    are valid); ``q2`` [B, Hq, rd] / ``k2_pages`` [P, 1, ps, rd] (precise
    mode). Returns fp32 [B, Hq, Dv]."""
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    s = page_table.shape[1] * ps
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    valid = ((torch.arange(s, device=q.device)[None, :]
              <= cache_pos.long()[:, None])
             & (page_table >= 0).repeat_interleave(ps, dim=1))  # [B, S]
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table).masked_fill(
        ~valid[:, None, :, None], 0)
    if precise:
        if hkv != 1:
            raise ValueError("precise mode is the MLA path: one latent head")
        k2 = None if q2 is None else gather_pages(k2_pages, page_table)[:, 0]
        return precise_attention(q, k[:, 0], v[:, 0], valid, scale, q2, k2)
    qg = (q.reshape(b, hkv, g, d) * scale).to(k_pages.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, v.shape[-1])
