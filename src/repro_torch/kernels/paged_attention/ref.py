"""Plain PyTorch version of paged decode attention (the JAX
``paged_attention_ref``, GQA mode): the pages are gathered through the
page table into a contiguous [B, Hkv, NP * ps, D] view and attended with
the numerics of ``attn_decode_ref`` (cache-dtype operands, pre-scaled
query, fp32 accumulation, fp32 output). Positions past ``cache_pos`` and
positions on an unallocated (-1) page are masked, so junk in reused or
unowned pages never reaches a valid lane."""
from __future__ import annotations

from typing import Optional

import torch

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
                        precise: bool = False) -> torch.Tensor:
    """q [B, Hq, D]; k_pages [P, Hkv, ps, D]; v_pages [P, Hkv, ps, Dv];
    page_table [B, NP] int32; cache_pos [B] int32 (positions <= cache_pos
    are valid). Returns fp32 [B, Hq, Dv]."""
    if precise:
        raise NotImplementedError("precise (MLA) paged decode attention is "
                                  "not ported yet")
    b, hq, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    s = page_table.shape[1] * ps
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    valid = ((torch.arange(s, device=q.device)[None, :]
              <= cache_pos.long()[:, None])
             & (page_table >= 0).repeat_interleave(ps, dim=1))  # [B, S]
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    qg = (q.reshape(b, hkv, g, d) * scale).to(k_pages.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, v.shape[-1])
