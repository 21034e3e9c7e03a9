"""Plain PyTorch version of contiguous decode attention (the JAX
``attn_decode_ref``, GQA mode: cache-dtype operands, pre-scaled query,
fp32 accumulation, fp32 output)."""
from __future__ import annotations

from typing import Optional

import torch


def attn_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache_pos: torch.Tensor, scale: Optional[float] = None,
                    precise: bool = False) -> torch.Tensor:
    """q [B, Hq, D]; k [B, Hkv, S, D]; v [B, Hkv, S, Dv]; cache_pos [B]
    (positions <= cache_pos are valid). Returns fp32 [B, Hq, Dv]."""
    if precise:
        raise NotImplementedError("precise (MLA) decode attention is not "
                                  "ported yet")
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    valid = (torch.arange(s, device=q.device)[None, :]
             <= cache_pos.long()[:, None])                      # [B, S]
    qg = (q.reshape(b, hkv, g, d) * scale).to(k.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, v.shape[-1])
