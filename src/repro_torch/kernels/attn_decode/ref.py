"""Plain PyTorch version of contiguous decode attention (the JAX
``attn_decode_ref``), in its two numeric modes:

* GQA (default): cache-dtype operands, pre-scaled query, fp32
  accumulation, fp32 output;
* ``precise=True`` (MLA absorbed decode): everything fp32, the scale
  applied AFTER the dot products, and an optional second score component
  (``q2`` / ``k2``, the shared rotary key) added before scaling. One latent
  "KV head" serves every query head.
"""
from __future__ import annotations

from typing import Optional

import torch


def precise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor, scale: float,
                      q2: Optional[torch.Tensor] = None,
                      k2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The precise mode on one latent head, shared by the contiguous and the
    paged plain versions (so the two agree bit for bit on the same latent):
    q [B, Hq, D]; k [B, S, D]; v [B, S, Dv]; valid [B, S] bool; q2 [B, Hq,
    rd] / k2 [B, S, rd] (optional). Returns fp32 [B, Hq, Dv]."""
    logits = torch.einsum("bhd,bsd->bhs", q.float(), k.float())
    if q2 is not None:
        logits = logits + torch.einsum("bhd,bsd->bhs", q2.float(),
                                       k2.float())
    logits = (logits * scale).masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bsd->bhd", p, v.float())


def attn_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cache_pos: torch.Tensor, scale: Optional[float] = None,
                    q2: Optional[torch.Tensor] = None,
                    k2: Optional[torch.Tensor] = None,
                    precise: bool = False) -> torch.Tensor:
    """q [B, Hq, D]; k [B, Hkv, S, D]; v [B, Hkv, S, Dv]; cache_pos [B]
    (positions <= cache_pos are valid); ``q2`` [B, Hq, rd] / ``k2``
    [B, 1, S, rd] (precise mode). Returns fp32 [B, Hq, Dv]."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    valid = (torch.arange(s, device=q.device)[None, :]
             <= cache_pos.long()[:, None])                      # [B, S]
    if precise:
        if hkv != 1:
            raise ValueError("precise mode is the MLA path: one latent head")
        return precise_attention(q, k[:, 0], v[:, 0], valid, scale, q2,
                                 None if k2 is None else k2[:, 0])
    qg = (q.reshape(b, hkv, g, d) * scale).to(k.dtype)
    logits = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float())
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, hq, v.shape[-1])
