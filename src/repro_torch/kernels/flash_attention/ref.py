"""Plain PyTorch version of attention (the JAX ``attention_ref``, GQA-aware)."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, T, D], k [B, Hkv, S, D], v [B, Hkv, S, Dv], Hq % Hkv == 0
    -> [B, Hq, T, Dv].
    Causal masking is bottom-right: query t sees keys s <= t + (S - T)."""
    _, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    if causal:
        mask = torch.ones(t, s, dtype=torch.bool,
                          device=q.device).tril(diagonal=s - t)
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vf).to(q.dtype)
