"""Plain PyTorch versions of multi-token verify attention (the JAX
``verify_decode_ref`` / ``verify_decode_paged_ref``).

Query i of sequence b attends positions ``<= cache_pos[b] + i``, the
window of the i-th sequential decode step. As in the JAX package, the
plain versions are BUILT as K1 applications of the single-token plain
versions at ``cache_pos + i``, so row i is bitwise the i-th sequential
step: greedy speculative tokens equal plain greedy tokens on this path by
construction.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attn_decode.ref import attn_decode_ref
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def verify_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache_pos: torch.Tensor,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, K1, D]; k [B, Hkv, S, D]; v [B, Hkv, S, Dv]; cache_pos [B]
    int32. Returns fp32 [B, Hq, K1, Dv]."""
    return torch.stack([attn_decode_ref(q[:, :, i], k, v, cache_pos + i,
                                        scale)
                        for i in range(q.shape[2])], dim=2)


def verify_decode_paged_ref(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, page_table: torch.Tensor,
                            cache_pos: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, K1, D]; pools [P, Hkv, ps, D]; page_table [B, NP] int32
    (-1 = unallocated, masked); cache_pos [B] int32. Returns fp32
    [B, Hq, K1, Dv]."""
    return torch.stack([paged_attention_ref(q[:, :, i], k_pages, v_pages,
                                            page_table, cache_pos + i, scale)
                        for i in range(q.shape[2])], dim=2)
