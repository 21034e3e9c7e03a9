"""Plain PyTorch version of dropless MoE decode (the JAX ``moe_decode_ref``:
a per-token gather of the selected experts' panels, fp32 multiply + reduce,
gate-weighted combine over k in order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_decode_ref(x: torch.Tensor, expert_idx: torch.Tensor,
                   gate: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """x [B, d]; expert_idx [B, K] int; gate [B, K] fp32 (dead slots carry
    zero gates); w_gate / w_up [E, d, h]; w_down [E, h, d]. Returns fp32
    [B, d]. Row b depends on x[b], expert_idx[b], gate[b] and the weights
    only (multiply + reduce per row, as the JAX ref, not a batched dot)."""
    b, d = x.shape
    xf = x.float()
    y = torch.zeros(b, d, dtype=torch.float32, device=x.device)
    for j in range(expert_idx.shape[1]):          # fixed combine order
        idx = expert_idx[:, j].long()
        wg = w_gate[idx].float()                  # [B, d, h]
        wu = w_up[idx].float()
        wd = w_down[idx].float()                  # [B, h, d]
        gact = (xf[:, :, None] * wg).sum(dim=1)   # [B, h]
        up = (xf[:, :, None] * wu).sum(dim=1)
        hidden = F.silu(gact) * up
        tok = (hidden[:, :, None] * wd).sum(dim=1)            # [B, d]
        y = y + gate[:, j].float()[:, None] * tok
    return y
