"""Plain PyTorch version of the Mamba selective scan (the JAX
``selective_scan_ref``: a sequential loop over time with an fp32 state)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt [B, T, Din]; a [Din, N]; b, c [B, T, N]; d [Din]; h0
    [B, Din, N] or None. Returns (y [B, T, Din] in u's dtype, h_T
    [B, Din, N] fp32):

        h_t = exp(dt_t * a) * h_{t-1} + (dt_t * u_t) * b_t
        y_t = (h_t * c_t).sum(-1) + d * u_t
    """
    bsz, t, din = u.shape
    n = a.shape[-1]
    uf, dtf = u.float(), dt.float()
    bf, cf, af = b.float(), c.float(), a.float()
    h = (torch.zeros(bsz, din, n, dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(t):
        da = torch.exp(dtf[:, i, :, None] * af)               # [B, Din, N]
        db = (dtf[:, i] * uf[:, i])[..., None] * bf[:, i, None, :]
        h = da * h + db
        ys.append((h * cf[:, i, None, :]).sum(dim=-1))        # [B, Din]
    y = torch.stack(ys, dim=1) if ys else uf.new_zeros(bsz, 0, din)
    y = y + d.float() * uf
    return y.to(u.dtype), h
