"""Plain PyTorch version of the single-token recurrent decode steps (the
JAX ``ssm_decode_ref``), in two modes told apart by the rank of ``x``:

* Mamba (``x`` [B, Din]): one step of the selective-SSM recurrence. ``x``
  = the conv + silu activation u, ``g`` = dt (softplus output), ``a`` = A
  [Din, N], ``b`` / ``c`` = [B, N], ``m`` = d_skip [Din], ``h`` = the SSM
  state [B, Din, N], all fp32. Returns (y [B, Din], h_new [B, Din, N]).
* mLSTM (``x`` [B, H, dh], with the normalizer state ``n``): the
  matrix-LSTM cell step. ``x``, ``g``, ``a`` = q, k, v [B, H, dh]; ``b``,
  ``c`` = the input and forget log-gates [B, H]; ``m`` = the stabilizer
  [B, H]; ``h`` = the cell state [B, H, dh, dh]; ``n`` [B, H, dh], all
  fp32. Returns (h_out [B, H, dh], (c_new, n_new, m_new)).
"""
from __future__ import annotations

from typing import Optional

import torch


def mamba_decode_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
                     h: torch.Tensor):
    da = torch.exp(g[:, :, None] * a)                    # [B, Din, N]
    db = (g * x)[..., None] * b[:, None, :]
    h_new = da * h + db
    y = (h_new * c[:, None, :]).sum(dim=-1)              # [B, Din]
    return y + m * x, h_new


def mlstm_decode_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
                     h: torch.Tensor, n: torch.Tensor):
    qx, kx, vx, li, lf = x, g, a, b, c
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    c_new = fw[..., None, None] * h + iw[..., None, None] * (
        kx[..., :, None] * vx[..., None, :])             # [B, H, dh, dh]
    n_new = fw[..., None] * n + iw[..., None] * kx
    h_num = torch.einsum("bhd,bhde->bhe", qx, c_new)
    denom = torch.maximum((qx * n_new).sum(dim=-1).abs(), torch.exp(-m_new))
    return h_num / denom[..., None], (c_new, n_new, m_new)


def ssm_decode_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
                   h: torch.Tensor, n: Optional[torch.Tensor] = None):
    if n is None:
        return mamba_decode_ref(x, g, a, b, c, m, h)
    return mlstm_decode_ref(x, g, a, b, c, m, h, n)
