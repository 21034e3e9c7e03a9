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

``out``, when given, receives the new state (h_new in the Mamba mode, C'
in the mLSTM mode) and is returned in its place. It has the state's shape
and dtype and may be the state itself (``out=h``): the step then updates
the state in place, as the JAX engine's jitted scan updates its carry.
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


def check_out(name: str, out: Optional[torch.Tensor],
              state: torch.Tensor) -> None:
    """``out`` must take the new state whole: the state's shape, dtype and
    device."""
    if out is not None and (out.shape != state.shape
                            or out.dtype != state.dtype
                            or out.device != state.device):
        raise ValueError(f"{name}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} for a state {tuple(state.shape)} "
                         f"{state.dtype} on {state.device}")


def ssm_decode_ref(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, m: torch.Tensor,
                   h: torch.Tensor, n: Optional[torch.Tensor] = None, *,
                   out: Optional[torch.Tensor] = None):
    check_out("ssm_decode", out, h)
    if n is None:
        y, h_new = mamba_decode_ref(x, g, a, b, c, m, h)
        return y, (h_new if out is None else out.copy_(h_new))
    h_out, (c_new, n_new, m_new) = mlstm_decode_ref(x, g, a, b, c, m, h, n)
    if out is not None:
        c_new = out.copy_(c_new)
    return h_out, (c_new, n_new, m_new)
