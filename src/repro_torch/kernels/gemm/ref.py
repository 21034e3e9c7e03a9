"""Plain PyTorch versions of the fused GEMM (the JAX ``gemm_ref``
numerics) and of the per-head fp32 products of MLA's absorbed decode."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def gemm_ref(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             activation: str = "none") -> torch.Tensor:
    """x [..., K] @ w [K, N] (+ bias) -> activation, fp32 accumulate."""
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(x.dtype)


# elements of one multiply + reduce temporary [rows, H, K, N] (64 MiB fp32)
_CHUNK_ELEMS = 1 << 24


def gemm_heads_ref(x: torch.Tensor, w: torch.Tensor, transpose_w: bool = False,
                   head_major: bool = False) -> torch.Tensor:
    """x fp32 [M, H, K]; w [L, H, D]. ``transpose_w``: the JAX einsum
    "bhd,lhd->bhl" (K = D); else "bhl,lhd->bhd" (K = L); ``head_major``: w
    [H, K, N] and "bhk,hkn->bhn" (the xLSTM mixers' block-diagonal
    weights). fp32 out.

    A multiply + reduce per row, not a batched dot, so that a row's bits
    never depend on how many rows share the call (the serve engine's token
    equality with the one-request loop rests on this). Rows go through in
    chunks, so the temporary stays under 64 MiB at a long prefill."""
    if head_major:
        wf = w.float()                                    # [H, K, N]
    else:
        wf = w.float().permute(1, 0, 2)                   # [H, L, D]
    step = max(1, _CHUNK_ELEMS // max(1, wf.numel()))
    outs = []
    for x_ in x.float().split(step):
        if transpose_w:
            outs.append((x_[:, :, None, :] * wf[None]).sum(dim=-1))
        else:
            outs.append((x_[:, :, :, None] * wf[None]).sum(dim=-2))
    return torch.cat(outs) if len(outs) > 1 else outs[0]
