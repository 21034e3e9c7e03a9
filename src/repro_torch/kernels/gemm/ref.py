"""Plain PyTorch version of the fused GEMM (the JAX ``gemm_ref`` numerics)."""
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
