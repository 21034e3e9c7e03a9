"""Plain PyTorch version of the entropy-exit op (the JAX ``entropy_ref``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def log_vocab(v: int) -> float:
    """log(V) rounded to float32, as the JAX package computes it."""
    return float(np.log(np.float32(v)))


def entropy_ref(logits: torch.Tensor) -> torch.Tensor:
    """Normalized softmax entropy over the last axis, in [0, 1], fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ent = -(logp.exp() * logp).sum(dim=-1)
    return ent / log_vocab(logits.shape[-1])
