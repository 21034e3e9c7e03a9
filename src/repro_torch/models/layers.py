"""Shared layer primitives: RMSNorm, rotary embeddings, the SwiGLU MLP, the
depthwise causal conv of the Mamba mixer and initializers (port of
``repro.models.layers``).

Parameters are plain dicts of tensors, as the JAX package's pytrees, so
``convert.params_from_jax`` is copy-only. The perf-critical ops route
through the XAIF registry (gemm, rmsnorm) and so through the CUDA kernels
on the card.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif

# ---------------------------------------------------------------------------
# Init helpers (torch-native: the numbers differ from jax.random's)
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, fan_in: int, dtype,
                device) -> torch.Tensor:
    """N(0, 1 / fan_in) in ``dtype``, drawn in fp32."""
    w = torch.randn(*shape, generator=gen, device=device)
    return (w * fan_in ** -0.5).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    return normal_init(gen, (d_in, d_out), d_in, dtype, device)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (torch.randn(vocab, d, generator=gen, device=device) * 0.02
            ).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, policy: str,
            eps: float = 1e-5) -> torch.Tensor:
    return xaif.call("rmsnorm", policy, x, params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (interleaved pairs, as the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """Inverse frequencies for a rotary of ``head_dim`` dims (even)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / (theta ** exps)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rot_dims: Optional[int] = None) -> torch.Tensor:
    """x [B, H, T, D]; positions [T] or per sequence [B, T].

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` of the first
    ``rot_dims`` dims (all when None) — not HF's ``rotate_half`` layout."""
    d = x.shape[-1]
    rd = d if rot_dims is None else rot_dims
    xr, xp = x[..., :rd], x[..., rd:]
    inv = rope_frequencies(rd, float(theta), x.device)          # [rd/2]
    ang = positions[..., None].float() * inv                    # [.., T, rd/2]
    if ang.dim() == 3:
        ang = ang[:, None]                  # [B, 1, T, rd/2] over the heads
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < d else out


def rope_dims(cfg: ArchConfig) -> Optional[int]:
    if cfg.rope == "none":
        return 0
    if cfg.rope == "partial":
        rd = int(cfg.head_dim * cfg.rope_partial_pct)
        return rd - rd % 2
    return None  # full


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> Dict[str, torch.Tensor]:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def apply_mlp(params, x: torch.Tensor, policy: str) -> torch.Tensor:
    g = xaif.call("gemm", policy, x, params["w_gate"], activation="silu")
    u = xaif.call("gemm", policy, x, params["w_up"])
    # the product is taken in the activation dtype, as (g * u).astype(x.dtype)
    return xaif.call("gemm", policy, (g * u).to(x.dtype), params["w_down"])


# ---------------------------------------------------------------------------
# Causal 1-D depthwise conv (Mamba front conv)
# ---------------------------------------------------------------------------


def init_conv1d(gen: torch.Generator, channels: int, kernel: int, dtype,
                device) -> Dict[str, torch.Tensor]:
    """w [K, C] ~ N(0, 1 / K), b [C] zeros."""
    return {"w": normal_init(gen, (kernel, channels), kernel, dtype, device),
            "b": torch.zeros(channels, dtype=dtype, device=device)}


def apply_conv1d(params, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B, T, C]; state [B, K-1, C] carries the
    left context for decode. Returns (y [B, T, C], new_state [B, K-1, C]).

    The JAX order: the taps i = 0 .. K-1 are summed in fp32, then the
    bias, then the cast to x's dtype. Plain element-wise work (as in
    JAX): no kernel."""
    w, b = params["w"], params["b"]
    k, t = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros(x.shape[0], k - 1, x.shape[-1], dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # [B, T+K-1, C]
    y = xp[:, 0:t].float() * w[0].float()
    for i in range(1, k):
        y = y + xp[:, i:i + t].float() * w[i].float()
    y = (y + b.float()).to(x.dtype)
    return y, xp[:, xp.shape[1] - (k - 1):]
