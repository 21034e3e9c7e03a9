"""Mamba-1 selective-SSM mixer, Jamba's sequence mixer (port of
``repro.models.mamba``).

Prefill runs the selective scan through the XAIF ``ssm_scan`` op; decode
is the O(1)-per-token recurrence on a carried (conv window, SSM state)
pair through ``ssm_decode`` (both hand-written kernels on the card). The
dtypes differ between the two on purpose, as in JAX: prefill hands the
scan dt in the activation dtype and gets y in it; decode hands
``ssm_decode`` fp32 operands and gets an fp32 y.

The projections go through the port's ``gemm`` op, x_proj and dt_proj
included (plain einsums in JAX): on the card that kernel reduces each row
in one fixed order whatever the batch, which ``torch.matmul`` does not
promise, and the serve engine's token equality with ``generate`` rests on
it. The state is written into the caller's cache views in place.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif
from repro_torch.models.layers import apply_conv1d, dense_init, init_conv1d


class MambaState(NamedTuple):
    conv: torch.Tensor         # [(L,) B, K-1, Din] activation dtype
    ssm: torch.Tensor          # [(L,) B, Din, N] fp32


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or max(1, -(-cfg.d_model // 16))
    return d_inner, dt_rank, m.d_state


def init_mamba(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
               device) -> Dict:
    """Random parameters from ``gen``, from the JAX package's
    distributions: S4D-real A (``a_log = log(1..N)`` per channel), a
    ``dt_bias`` whose softplus is log-uniform on [1e-3, 1e-1], ``d_skip =
    1``; the projections N(0, 1 / fan_in)."""
    d = cfg.d_model
    d_inner, dt_rank, n = _dims(cfg)
    f32 = torch.float32
    a_init = torch.arange(1, n + 1, dtype=f32, device=device)[None, :].repeat(
        d_inner, 1)
    dt = torch.exp(torch.rand(d_inner, generator=gen, dtype=f32, device=device)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": dense_init(gen, d, 2 * d_inner, dtype, device),
        "conv": init_conv1d(gen, d_inner, cfg.mamba.d_conv, dtype, device),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * n, dtype, device),
        "dt_proj": dense_init(gen, dt_rank, d_inner, dtype, device),
        "dt_bias": torch.log(torch.exp(dt) - 1.0 + 1e-9),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(d_inner, dtype=f32, device=device),
        "out_proj": dense_init(gen, d_inner, d, dtype, device),
    }


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device,
                     layers: int) -> MambaState:
    """Zeroed states of ``layers`` Mamba layers: conv [layers, B, K-1,
    Din] in ``dtype``, ssm [layers, B, Din, N] fp32."""
    d_inner, _, n = _dims(cfg)
    return MambaState(
        torch.zeros(layers, batch, cfg.mamba.d_conv - 1, d_inner,
                    dtype=dtype, device=device),
        torch.zeros(layers, batch, d_inner, n, dtype=torch.float32,
                    device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (logaddexp(x, 0)): max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_xdbc(params, xc: torch.Tensor, cfg: ArchConfig, policy: str):
    """xc [B, T, Din] (post-conv) -> (dt fp32, b, c) in xc's dtype."""
    _, dt_rank, n = _dims(cfg)
    xdbc = xaif.call("gemm", policy, xc, params["x_proj"])
    dt_low = xdbc[..., :dt_rank].contiguous()
    b = xdbc[..., dt_rank:dt_rank + n].contiguous()
    c = xdbc[..., dt_rank + n:].contiguous()
    dt = xaif.call("gemm", policy, dt_low, params["dt_proj"])
    return _softplus(dt.float() + params["dt_bias"].float()), b, c


def _in_proj(params, x: torch.Tensor, policy: str, conv_state):
    xz = xaif.call("gemm", policy, x, params["in_proj"])
    d_inner = xz.shape[-1] // 2
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, new_conv = apply_conv1d(params["conv"], xi, conv_state)
    xc = torch.nn.functional.silu(xc.float()).to(x.dtype)
    return xc, z, new_conv


def apply_mamba(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                state: Optional[MambaState] = None
                ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Full-sequence path. x [B, T, d] -> (y [B, T, d], state). With a
    ``state`` the scan starts from it and the final conv window and SSM
    state are written into it, in place."""
    xc, z, new_conv = _in_proj(params, x, policy,
                               None if state is None else state.conv)
    dt, b, c = _split_xdbc(params, xc, cfg, policy)
    a = -torch.exp(params["a_log"])
    h0 = None if state is None else state.ssm
    y, h_final = xaif.call("ssm_scan", policy, xc, dt.to(x.dtype), a, b, c,
                           params["d_skip"], h0)
    y = y.float() * torch.nn.functional.silu(z.float())
    out = xaif.call("gemm", policy, y.to(x.dtype), params["out_proj"])
    if state is not None:
        state.conv.copy_(new_conv)
        state.ssm.copy_(h_final)
    return out, state


def apply_mamba_decode(params, x: torch.Tensor, cfg: ArchConfig,
                       policy: str, state: MambaState
                       ) -> Tuple[torch.Tensor, MambaState]:
    """Single-token recurrence. x [B, 1, d]; ``state`` is advanced in
    place."""
    xc, z, new_conv = _in_proj(params, x, policy, state.conv)
    dt, b, c = _split_xdbc(params, xc, cfg, policy)          # [B, 1, ...]
    a = -torch.exp(params["a_log"])                          # [Din, N]
    # the step writes the new SSM state over the old one
    y, _ = xaif.call("ssm_decode", policy,
                     xc.float()[:, 0].contiguous(), dt[:, 0].contiguous(), a,
                     b.float()[:, 0].contiguous(),
                     c.float()[:, 0].contiguous(), params["d_skip"],
                     state.ssm, out=state.ssm)               # [B, Din]
    y = y * torch.nn.functional.silu(z.float()[:, 0])
    out = xaif.call("gemm", policy, y[:, None].to(x.dtype),
                    params["out_proj"])
    state.conv.copy_(new_conv)
    return out, state
