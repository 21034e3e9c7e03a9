"""Token-choice top-k Mixture of Experts (port of ``repro.models.moe``):
capacity-bounded scatter dispatch for prefill, DROPLESS per-token dispatch
for serve decode.

* **Capacity path** (``apply_moe`` — prefill): per group (one sequence)
  each token's position-in-expert comes from a sort-based ranking, tokens
  are scattered into a [G, E, C, d] buffer, run through the stacked expert
  SwiGLUs and gathered back weighted by the router gate. Tokens over
  capacity are dropped: their update is zero and their slot index clamps
  to ``capacity - 1``, exactly as the JAX package does. The expert
  products are plain batched matmuls here, as they are plain einsums
  (outside any Pallas kernel) in JAX.
* **Dropless path** (``apply_moe_decode`` — one-token decode): each
  token's top-k expert SwiGLUs go through the ``moe_decode`` op (the
  hand-written kernel on the card). No capacity, no drops, so a slot's
  output depends on its own hidden state only — whatever other requests
  share the batch.

Both take a ``valid`` mask that keeps dead/retired serve slots out of
routing. Shared experts (DeepSeek) run densely on every token.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core import xaif
from repro_torch.models.layers import apply_mlp, init_mlp, normal_init


def init_moe(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
             device) -> Dict:
    """Random MoE parameters from ``gen`` (the router in fp32, as JAX)."""
    m, d, e, h = cfg.moe, cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    p = {"router": normal_init(gen, (d, e), d, torch.float32, device),
         "w_gate_e": normal_init(gen, (e, d, h), d, dtype, device),
         "w_up_e": normal_init(gen, (e, d, h), d, dtype, device),
         "w_down_e": normal_init(gen, (e, h, d), h, dtype, device)}
    if m.num_shared_experts > 0:
        d_sh = m.d_shared_expert or m.num_shared_experts * m.d_expert
        p["shared"] = init_mlp(gen, d, d_sh, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Shared router / ranking core
# ---------------------------------------------------------------------------


def _route(router: torch.Tensor, xg: torch.Tensor, m: MoEConfig,
           policy: str, row_stable: bool = False):
    """xg [G, S, d] -> (probs [G, S, E], gate_vals [G, S, K], expert_idx
    [G, S, K] int64). fp32 logits -> softmax -> top-k, gates renormalized
    over the selected k.

    ``row_stable`` (the decode path): the logits go through the port's fp32
    ``gemm`` op (on the card a kernel that reduces every row over d in one
    fixed order with one tiling for every row count) and the renorm sum is
    taken in a fixed order, so a row's routing never depends on how many
    rows share the call. A flipped ulp upstream of top-k could send a token
    to other experts. Prefill keeps the plain fp32 product."""
    xf = xg.float()
    if row_stable:
        logits = xaif.call("gemm", policy, xf, router.float())
    else:
        logits = torch.matmul(xf, router.float())
    probs = torch.softmax(logits, dim=-1)                        # [G, S, E]
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    if row_stable:
        tot = gate_vals[..., 0]
        for j in range(1, m.top_k):
            tot = tot + gate_vals[..., j]
        tot = tot[..., None]
    else:
        tot = gate_vals.sum(dim=-1, keepdim=True)
    gate_vals = gate_vals / torch.clamp(tot, min=1e-9)
    return probs, gate_vals, expert_idx


def sorted_run_ranks(sorted_vals: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal values, along the last
    axis of an already-sorted array (the JAX package's ``_tiling``
    helper): mark run starts, carry the latest start index with a running
    max, subtract."""
    n = sorted_vals.shape[-1]
    iota = torch.arange(n, device=sorted_vals.device).expand(
        sorted_vals.shape)
    is_start = torch.ones_like(sorted_vals, dtype=torch.bool)
    is_start[..., 1:] = sorted_vals[..., 1:] != sorted_vals[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=-1).values
    return iota - seg_start


def _ranked_positions(expert_idx: torch.Tensor, m: MoEConfig,
                      vg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-major position-in-expert of each (token, k) assignment
    [G, S, K]. ``vg`` [G, S] bool: invalid tokens sort into a sentinel
    segment past every real expert, so they consume no capacity and the
    valid tokens' ranks ignore their contents."""
    g, s, k = expert_idx.shape
    flat_e = expert_idx.reshape(g, s * k)
    flat_sort = flat_e
    if vg is not None:
        vflat = vg.repeat_interleave(k, dim=1)                   # [G, S*K]
        flat_sort = torch.where(vflat, flat_e, m.num_experts)
    order = torch.argsort(flat_sort, dim=1, stable=True)
    sorted_e = torch.gather(flat_sort, 1, order)
    pos_sorted = sorted_run_ranks(sorted_e)
    pos_flat = torch.zeros_like(flat_e).scatter_(1, order, pos_sorted)
    return pos_flat.reshape(g, s, k)


def _group_capacity(s: int, m: MoEConfig) -> int:
    return max(1, math.ceil(s * m.top_k / m.num_experts * m.capacity_factor))


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, m: MoEConfig,
              w: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss; ``w`` [N] weighs each token (valid mask)."""
    k = m.top_k
    counts = torch.zeros(m.num_experts, dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, expert_idx.reshape(-1),
                      w.repeat_interleave(k))
    n = torch.clamp(w.sum(), min=1.0)
    density = counts / n
    density_proxy = (probs.reshape(-1, m.num_experts) * w[:, None]).sum(0) / n
    aux = m.num_experts * torch.sum(density / k * density_proxy)
    return aux * m.router_aux_weight


# ---------------------------------------------------------------------------
# Capacity-bounded scatter dispatch (prefill)
# ---------------------------------------------------------------------------


def apply_moe(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
              groups: Optional[int] = None,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], aux_loss). ``groups``: independent
    capacity groups (default B, one per sequence). ``valid`` [B, T] bool:
    tokens marked False take no capacity, add nothing to the aux counts and
    get a zero routed output."""
    m = cfg.moe
    b, t, d = x.shape
    g = b if groups is None else groups
    s = (b * t) // g
    xg = x.reshape(g, s, d)
    vg = None if valid is None else valid.reshape(g, s)

    probs, gate_vals, expert_idx = _route(params["router"], xg, m, policy)
    capacity = _group_capacity(s, m)
    pos = _ranked_positions(expert_idx, m, vg)
    keeps = [pos[:, :, j] < capacity for j in range(m.top_k)]
    if vg is not None:
        keeps = [kj & vg for kj in keeps]
    positions = [torch.clamp(pos[:, :, j], max=capacity - 1)
                 for j in range(m.top_k)]
    gidx = torch.arange(g, device=x.device)[:, None].expand(g, s)

    # dispatch: scatter tokens into [G, E, C, d]; a dropped assignment adds
    # a zero update at the clamped slot
    buf = torch.zeros(g, m.num_experts, capacity, d, dtype=x.dtype,
                      device=x.device)
    for j in range(m.top_k):
        upd = torch.where(keeps[j][..., None], xg, torch.zeros_like(xg))
        buf.index_put_((gidx, expert_idx[:, :, j], positions[j]), upd,
                       accumulate=True)

    # expert SwiGLU: stacked per-expert products
    # (weights cast to the activation dtype: a no-op unless an fp32 config
    # runs on bf16 weights)
    flat = buf.transpose(0, 1).reshape(m.num_experts, g * capacity, d)
    gact = torch.bmm(flat, params["w_gate_e"].to(x.dtype))
    up = torch.bmm(flat, params["w_up_e"].to(x.dtype))
    hidden = (torch.nn.functional.silu(gact.float()) * up.float()).to(x.dtype)
    out_buf = torch.bmm(hidden, params["w_down_e"].to(x.dtype)).reshape(
        m.num_experts, g, capacity, d).transpose(0, 1)          # [G, E, C, d]

    # combine: gather back with gate weighting
    combine = [gate_vals[:, :, j] * keeps[j].float() for j in range(m.top_k)]
    if m.renorm_kept:
        tot = torch.clamp(sum(combine), min=1e-9)
        combine = [c / tot for c in combine]
    y = torch.zeros(g, s, d, dtype=torch.float32, device=x.device)
    for j in range(m.top_k):
        tok = out_buf[gidx, expert_idx[:, :, j], positions[j]]  # [G, S, d]
        y = y + combine[j][..., None] * tok.float()

    if "shared" in params:
        y = y + apply_mlp(params["shared"], xg, policy).float()

    w = (torch.ones(g * s, device=x.device) if vg is None
         else vg.reshape(-1).float())
    aux = _aux_loss(probs, expert_idx, m, w)
    return y.reshape(b, t, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Dropless per-token dispatch (serve decode)
# ---------------------------------------------------------------------------


def apply_moe_decode(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropless one-token decode. x [B, 1, d] -> y [B, 1, d].

    Each token is routed on its own (``row_stable``) and its top-k expert
    SwiGLUs go through the ``moe_decode`` op; everything stays on the
    device (no host sync). ``valid`` [B] bool zeroes the gates of
    dead/retired slots (the kernel then reads no expert for them); a live
    slot's output never depends on them. Unlike the JAX function it
    returns no aux loss: that is a training quantity, decode never trains,
    and PyTorch would compute it eagerly on every step."""
    m = cfg.moe
    if x.shape[1] != 1:
        raise ValueError("apply_moe_decode is the one-token decode path")
    _, gate_vals, expert_idx = _route(params["router"], x, m, policy,
                                      row_stable=True)
    gate_vals, expert_idx = gate_vals[:, 0], expert_idx[:, 0]
    if valid is not None:
        gate_vals = gate_vals * valid.float()[:, None]
    y = xaif.call("moe_decode", policy, x[:, 0].contiguous(),
                  expert_idx.to(torch.int32), gate_vals.contiguous(),
                  params["w_gate_e"], params["w_up_e"], params["w_down_e"])
    y = y[:, None, :]                                           # [B, 1, d]
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, policy).float()
    return y.to(x.dtype)
