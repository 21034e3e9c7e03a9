"""GQA attention mixer (port of ``repro.models.attention``, GQA part).

Two execution modes share one parameter set:
  * prefill: full-sequence causal attention through the XAIF
    ``attention`` op (the flash kernel on the card), K/V written into the
    request's cache;
  * decode: one query token against the KV cache through the
    ``attn_decode`` op; KV stays in its grouped [B, Hkv, S, D] layout (no
    head replication — the bandwidth point of GQA) and each sequence is
    masked by its own cache length.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif
from repro_torch.models.layers import apply_rope, rope_dims


class KVCache(NamedTuple):
    k: torch.Tensor            # [(L,) B, Hkv, S, D]
    v: torch.Tensor            # [(L,) B, Hkv, S, D]


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                  layers: int) -> KVCache:
    """Zeroed K and V of ``layers`` layers: [layers, B, Hkv, S, D] each."""
    shape = (layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def fill_slot(cache: KVCache, src: KVCache, slot: int) -> KVCache:
    """Write a batch-1 prefilled cache into batch row ``slot``, in place
    (any leading layer dims: the batch axis is the 4th from the end).

    ``src`` may be shorter along the sequence (a bucketed prefill): its K/V
    land at positions [0, src_len) of the row; stale tail positions are
    masked by the per-slot length until decode overwrites them."""
    n = src.k.shape[-2]
    cache.k[..., slot, :, :n, :] = src.k[..., 0, :, :, :]
    cache.v[..., slot, :, :n, :] = src.v[..., 0, :, :, :]
    return cache


def reset_slot(cache: KVCache, slot: int) -> KVCache:
    """Zero batch row ``slot`` in place (slot retirement)."""
    cache.k[..., slot, :, :, :].zero_()
    cache.v[..., slot, :, :, :].zero_()
    return cache


def _project_qkv(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                 positions: torch.Tensor):
    b, t, _ = x.shape
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = xaif.call("gemm", policy, x, params["wq"], bias=params.get("bq"))
    k = xaif.call("gemm", policy, x, params["wk"], bias=params.get("bk"))
    v = xaif.call("gemm", policy, x, params["wv"], bias=params.get("bv"))
    q = q.reshape(b, t, hq, dh).transpose(1, 2)           # [B, Hq, T, D]
    k = k.reshape(b, t, hkv, dh).transpose(1, 2)
    v = v.reshape(b, t, hkv, dh).transpose(1, 2)
    rd = rope_dims(cfg)
    if rd != 0:
        q = apply_rope(q, positions, cfg.rope_theta, rd)
        k = apply_rope(k, positions, cfg.rope_theta, rd)
    return q.contiguous(), k.contiguous(), v.contiguous()


def apply_attention_prefill(params, x: torch.Tensor, cfg: ArchConfig,
                            policy: str, cache: KVCache
                            ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill x [B, T, d]: causal attention, and the produced K/V written
    into positions [0, T) of ``cache`` (in place)."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, policy, positions)
    out = xaif.call("attention", policy, q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.head_dim)
    cache.k[:, :, :t] = k
    cache.v[:, :, :t] = v
    return xaif.call("gemm", policy, out, params["wo"]), cache


def apply_attention_decode(params, x: torch.Tensor, cfg: ArchConfig,
                           policy: str, cache: KVCache,
                           cache_pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x [B, 1, d]; cache_pos [B] int32 = each sequence's
    current length (the new token's position)."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, policy, cache_pos[:, None])
    # The new K/V row is written IN PLACE at each sequence's cache_pos (the
    # JAX package builds a new cache with .at[].set); nothing else holds the
    # old cache, so the update saves a copy of the whole cache per layer.
    bidx = torch.arange(b, device=x.device)
    pos = cache_pos.long()
    cache.k[bidx, :, pos] = k[:, :, 0]
    cache.v[bidx, :, pos] = v[:, :, 0]
    out = xaif.call("attn_decode", policy, q[:, :, 0].contiguous(), cache.k,
                    cache.v, cache_pos)                   # fp32 [B, Hq, D]
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return xaif.call("gemm", policy, out, params["wo"]), cache
