"""CausalLM assembly, dense path (port of ``repro.models.lm``):
embed -> layers (an early-exit head at each exit boundary) -> final norm
-> unembed.

Parameters keep the JAX package's tree: per-layer weights stacked along a
leading layer axis in ``params["slots"][0]`` (the dense block pattern has
period 1, so the super-blocks are the layers) in the ``[K, N]`` layout, so
loading JAX parameters is copy-only. The KV cache is one ``[L, B, Hkv, S,
D]`` tensor each for K and V (``LMCache``) or one ``[L, P, Hkv, ps, D]``
page pool each with a ``[B, max_pages]`` page table (``PagedLMCache``);
layer i reads and writes the view ``[i]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif
from repro_torch.core.device import resolve_device
from repro_torch.core.early_exit import apply_exit_head, init_exit_head
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_rmsnorm, rmsnorm)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.period != 1 or cfg.first_k_dense:
        raise ValueError(f"{cfg.name}: the port runs a period-1 dense "
                         f"pattern without prefix layers")


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def init_lm(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Torch-native: the same seed gives other numbers than the JAX package's
    ``init_lm``; tests that compare the two load JAX's parameters through
    ``convert.params_from_jax`` instead."""
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d = cfg.num_layers, cfg.d_model
    hq, hkv, dh, ff = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    shapes = {"wq": (d, hq * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
              "wo": (hq * dh, d)}
    mixer = {k: torch.empty(n, *s, dtype=dtype, device=device)
             for k, s in shapes.items()}
    ffn = {"w_gate": torch.empty(n, d, ff, dtype=dtype, device=device),
           "w_up": torch.empty(n, d, ff, dtype=dtype, device=device),
           "w_down": torch.empty(n, ff, d, dtype=dtype, device=device)}
    for i in range(n):      # one layer at a time keeps the fp32 draws small
        for tree in (mixer, ffn):
            for w in tree.values():
                w[i] = dense_init(gen, w.shape[1], w.shape[2], dtype, device)
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            mixer[name] = torch.zeros(n, width, dtype=dtype, device=device)
    ones = torch.ones(n, d, dtype=torch.float32, device=device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype, device),
        "final_norm": init_rmsnorm(d, device),
        "unembed": dense_init(gen, d, cfg.vocab_size, dtype, device),
        "slots": ({"ln1": {"scale": ones.clone()}, "mixer": mixer,
                   "ln2": {"scale": ones}, "ffn": ffn},),
    }
    if cfg.early_exit is not None:
        if not cfg.early_exit.share_unembed:
            raise ValueError("the port's exit heads share the unembedding")
        params["exits"] = tuple(init_exit_head(d, dtype, device)
                                for _ in cfg.early_exit.exit_layers)
    return params


def _layer(params, i: int):
    """Layer i's parameters: views into the stacked slot weights."""
    def pick(tree):
        return ({k: pick(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    return pick(params["slots"][0])


# ---------------------------------------------------------------------------
# Segment planning: exit layers split the layer stack
# ---------------------------------------------------------------------------


def _segments(cfg: ArchConfig) -> List[Tuple[int, int, Optional[int]]]:
    """[(layer_start, layer_end, exit_index_or_None), ...]."""
    n = cfg.num_superblocks
    exits = []
    if cfg.early_exit is not None:
        for i, el in enumerate(cfg.early_exit.exit_layers):
            sb = (el - cfg.first_k_dense) // cfg.period
            if not 0 < sb <= n:
                raise ValueError(f"{cfg.name}: exit layer {el} out of range")
            exits.append((sb, i))
    segs: List[Tuple[int, int, Optional[int]]] = []
    prev = 0
    for sb, i in sorted(exits):
        segs.append((prev, sb, i))
        prev = sb
    if prev < n or not segs:
        segs.append((prev, n, None))
    return segs


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class LMCache(NamedTuple):
    k: torch.Tensor          # [L, B, Hkv, S, D]
    v: torch.Tensor          # [L, B, Hkv, S, D]
    pos: torch.Tensor        # [B] int32 current lengths

    def layer(self, i: int) -> attn.KVCache:
        return attn.KVCache(self.k[i], self.v[i])


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> LMCache:
    _check_dense(cfg)
    device = resolve_device(device)
    kv = attn.init_kv_cache(cfg, batch, max_len, getattr(torch, cfg.dtype),
                            device, layers=cfg.num_layers)
    return LMCache(kv.k, kv.v,
                   torch.zeros(batch, dtype=torch.int32, device=device))


def fill_slot(cache: LMCache, src: LMCache, slot: int, length) -> LMCache:
    """Insert a batch-1 prefilled ``src`` cache into row ``slot`` in place;
    ``length`` (the TRUE prompt length) becomes the slot's position."""
    attn.fill_slot(attn.KVCache(cache.k, cache.v),
                   attn.KVCache(src.k, src.v), slot)
    cache.pos[slot] = length
    return cache


def reset_slot(cache: LMCache, slot: int) -> LMCache:
    """Retire row ``slot``: zero its K/V and length, in place."""
    attn.reset_slot(attn.KVCache(cache.k, cache.v), slot)
    cache.pos[slot] = 0
    return cache


# ----- paged cache ----------------------------------------------------------
#
# Attention KV lives in fixed-size PAGES: one pool per layer (stacked
# [L, P, Hkv, ps, D]) and ONE [capacity, max_pages] page table shared by all
# layers maps slot-local page j to the pool page holding positions
# [j*ps, (j+1)*ps). Page 0 is the reserved scratch page. The host owns
# allocation (serve/paging.py).


class PagedLMCache(NamedTuple):
    k_pages: torch.Tensor      # [L, P, Hkv, ps, D]
    v_pages: torch.Tensor      # [L, P, Hkv, ps, D]
    pos: torch.Tensor          # [B] int32 current lengths
    page_table: torch.Tensor   # [B, max_pages] int32; -1 = unallocated

    def layer(self, i: int) -> attn.PagedKVCache:
        return attn.PagedKVCache(self.k_pages[i], self.v_pages[i])


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int,
                     page_size: int, num_pages: int,
                     device="cuda") -> PagedLMCache:
    _check_dense(cfg)
    device = resolve_device(device)
    pools = attn.init_paged_kv_cache(cfg, num_pages, page_size,
                                     getattr(torch, cfg.dtype), device,
                                     layers=cfg.num_layers)
    max_pages = -(-max_len // page_size)
    return PagedLMCache(
        pools.k_pages, pools.v_pages,
        torch.zeros(batch, dtype=torch.int32, device=device),
        torch.full((batch, max_pages), -1, dtype=torch.int32, device=device))


def fill_slot_paged(cache: PagedLMCache, src: LMCache, slot: int, length,
                    page_ids: torch.Tensor) -> PagedLMCache:
    """Admit a batch-1 contiguous prefill into row ``slot`` in place: its
    KV is scattered into the host-allocated ``page_ids`` (one per bucket
    page, in position order) and the slot's page-table row is rewritten to
    exactly these pages."""
    attn.fill_pages(attn.PagedKVCache(cache.k_pages, cache.v_pages),
                    attn.KVCache(src.k, src.v), page_ids)
    n = page_ids.shape[0]
    cache.page_table[slot] = -1
    cache.page_table[slot, :n] = page_ids.to(torch.int32)
    cache.pos[slot] = length
    return cache


def free_slot_paged(cache: PagedLMCache, slot: int) -> PagedLMCache:
    """Retire row ``slot``: zero its length and page-table row, in place.
    Pool pages keep their bytes; junk is masked at read time."""
    cache.pos[slot] = 0
    cache.page_table[slot] = -1
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _apply_layer(p, x: torch.Tensor, cfg: ArchConfig, policy: str,
                 state, mode: str, cache_pos=None, page_table=None):
    h = rmsnorm(p["ln1"], x, policy, cfg.norm_eps)
    m = p["mixer"]
    if mode == "prefill":
        out, _ = attn.apply_attention_prefill(m, h, cfg, policy, state)
    elif mode == "decode" and page_table is None:
        out, _ = attn.apply_attention_decode(m, h, cfg, policy, state,
                                             cache_pos)
    elif mode == "decode":
        out, _ = attn.apply_attention_decode_paged(m, h, cfg, policy, state,
                                                   cache_pos, page_table)
    elif page_table is None:
        out, _ = attn.apply_attention_verify(m, h, cfg, policy, state,
                                             cache_pos)
    else:
        out, _ = attn.apply_attention_verify_paged(m, h, cfg, policy, state,
                                                   cache_pos, page_table)
    x = x + out
    h2 = rmsnorm(p["ln2"], x, policy, cfg.norm_eps)
    return x + apply_mlp(p["ffn"], h2, policy)


def _head(params, x: torch.Tensor, cfg: ArchConfig, policy: str):
    h = rmsnorm(params["final_norm"], x, policy, cfg.norm_eps)
    return xaif.call("gemm", policy, h, params["unembed"])


def _exit_logits(params, x: torch.Tensor, i: int, cfg: ArchConfig,
                 policy: str):
    return apply_exit_head(params["exits"][i], x, params["unembed"], policy,
                           cfg.norm_eps)


def forward_prefill(params, tokens: torch.Tensor, cfg: ArchConfig,
                    policy: str, cache: LMCache,
                    lengths: Optional[torch.Tensor] = None):
    """Full-sequence prefill of tokens [B, T] filling ``cache`` (in place);
    returns (last_logits [B, V], cache).

    ``lengths`` [B]: TRUE lengths of right-padded inputs — logits are taken
    at each sequence's last real token and the cache records the true
    length, so one bucket serves every prompt length up to it."""
    x = params["embed"][tokens.long()]
    b, t = tokens.shape
    for i in range(cfg.num_layers):
        x = _apply_layer(_layer(params, i), x, cfg, policy, cache.layer(i),
                         "prefill")
    if lengths is None:
        last = x[:, -1:].contiguous()
        pos = torch.full_like(cache.pos, t)
    else:
        idx = (lengths.long() - 1).view(b, 1, 1).expand(b, 1, x.shape[-1])
        last = torch.gather(x, 1, idx)
        pos = lengths.to(torch.int32)
    logits = _head(params, last, cfg, policy)
    return logits[:, 0], cache._replace(pos=pos)


def forward_decode(params, tokens: torch.Tensor, cfg: ArchConfig,
                   policy: str, cache: Union[LMCache, PagedLMCache],
                   with_exits: bool = True):
    """One decode step. tokens [B, 1]. ``cache`` is an LMCache (contiguous
    KV) or a PagedLMCache (page pools attended through the page table: the
    same numerics). K/V rows are written in place. Returns (final_logits
    [B, V], exit_logits tuple, cache with pos + 1); each exit's logits come
    from the hidden state at its boundary."""
    page_table = (cache.page_table if isinstance(cache, PagedLMCache)
                  else None)
    x = params["embed"][tokens.long()]
    exit_lg: List[torch.Tensor] = []
    for start, end, exit_i in _segments(cfg):
        for i in range(start, end):
            x = _apply_layer(_layer(params, i), x, cfg, policy,
                             cache.layer(i), "decode", cache.pos, page_table)
        if exit_i is not None and with_exits:
            exit_lg.append(_exit_logits(params, x, exit_i, cfg, policy)[:, 0])
    logits = _head(params, x, cfg, policy)[:, 0]
    return logits, tuple(exit_lg), cache._replace(pos=cache.pos + 1)


def forward_verify(params, tokens: torch.Tensor, cfg: ArchConfig,
                   policy: str, cache: Union[LMCache, PagedLMCache]):
    """Speculative-decode verification: score K1 = k+1 tokens per slot (the
    previous token plus k draft proposals) in ONE forward. tokens [B, K1].

    Every layer writes the K1 K/V rows at ``pos + i`` and masks each query
    to its own staircase window, so logits row i is bitwise what the i-th
    sequential ``forward_decode`` step would produce. Returns (logits
    [B, K1, V], cache) with ``pos`` UNCHANGED: the caller advances it by
    the accepted count. Early exits are not consulted."""
    page_table = (cache.page_table if isinstance(cache, PagedLMCache)
                  else None)
    x = params["embed"][tokens.long()]
    for i in range(cfg.num_layers):
        x = _apply_layer(_layer(params, i), x, cfg, policy, cache.layer(i),
                         "verify", cache.pos, page_table)
    return _head(params, x, cfg, policy), cache
