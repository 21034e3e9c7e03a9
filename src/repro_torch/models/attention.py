"""Attention mixers (port of ``repro.models.attention``): GQA, and
DeepSeek-V2 Multi-head Latent Attention (MLA).

GQA (with optional QKV biases and a QK-norm: q and k normalised over the
head dim before rotary) has six execution modes over one parameter set:
  * train: full-sequence causal attention with no cache
    (``apply_attention``);
  * prefill: full-sequence causal attention through the XAIF
    ``attention`` op (the flash kernel on the card), K/V written into the
    request's cache;
  * decode: one query token against the KV cache through the
    ``attn_decode`` op (contiguous cache) or ``attn_decode_paged`` (page
    pool + page table); KV stays in its grouped Hkv layout (no head
    replication — the bandwidth point of GQA) and each sequence is masked
    by its own cache length;
  * verify (speculative decoding): K1 query tokens per sequence through
    ``verify_decode`` / ``verify_decode_paged``, query i masked to the
    window of the i-th sequential decode step;
  * shared prefill (prefix sharing, chunked prefill): a prompt's suffix
    against prefix pages already resident in the pool
    (``apply_attention_prefill_shared``), its K/V written into the slot's
    own pages; the attention is plain fp32 PyTorch, as JAX computes it.

MLA caches only the compressed latent and the shared rotary key
(``MLACache``, or in pages ``PagedMLACache``). Prefill decompresses K/V
per head and runs the flash ``attention`` op at (q/k, v) head dims (192,
128); decode uses the absorbed formulation: the query is projected into
latent space (``gemm_heads``), the precise mode of ``attn_decode`` (or of
``attn_decode_paged``) attends the latent directly, and the pooled latent
is decompressed per head (``gemm_heads`` again).

K/V rows are written in place (the JAX package builds new caches with
``.at[].set``); nothing else holds the old cache, so the update saves a
copy of the whole cache per layer.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import xaif
from repro_torch.models.layers import (apply_rope, init_rmsnorm, normal_init,
                                       rmsnorm, rope_dims)


class KVCache(NamedTuple):
    k: torch.Tensor            # [(L,) B, Hkv, S, D]
    v: torch.Tensor            # [(L,) B, Hkv, S, D]


class MLACache(NamedTuple):
    c_kv: torch.Tensor         # [(L,) B, S, kv_lora_rank]
    k_rope: torch.Tensor       # [(L,) B, S, rope_dim]


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype,
                   device) -> Dict:
    """GQA projections [K, N] (biases zero when ``qkv_bias``; unit
    ``q_norm`` / ``k_norm`` scales over the head dim when ``qk_norm``)."""
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {"wq": normal_init(gen, (d, hq * dh), d, dtype, device),
         "wk": normal_init(gen, (d, hkv * dh), d, dtype, device),
         "wv": normal_init(gen, (d, hkv * dh), d, dtype, device),
         "wo": normal_init(gen, (hq * dh, d), hq * dh, dtype, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros(width, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, device)
        p["k_norm"] = init_rmsnorm(dh, device)
    return p


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                  layers: int) -> KVCache:
    """Zeroed K and V of ``layers`` layers: [layers, B, Hkv, S, D] each."""
    shape = (layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def fill_slot(cache, src, slot: int):
    """Write a batch-1 prefilled cache into batch row ``slot``, in place:
    ``cache`` and ``src`` are tuples of layer-stacked tensors [L, B, ...,
    S, D] (K and V, or the MLA latent and rotary key).

    ``src`` may be shorter along the sequence (a bucketed prefill): its
    rows land at positions [0, src_len) of the slot; stale tail positions
    are masked by the per-slot length until decode overwrites them."""
    for dst, s in zip(cache, src):
        dst[:, slot, ..., :s.shape[-2], :] = s[:, 0]
    return cache


def reset_slot(cache, slot: int):
    """Zero batch row ``slot`` of layer-stacked tensors in place (slot
    retirement)."""
    for dst in cache:
        dst[:, slot].zero_()
    return cache


def _project_kv(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                positions: torch.Tensor):
    """K and V [B, Hkv, T, D] of x [B, T, d]: biases, the K-norm and
    rotary as the layer applies them."""
    b, t, _ = x.shape
    hkv, dh = cfg.num_kv_heads, cfg.head_dim
    k = xaif.call("gemm", policy, x, params["wk"], bias=params.get("bk"))
    v = xaif.call("gemm", policy, x, params["wv"], bias=params.get("bv"))
    k = k.reshape(b, t, hkv, dh)
    if cfg.qk_norm:
        # over the head dim, before rotary (as JAX); normalised as [B, T,
        # H, D], where a head's D values are a contiguous row, as the
        # rmsnorm kernel takes them
        k = rmsnorm(params["k_norm"], k, policy, cfg.norm_eps)
    k = k.transpose(1, 2)                                 # [B, Hkv, T, D]
    v = v.reshape(b, t, hkv, dh).transpose(1, 2)
    rd = rope_dims(cfg)
    if rd != 0:
        k = apply_rope(k, positions, cfg.rope_theta, rd)
    return k.contiguous(), v.contiguous()


def _project_qkv(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                 positions: torch.Tensor):
    b, t, _ = x.shape
    q = xaif.call("gemm", policy, x, params["wq"], bias=params.get("bq"))
    k, v = _project_kv(params, x, cfg, policy, positions)
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, policy, cfg.norm_eps)
    q = q.transpose(1, 2)                                 # [B, Hq, T, D]
    rd = rope_dims(cfg)
    if rd != 0:
        q = apply_rope(q, positions, cfg.rope_theta, rd)
    return q.contiguous(), k, v


def _causal(params, x: torch.Tensor, cfg: ArchConfig, policy: str):
    """Causal self-attention of x [B, T, d] at positions [0, T): (output
    [B, T, d], K, V [B, Hkv, T, D])."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, policy, positions)
    out = xaif.call("attention", policy, q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.head_dim)
    return xaif.call("gemm", policy, out, params["wo"]), k, v


def apply_attention(params, x: torch.Tensor, cfg: ArchConfig,
                    policy: str) -> torch.Tensor:
    """Full-sequence causal path without a cache (training). x [B, T, d]."""
    return _causal(params, x, cfg, policy)[0]


def apply_attention_prefill(params, x: torch.Tensor, cfg: ArchConfig,
                            policy: str, cache: KVCache
                            ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill x [B, T, d]: causal attention, and the produced K/V written
    into positions [0, T) of ``cache`` (in place)."""
    t = x.shape[1]
    out, k, v = _causal(params, x, cfg, policy)
    cache.k[:, :, :t] = k
    cache.v[:, :, :t] = v
    return out, cache


def apply_attention_decode(params, x: torch.Tensor, cfg: ArchConfig,
                           policy: str, cache: KVCache,
                           cache_pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x [B, 1, d]; cache_pos [B] int32 = each sequence's
    current length (the new token's position)."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, policy, cache_pos[:, None])
    bidx = torch.arange(b, device=x.device)
    pos = cache_pos.long()
    cache.k[bidx, :, pos] = k[:, :, 0]
    cache.v[bidx, :, pos] = v[:, :, 0]
    out = xaif.call("attn_decode", policy, q[:, :, 0].contiguous(), cache.k,
                    cache.v, cache_pos)                   # fp32 [B, Hq, D]
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return xaif.call("gemm", policy, out, params["wo"]), cache


# ---------------------------------------------------------------------------
# Paged KV: page pools + one page table shared by every layer
# ---------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    """Page pools. Page 0 is the reserved SCRATCH page (dead-slot writes
    land there; never allocated, never validly read). Logical page ids are
    shared across layers through the ``PagedLMCache`` page table."""
    k_pages: torch.Tensor      # [(L,) P, Hkv, ps, D]
    v_pages: torch.Tensor      # [(L,) P, Hkv, ps, D]


def init_paged_kv_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                        dtype, device, layers: int) -> PagedKVCache:
    """Zeroed pools of ``layers`` layers: [layers, P, Hkv, ps, D] each."""
    shape = (layers, num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _to_pages(x: torch.Tensor, seq_axis: int, page_size: int,
              n_pages: int) -> torch.Tensor:
    """Chop a contiguous cache array into page-shaped chunks: ``seq_axis``
    moves to the front, is zero-padded to ``n_pages * page_size`` and split
    into [n_pages, page_size, *rest]."""
    x = x.movedim(seq_axis, 0)
    pad = n_pages * page_size - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros(pad, *x.shape[1:])])
    return x.reshape(n_pages, page_size, *x.shape[1:])


def fill_pages(paged, src, page_ids: torch.Tensor):
    """Scatter a batch-1 prefilled contiguous cache into the pool pages
    ``page_ids`` [ceil(T / ps)] of every layer, in place: GQA K and V (src
    a pair [L, 1, Hkv, T, D] into a ``PagedKVCache``) or MLA latents and
    rotary keys (src a pair [L, 1, T, d] into a ``PagedMLACache``). Junk
    beyond the true length is masked at read time by the per-slot
    position, so a bucketed prefill's padded tail needs no special
    handling."""
    n_pages = page_ids.shape[0]
    ids = page_ids.long()
    ps = paged[0].shape[-2]
    mla = isinstance(paged, PagedMLACache)
    for dst, a in zip(paged, src):
        if mla:       # [L, 1, T, d] -> [L, n_pages, ps, d]
            pages = _to_pages(a[:, 0], 1, ps, n_pages).permute(2, 0, 1, 3)
        else:         # [L, 1, Hkv, T, D] -> [L, n_pages, Hkv, ps, D]
            pages = _to_pages(a[:, 0], 2, ps, n_pages).permute(
                2, 0, 3, 1, 4)
        dst[:, ids] = pages.to(dst.dtype)
    return paged


def _current_page(page_table: torch.Tensor, cache_pos: torch.Tensor,
                  ps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page id, in-page offset) of each sequence's current write position.

    THE dead-slot routing invariant lives here: entries of -1 (dead/empty
    slots) are routed to the scratch page 0, whose contents are never
    validly read. Both pool layouts (GQA and MLA) share it. The page index
    is clamped to the table, as the JAX gather clamps it."""
    b, np_ = page_table.shape
    pos = cache_pos.long()
    pid = page_table[torch.arange(b, device=pos.device),
                     (pos // ps).clamp(max=np_ - 1)]
    return torch.where(pid >= 0, pid, 0).long(), pos % ps


def apply_attention_decode_paged(params, x: torch.Tensor, cfg: ArchConfig,
                                 policy: str, state: PagedKVCache,
                                 cache_pos: torch.Tensor,
                                 page_table: torch.Tensor
                                 ) -> Tuple[torch.Tensor, PagedKVCache]:
    """One-token decode against one layer's pools [P, Hkv, ps, D]. x [B, 1,
    d]; cache_pos [B] = the new token's position; page_table [B, NP] (-1 =
    unallocated). The new K/V row is appended into each sequence's current
    page, then ``attn_decode_paged`` attends through the page table:
    bitwise ``apply_attention_decode`` when NP * ps equals the contiguous
    extent."""
    b = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, policy, cache_pos[:, None])
    safe, off = _current_page(page_table, cache_pos, state.k_pages.shape[-2])
    state.k_pages[safe, :, off] = k[:, :, 0]
    state.v_pages[safe, :, off] = v[:, :, 0]
    out = xaif.call("attn_decode_paged", policy, q[:, :, 0].contiguous(),
                    state.k_pages, state.v_pages, page_table, cache_pos)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return xaif.call("gemm", policy, out, params["wo"]), state


class SharedPrefillCtx(NamedTuple):
    """Where a FORK-POINT prefill over a shared-prefix paged cache reads
    and writes. ``prefix_ids`` [n] are the matched READ-ONLY full pages
    (entries past the match may be -1: gathered from the scratch page and
    masked), ``region_ids`` [n_region] the slot's exclusive COW + suffix
    pages (pad entries may be the scratch page 0), ``start`` the absolute
    position of the first suffix token, ``n_prefix`` the tokens resident in
    the shared full pages (``start - n_prefix`` is the in-page offset of the
    COW fork) and ``true_len`` the whole prompt's length. The JAX package
    pads both id lists to bound its jit traces; nothing here needs the pad,
    and the result does not depend on it."""
    prefix_ids: torch.Tensor   # [n] int, -1 past the match
    region_ids: torch.Tensor   # [n_region] int
    start: int
    n_prefix: int
    true_len: int


def apply_attention_prefill_shared(params, x: torch.Tensor, cfg: ArchConfig,
                                   policy: str, state: PagedKVCache,
                                   ctx: SharedPrefillCtx
                                   ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Suffix-only prefill against a shared paged prefix: x [1, Tsuf, d]
    (right-padded suffix), ``state`` one layer's pools [P, Hkv, ps, D].

    The suffix K/V (``_project_qkv`` at the absolute positions, so biases,
    the QK-norm and partial rotary come along) is written in place into
    the region pages from the fork offset on (the COW page's first
    ``start - n_prefix`` rows, copied from the donor, are kept), then the
    suffix queries attend [shared prefix pages ++ region] under an explicit
    absolute-position mask. Shared pages are only read. The numerics are
    the JAX package's (no Pallas kernel there either): fp32, scale
    d^-0.5, -1e30 on masked lanes, which the softmax turns into exact
    zeros. V rows past the prompt (pad and scratch entries) are zeroed
    before the product, as the port's plain paged attention zeroes the
    rows it masks: 0 * NaN would carry a NaN from stale or scratch memory
    into the output."""
    tsuf = x.shape[1]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = state.k_pages.shape[-2]
    dev = x.device
    qpos = ctx.start + torch.arange(tsuf, device=dev)    # absolute positions
    q, k, v = _project_qkv(params, x, cfg, policy, qpos[None])
    region = ctx.region_ids.to(device=dev, dtype=torch.long)
    at = ctx.start - ctx.n_prefix + torch.arange(tsuf, device=dev)
    page, off = region[at // ps], at % ps
    state.k_pages[page, :, off] = k[0].transpose(0, 1).to(state.k_pages.dtype)
    state.v_pages[page, :, off] = v[0].transpose(0, 1).to(state.v_pages.dtype)

    pre = ctx.prefix_ids.to(device=dev, dtype=torch.long)
    pids = torch.cat([torch.where(pre >= 0, pre, 0), region])

    def flat(pages):      # [N, Hkv, ps, D] -> [Hkv, N * ps, D]
        return pages.transpose(0, 1).reshape(hkv, -1, dh)

    keys, vals = flat(state.k_pages[pids]), flat(state.v_pages[pids])
    n_pre, n_reg = pre.shape[0] * ps, region.shape[0] * ps
    kpos = torch.cat([torch.arange(n_pre, device=dev),
                      ctx.n_prefix + torch.arange(n_reg, device=dev)])
    valid = torch.cat([torch.arange(n_pre, device=dev) < ctx.n_prefix,
                       kpos[n_pre:] < ctx.true_len])
    mask = valid[None, :] & (kpos[None, :] <= qpos[:, None])    # [Tsuf, S]
    g = hq // hkv
    qf = q[0].float() * (dh ** -0.5)                     # [Hq, Tsuf, D]
    kf = keys.float().repeat_interleave(g, dim=0)
    vf = torch.where(valid[:, None], vals.float(), 0.0).repeat_interleave(
        g, dim=0)
    logits = torch.einsum("htd,hsd->hts", qf, kf)
    logits = torch.where(mask[None], logits, -1e30)
    out = torch.einsum("hts,hsd->htd", torch.softmax(logits, dim=-1), vf)
    out = out.to(x.dtype).transpose(0, 1).reshape(1, tsuf, hq * dh)
    return xaif.call("gemm", policy, out, params["wo"]), state


def copy_page(state: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write: pool page ``src`` -> ``dst`` in every layer of
    layer-stacked pools [L, P, Hkv, ps, D], in place."""
    for pool in state:
        pool[:, dst] = pool[:, src]
    return state


def _verify_out(params, out: torch.Tensor, x: torch.Tensor,
                cfg: ArchConfig, policy: str) -> torch.Tensor:
    b, k1, _ = x.shape      # out fp32 [B, Hq, K1, D]
    out = out.transpose(1, 2).reshape(b, k1, cfg.num_heads * cfg.head_dim)
    return xaif.call("gemm", policy, out.to(x.dtype), params["wo"])


def apply_attention_verify(params, x: torch.Tensor, cfg: ArchConfig,
                           policy: str, cache: KVCache,
                           cache_pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, KVCache]:
    """Multi-token speculative verify. x [B, K1, d] holds the previous token
    plus k draft proposals; cache_pos [B] is the FIRST row's position. The
    K1 K/V rows land at ``cache_pos + i``, then ``verify_decode`` scores
    every query under its own staircase window: row i bitwise the i-th
    sequential ``apply_attention_decode`` step. Rows past the cache extent
    are dropped (the JAX scatter drops them silently); only queries the
    engine clamps away (beyond the budget) could read them. The drop needs
    no host sync: such a row rewrites position 0 with the value it holds,
    and no kept row writes position 0 while one is dropped (that would
    take K1 > S)."""
    b, k1, _ = x.shape
    pos = cache_pos[:, None].long() + torch.arange(k1, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, policy, pos)
    keep = pos < cache.k.shape[-2]
    at = torch.where(keep, pos, 0)
    bidx = torch.arange(b, device=x.device)[:, None]
    for c, new in ((cache.k, k), (cache.v, v)):
        c[bidx, :, at] = torch.where(keep[:, :, None, None],
                                     new.transpose(1, 2), c[:, None, :, 0])
    out = xaif.call("verify_decode", policy, q, cache.k, cache.v, cache_pos)
    return _verify_out(params, out, x, cfg, policy), cache


def apply_attention_verify_paged(params, x: torch.Tensor, cfg: ArchConfig,
                                 policy: str, state: PagedKVCache,
                                 cache_pos: torch.Tensor,
                                 page_table: torch.Tensor
                                 ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Paged sibling of ``apply_attention_verify``. Each of the K1 rows
    lands in its own (page, offset); rows whose position falls on an
    unallocated (-1) entry or past the table extent go to the scratch page
    0 (several dead slots may write there at once: page 0 is never read)."""
    b, k1, _ = x.shape
    ps = state.k_pages.shape[-2]
    np_ = page_table.shape[1]
    pos = cache_pos[:, None].long() + torch.arange(k1, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, policy, pos)
    in_range = pos < np_ * ps
    bidx = torch.arange(b, device=x.device)[:, None]
    pid = page_table[bidx, torch.where(in_range, pos // ps, 0)]
    safe = torch.where(in_range & (pid >= 0), pid, 0).long()
    off = pos % ps
    state.k_pages[safe, :, off] = k.transpose(1, 2)
    state.v_pages[safe, :, off] = v.transpose(1, 2)
    out = xaif.call("verify_decode_paged", policy, q, state.k_pages,
                    state.v_pages, page_table, cache_pos)
    return _verify_out(params, out, x, cfg, policy), state


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype, device) -> Dict:
    """MLA projections (full-rank queries: ``q_lora_rank`` 0)."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    r = m.kv_lora_rank

    def w(d_in, d_out):
        return normal_init(gen, (d_in, d_out), d_in, dtype, device)

    return {"wq": w(d, h * dqk),
            "w_dkv": w(d, r),
            "kv_norm": init_rmsnorm(r, device),
            "w_kr": w(d, m.qk_rope_head_dim),
            "w_uk": w(r, h * m.qk_nope_head_dim),
            "w_uv": w(r, h * m.v_head_dim),
            "wo": w(h * m.v_head_dim, d)}


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device,
                   layers: int) -> MLACache:
    """Zeroed latents [layers, B, S, r] and rotary keys [layers, B, S, rd]."""
    m = cfg.mla
    return MLACache(
        torch.zeros(layers, batch, max_len, m.kv_lora_rank, dtype=dtype,
                    device=device),
        torch.zeros(layers, batch, max_len, m.qk_rope_head_dim, dtype=dtype,
                    device=device))


def _mla_latent(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                positions: torch.Tensor):
    """Compressed latent (normed) [B, T, r] and rotary key [B, T, rd]."""
    c_kv = xaif.call("gemm", policy, x, params["w_dkv"])
    c_kv = rmsnorm(params["kv_norm"], c_kv, policy, cfg.norm_eps)
    k_rope = xaif.call("gemm", policy, x, params["w_kr"])
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)[:, 0]
    return c_kv, k_rope


def _mla_queries(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                 positions: torch.Tensor):
    """(q_nope [B, H, T, dn], q_rope [B, H, T, dr]) with rotary applied."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    q = xaif.call("gemm", policy, x, params["wq"])
    q = q.reshape(b, t, h, dqk).transpose(1, 2)           # [B, H, T, dqk]
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def apply_mla(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
              cache: Optional[MLACache] = None
              ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Prefill x [B, T, d]: decompress K/V per head, causal attention; the
    latent and rotary key are written into positions [0, T) of ``cache``
    (in place). Without a cache (training) nothing is written."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    positions = torch.arange(t, device=x.device)
    c_kv, k_rope = _mla_latent(params, x, cfg, policy, positions)
    q_nope, q_rope = _mla_queries(params, x, cfg, policy, positions)
    k_nope = xaif.call("gemm", policy, c_kv, params["w_uk"]).reshape(
        b, t, h, m.qk_nope_head_dim).transpose(1, 2)
    v = xaif.call("gemm", policy, c_kv, params["w_uv"]).reshape(
        b, t, h, m.v_head_dim).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(
        b, h, t, m.qk_rope_head_dim)], dim=-1)
    out = xaif.call("attention", policy, q.contiguous(), k.contiguous(),
                    v.to(q.dtype).contiguous(), causal=True,
                    scale=_mla_scale(cfg))
    out = out.transpose(1, 2).reshape(b, t, h * m.v_head_dim)
    if cache is not None:
        cache.c_kv[:, :t] = c_kv
        cache.k_rope[:, :t] = k_rope
    return xaif.call("gemm", policy, out, params["wo"]), cache


class PagedMLACache(NamedTuple):
    """Latent page pools (page 0 the scratch page, as ``PagedKVCache``)."""
    c_kv_pages: torch.Tensor     # [(L,) P, ps, kv_lora_rank]
    k_rope_pages: torch.Tensor   # [(L,) P, ps, rope_dim]


def init_paged_mla_cache(cfg: ArchConfig, num_pages: int, page_size: int,
                         dtype, device, layers: int) -> PagedMLACache:
    """Zeroed latent pools [layers, P, ps, r] and rotary pools [layers, P,
    ps, rd]."""
    m = cfg.mla
    return PagedMLACache(
        torch.zeros(layers, num_pages, page_size, m.kv_lora_rank,
                    dtype=dtype, device=device),
        torch.zeros(layers, num_pages, page_size, m.qk_rope_head_dim,
                    dtype=dtype, device=device))


def _mla_decode_in(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                   cache_pos: torch.Tensor):
    """The absorbed decode's inputs: the new latent row [B, r] and rotary
    key row [B, rd], the query projected into latent space (``gemm_heads``,
    fp32 [B, H, r]) and the rotary query (fp32 [B, H, rd])."""
    m = cfg.mla
    h = cfg.num_heads
    positions = cache_pos[:, None]
    c_new, kr_new = _mla_latent(params, x, cfg, policy, positions)
    q_nope, q_rope = _mla_queries(params, x, cfg, policy, positions)
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_abs = xaif.call("gemm_heads", policy,
                      q_nope[:, :, 0].float().contiguous(), w_uk,
                      True)                                  # [B, H, r]
    return (c_new[:, 0], kr_new[:, 0], q_abs,
            q_rope[:, :, 0].float().contiguous())


def _mla_decode_out(params, pooled: torch.Tensor, x: torch.Tensor,
                    cfg: ArchConfig, policy: str) -> torch.Tensor:
    """Decompress the pooled latent per head (``gemm_heads``) and project
    out."""
    m = cfg.mla
    b, h = x.shape[0], cfg.num_heads
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = xaif.call("gemm_heads", policy, pooled, w_uv, False)  # [B, H, dv]
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype)
    return xaif.call("gemm", policy, out, params["wo"])


def apply_mla_decode(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                     cache: MLACache, cache_pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed-matrix decode: attend the compressed latent directly.

    score(t, s) = (W_uk^T q_nope_t) . c_s + q_rope_t . k_rope_s, so the
    query is projected into latent space once per step and the cache is
    never decompressed. The latent is one shared "KV head": the precise
    mode of ``attn_decode`` attends it (fp32, post-scale, the rotary key as
    the second score component) and returns the pooled latent, which is
    decompressed per head. x [B, 1, d]; cache_pos [B] int32 = the new
    token's position; the new latent row is written in place."""
    c_new, kr_new, q_abs, q_rope = _mla_decode_in(params, x, cfg, policy,
                                                  cache_pos)
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = cache_pos.long()
    cache.c_kv[bidx, pos] = c_new.to(cache.c_kv.dtype)
    cache.k_rope[bidx, pos] = kr_new.to(cache.k_rope.dtype)
    latent = cache.c_kv[:, None]
    pooled = xaif.call("attn_decode", policy, q_abs, latent, latent,
                       cache_pos, scale=_mla_scale(cfg), q2=q_rope,
                       k2=cache.k_rope[:, None], precise=True)  # [B, H, r]
    return _mla_decode_out(params, pooled, x, cfg, policy), cache


def apply_mla_decode_paged(params, x: torch.Tensor, cfg: ArchConfig,
                           policy: str, state: PagedMLACache,
                           cache_pos: torch.Tensor,
                           page_table: torch.Tensor
                           ) -> Tuple[torch.Tensor, PagedMLACache]:
    """``apply_mla_decode`` against one layer's latent pools [P, ps, r] /
    [P, ps, rd] behind ``page_table`` [B, NP] (-1 = unallocated). The new
    latent and rotary rows are appended into each sequence's current page
    (a dead slot's into the scratch page 0), then the precise mode of
    ``attn_decode_paged`` attends the latent pages: bitwise
    ``apply_mla_decode`` when NP * ps equals the contiguous extent."""
    c_new, kr_new, q_abs, q_rope = _mla_decode_in(params, x, cfg, policy,
                                                  cache_pos)
    safe, off = _current_page(page_table, cache_pos,
                              state.c_kv_pages.shape[-2])
    state.c_kv_pages[safe, off] = c_new.to(state.c_kv_pages.dtype)
    state.k_rope_pages[safe, off] = kr_new.to(state.k_rope_pages.dtype)
    latent = state.c_kv_pages[:, None]                   # [P, 1, ps, r]
    pooled = xaif.call("attn_decode_paged", policy, q_abs, latent, latent,
                       page_table, cache_pos, scale=_mla_scale(cfg),
                       q2=q_rope, k2_pages=state.k_rope_pages[:, None],
                       precise=True)                     # [B, H, r]
    return _mla_decode_out(params, pooled, x, cfg, policy), state


# ---------------------------------------------------------------------------
# CALM state propagation (gated early-exit decode)
# ---------------------------------------------------------------------------


def propagate_kv(params, x: torch.Tensor, cfg: ArchConfig, policy: str,
                 cache, cache_pos: torch.Tensor):
    """Write one token's cache row of a layer the gated decode skips, in
    place, without attending: x [B, 1, d] is the layer's normed input (the
    exit hidden state through its ``ln1``). GQA: only the K and V
    projections (biases, K-norm and rotary as in decode) into ``KVCache``
    rows ``[b, :, cache_pos[b]]``; MLA: the latent and the rotary key into
    ``MLACache`` rows ``[b, cache_pos[b]]``."""
    bidx = torch.arange(x.shape[0], device=x.device)
    pos = cache_pos.long()
    if cfg.mla is not None:
        c_new, kr_new = _mla_latent(params, x, cfg, policy, cache_pos[:, None])
        cache.c_kv[bidx, pos] = c_new[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[bidx, pos] = kr_new[:, 0].to(cache.k_rope.dtype)
        return cache
    k, v = _project_kv(params, x, cfg, policy, cache_pos[:, None])
    cache.k[bidx, :, pos] = k[:, :, 0]
    cache.v[bidx, :, pos] = v[:, :, 0]
    return cache
