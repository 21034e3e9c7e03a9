"""CausalLM assembly (port of ``repro.models.lm``): embed -> prefix
layers -> stacked layers (an early-exit head at each exit boundary) ->
final norm -> unembed. ``forward_train`` / ``forward_train_hidden`` run
the whole sequence with no cache for training (the MoE aux loss summed,
``remat`` on each super-block); the serve passes fill and read caches.

Parameters keep the JAX package's tree: DeepSeek's ``first_k_dense``
dense-MLP layers are a list ``params["prefix"]``; the other layers repeat
the block pattern of period P, and ``params["slots"]`` holds one stack
``[n_superblocks, ...]`` per pattern slot (layer i >= first_k_dense is
row ``(i - kd) // P`` of slot ``(i - kd) % P``), every matrix in the
``[K, N]`` layout, so loading JAX parameters is copy-only. A layer is a
sequence mixer -- attention (GQA, or MLA when the arch has ``mla``), a
Mamba, an mLSTM or an sLSTM mixer -- followed by a SwiGLU MLP, an MoE or
nothing (``ffn == "none"``: an xLSTM layer has no ``ln2`` and no ``ffn``,
as in JAX).

The cache holds each kind of state stacked along a leading axis, layers in
absolute order within their kind (prefix layers first): for the attention
layers one ``[La, B, Hkv, S, D]`` tensor each for K and V, or for MLA one
``[La, B, S, r]`` latent and one ``[La, B, S, rd]`` rotary key; for the
Mamba layers a conv window ``[Lm, B, K-1, Din]`` and an fp32 SSM state
``[Lm, B, Din, N]``; for the mLSTM layers an ``MLSTMState`` of stacks (c
``[Lml, B, H, dh, dh]``, n ``[Lml, B, H, dh]``, m ``[Lml, B, H]`` fp32, conv
``[Lml, B, K-1, d_in]``), for the sLSTM layers an ``SLSTMState`` (c, n, h, m
``[Ls, B, d]`` fp32) (``LMCache``). The paged cache (``PagedLMCache``) holds
the attention layers' state in page pools instead, ``[La, P, Hkv, ps, D]``
for K and V or ``[La, P, ps, r]`` / ``[La, P, ps, rd]`` for MLA, behind one
``[B, max_pages]`` page table, beside the same slot-indexed recurrent
state. An arch with no attention layer has no attention tensors and no
pools at all. ``cache.layer(i)`` is layer i's view, read and written in
place.

``forward_decode_gated`` (attention-only archs with one exit, contiguous
cache) skips the layers past the exit when every live row exits there,
filling their cache rows by CALM propagation from the exit hidden state.

``forward_prefill_shared`` (paged cache; all-attention GQA archs without
an MoE) prefills only the suffix of a prompt whose prefix KV is already
resident in shared pages (prefix sharing), or one chunk of a long prompt
(chunked prefill); ``copy_pages`` is its copy-on-write.
``gather_pages`` / ``scatter_pages`` move whole pool pages out and back
in (the overload scheduler's host swap).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig, BlockSpec
from repro_torch.core import xaif
from repro_torch.core.device import resolve_device
from repro_torch.core.early_exit import (apply_exit_head, init_exit_head,
                                         should_exit)
from repro_torch.kernels.gemm.ref import WeightQ
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_mlp, dense_init, embed_init,
                                       init_mlp, init_rmsnorm, rmsnorm)


SPEC_RECURRENT = ("verify cannot roll a recurrent state back to the "
                  "accepted prefix; the JAX package refuses it too: "
                  "ROADMAP.md queue 1.10, 'speculative decoding for "
                  "recurrent archs'")


def _check_attention_only(cfg: ArchConfig, what: str, why: str) -> None:
    if cfg.recurrent:
        raise ValueError(f"{cfg.name}: {what} is not ported for archs with "
                         f"recurrent (Mamba or xLSTM) layers: {why}")


def check_gated(cfg: ArchConfig) -> None:
    """Raise ValueError unless gated decode is defined for ``cfg``: one
    exit head and attention layers only, as the JAX package asserts."""
    ee = cfg.early_exit
    if ee is None or len(ee.exit_layers) != 1 or cfg.recurrent:
        raise ValueError(f"{cfg.name}: gated decode needs an attention-only "
                         f"arch with exactly one exit head (a Mamba or "
                         f"xLSTM state cannot be propagated from the exit's "
                         f"hidden state)")


def _check_gqa(cfg: ArchConfig, what: str) -> None:
    if cfg.mla is not None:
        raise ValueError(f"{cfg.name}: {what} is not defined for MLA archs "
                         f"(the JAX package refuses it too)")


def shared_prefill_ok(cfg: ArchConfig) -> bool:
    """Whether the fork-point prefill (prefix sharing, chunked prefill) is
    defined for ``cfg``: all-attention GQA without an MoE, as in JAX."""
    return not cfg.recurrent and cfg.mla is None and cfg.moe is None


def check_shared_prefill(cfg: ArchConfig) -> None:
    """Raise ValueError unless ``shared_prefill_ok(cfg)``."""
    if not shared_prefill_ok(cfg):
        raise ValueError(
            f"{cfg.name}: the fork-point prefill (prefix sharing, chunked "
            f"prefill) needs an all-attention GQA arch without an MoE, as "
            f"the JAX package asserts: a recurrent (Mamba or xLSTM) state "
            f"cannot resume from a page chain, MLA latents are not "
            f"share-indexed, and an MoE's capacity-grouped prefill would "
            f"route the suffix apart from the whole prompt")


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------


def _init_layer(gen: Optional[torch.Generator], spec: BlockSpec,
                cfg: ArchConfig, dtype, device) -> Dict:
    d = cfg.d_model
    if spec.mixer == "mamba":
        mixer = mamba_mod.init_mamba(gen, cfg, dtype, device)
    elif spec.mixer == "mlstm":
        mixer = xlstm_mod.init_mlstm(gen, cfg, dtype, device)
    elif spec.mixer == "slstm":
        mixer = xlstm_mod.init_slstm(gen, cfg, dtype, device)
    elif cfg.mla is not None:
        mixer = attn.init_mla(gen, cfg, dtype, device)
    else:
        mixer = attn.init_attention(gen, cfg, dtype, device)
    p = {"ln1": init_rmsnorm(d, device), "mixer": mixer}
    if spec.ffn != "none":
        p["ln2"] = init_rmsnorm(d, device)
        p["ffn"] = (moe_mod.init_moe(gen, cfg, dtype, device)
                    if spec.ffn == "moe"
                    else init_mlp(gen, d, cfg.d_ff, dtype, device))
    return p


def _map(tree, fn):
    """``fn`` on every tensor of a parameter tree (dicts, lists, tuples); a
    ``WeightQ`` is one weight: ``fn`` maps its q and scale alike."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, WeightQ):
        return WeightQ(fn(tree.q), fn(tree.scale))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree in ``_map``'s order (a ``WeightQ``
    gives its q, then its scale)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _stacked_layers(gen: Optional[torch.Generator], spec: BlockSpec,
                    cfg: ArchConfig, n: int, dtype, device) -> Dict:
    """``n`` layers of ``spec`` stacked along a leading axis, drawn one
    layer at a time (only one layer's fp32 draws are alive at once)."""
    layer = _init_layer(gen, spec, cfg, dtype, device)
    stacked = _map(layer, lambda t: torch.empty(n, *t.shape, dtype=t.dtype,
                                                device=t.device))
    for i in range(n):
        if i:
            layer = _init_layer(gen, spec, cfg, dtype, device)
        for dst, src in zip(_leaves(stacked), _leaves(layer)):
            dst[i] = src
    return stacked


def init_lm(cfg: ArchConfig, seed: int = 0, device="cuda") -> Dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``.

    Torch-native: the same seed gives other numbers than the JAX package's
    ``init_lm``; tests that compare the two load JAX's parameters through
    ``convert.params_from_jax`` instead. MoE routers are fp32, as in JAX.
    ``device="meta"`` gives the tree's shapes and dtypes without
    allocating (a full-size config's layout, checked on any machine)."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    d = cfg.d_model
    params: Dict[str, Any] = {}
    if cfg.first_k_dense:
        params["prefix"] = [_init_layer(gen, cfg.layer_spec(i), cfg, dtype,
                                        device)
                            for i in range(cfg.first_k_dense)]
    params["slots"] = tuple(_stacked_layers(gen, spec, cfg,
                                            cfg.num_superblocks, dtype,
                                            device)
                            for spec in cfg.block_pattern)
    params["embed"] = embed_init(gen, cfg.vocab_size, d, dtype, device)
    params["final_norm"] = init_rmsnorm(d, device)
    params["unembed"] = dense_init(gen, d, cfg.vocab_size, dtype, device)
    if cfg.early_exit is not None:
        if not cfg.early_exit.share_unembed:
            raise ValueError("the port's exit heads share the unembedding")
        params["exits"] = tuple(init_exit_head(d, dtype, device)
                                for _ in cfg.early_exit.exit_layers)
    return params


def _layer(params, cfg: ArchConfig, i: int):
    """Absolute layer i's parameters: a prefix layer, or views into row
    ``(i - kd) // P`` of pattern slot ``(i - kd) % P``'s stack (of a
    quantized stack, row sb of q [L, K, N] and of scale [L, 1, N])."""
    if i < cfg.first_k_dense:
        return params["prefix"][i]
    sb, j = divmod(i - cfg.first_k_dense, cfg.period)
    return _map(params["slots"][j], lambda t: t[sb])


# ---------------------------------------------------------------------------
# Segment planning: exit layers split the stacked layers
# ---------------------------------------------------------------------------


def _segments(cfg: ArchConfig) -> List[Tuple[int, int, Optional[int]]]:
    """[(sb_start, sb_end, exit_index_or_None), ...] over the super-blocks
    (prefix layers excluded): super-block s runs layers kd + s * P ..
    kd + (s + 1) * P - 1. An exit must sit on a super-block boundary."""
    n = cfg.num_superblocks
    exits = []
    if cfg.early_exit is not None:
        for i, el in enumerate(cfg.early_exit.exit_layers):
            sb, off = divmod(el - cfg.first_k_dense, cfg.period)
            if not 0 < sb <= n or off:
                raise ValueError(f"{cfg.name}: exit layer {el} is not on a "
                                 f"super-block boundary in range")
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


def _recurrent_view(cache, kind: str, j: int):
    """Row j of the stacks of a recurrent kind (``mamba``, ``mlstm`` or
    ``slstm``): that layer's state, views read and written in place."""
    if kind == "mamba":
        return mamba_mod.MambaState(cache.conv[j], cache.ssm[j])
    stack = cache.mlstm if kind == "mlstm" else cache.slstm
    return type(stack)(*(t[j] for t in stack))


def _recurrent_stacks(cache) -> Tuple[torch.Tensor, ...]:
    """The recurrent stacks present (Mamba conv window and SSM state, the
    mLSTM and sLSTM states), each [L, B, ...] with no sequence axis."""
    return (tuple(t for t in (cache.conv, cache.ssm) if t is not None)
            + tuple(cache.mlstm or ()) + tuple(cache.slstm or ()))


def _init_recurrent(cfg: ArchConfig, mixers: Tuple[str, ...], batch: int,
                    dtype, device) -> Dict[str, Any]:
    """The zeroed slot-indexed recurrent stacks of ``mixers``, as cache
    fields."""
    fields: Dict[str, Any] = {}
    n_mamba, n_ml, n_sl = (mixers.count("mamba"), mixers.count("mlstm"),
                           mixers.count("slstm"))
    if n_mamba:
        st = mamba_mod.init_mamba_state(cfg, batch, dtype, device, n_mamba)
        fields.update(conv=st.conv, ssm=st.ssm)
    if n_ml:
        fields["mlstm"] = xlstm_mod.init_mlstm_state(cfg, batch, dtype,
                                                     device, n_ml)
    if n_sl:
        fields["slstm"] = xlstm_mod.init_slstm_state(cfg, batch, device,
                                                     n_sl)
    return fields


class LMCache(NamedTuple):
    pos: torch.Tensor                  # [B] int32 current lengths
    mixers: Tuple[str, ...]            # layer i's mixer (a MIXERS name)
    k: Optional[torch.Tensor] = None         # [La, B, Hkv, S, D] (GQA)
    v: Optional[torch.Tensor] = None         # [La, B, Hkv, S, D] (GQA)
    c_kv: Optional[torch.Tensor] = None      # [La, B, S, r] (MLA)
    k_rope: Optional[torch.Tensor] = None    # [La, B, S, rd] (MLA)
    conv: Optional[torch.Tensor] = None      # [Lm, B, K-1, Din] (Mamba)
    ssm: Optional[torch.Tensor] = None       # [Lm, B, Din, N] fp32 (Mamba)
    mlstm: Optional[xlstm_mod.MLSTMState] = None   # stacks [Lml, B, ...]
    slstm: Optional[xlstm_mod.SLSTMState] = None   # stacks [Ls, B, d]

    def layer(self, i: int):
        """Layer i's view: row j of its kind's stacks, j = the number of
        earlier layers of the same kind."""
        kind = self.mixers[i]
        j = self.mixers[:i].count(kind)
        if kind != "attn":
            return _recurrent_view(self, kind, j)
        if self.c_kv is not None:
            return attn.MLACache(self.c_kv[j], self.k_rope[j])
        return attn.KVCache(self.k[j], self.v[j])

    @property
    def states(self) -> Tuple[torch.Tensor, ...]:
        """The attention tensors present (K and V, or latent and rotary
        key), each [La, B, ..., S, D]; none without attention layers."""
        return tuple(t for t in (self.k, self.v, self.c_kv, self.k_rope)
                     if t is not None)

    @property
    def recurrent(self) -> Tuple[torch.Tensor, ...]:
        """The recurrent states present (Mamba conv window and SSM state,
        the mLSTM and sLSTM states), each [L, B, ...] with no sequence
        axis."""
        return _recurrent_stacks(self)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> LMCache:
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    mixers = tuple(cfg.layer_spec(i).mixer for i in range(cfg.num_layers))
    n_attn = mixers.count("attn")
    cache = LMCache(torch.zeros(batch, dtype=torch.int32, device=device),
                    mixers, **_init_recurrent(cfg, mixers, batch, dtype,
                                              device))
    if not n_attn:
        return cache
    if cfg.mla is not None:
        mc = attn.init_mla_cache(cfg, batch, max_len, dtype, device,
                                 layers=n_attn)
        return cache._replace(c_kv=mc.c_kv, k_rope=mc.k_rope)
    kv = attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                            layers=n_attn)
    return cache._replace(k=kv.k, v=kv.v)


def fill_slot(cache: LMCache, src: LMCache, slot: int, length) -> LMCache:
    """Insert a batch-1 prefilled ``src`` cache into row ``slot`` in place:
    its attention rows and its whole recurrent state (which must come
    from an exact-length prefill: pad tokens would be folded into it);
    ``length`` (the TRUE prompt length) becomes the slot's position."""
    attn.fill_slot(cache.states, src.states, slot)
    for dst, s in zip(cache.recurrent, src.recurrent):
        dst[:, slot] = s[:, 0]
    cache.pos[slot] = length
    return cache


def reset_slot(cache: LMCache, slot: int) -> LMCache:
    """Retire row ``slot``: zero its cached and recurrent states and its
    length, in place."""
    attn.reset_slot(cache.states + cache.recurrent, slot)
    cache.pos[slot] = 0
    return cache


# ----- paged cache ----------------------------------------------------------
#
# Attention state lives in fixed-size PAGES: one pool per attention layer
# (stacked [La, P, ...]) and ONE [capacity, max_pages] page table shared by
# all layers maps slot-local page j to the pool page holding positions
# [j*ps, (j+1)*ps). Page 0 is the reserved scratch page. Recurrent (Mamba,
# mLSTM, sLSTM) state is O(1) per slot and stays slot-indexed. An arch with
# no attention layer has no pool: the host still accounts its pages, as
# the JAX engine does, and the page table is kept, but nothing is stored
# in pages. The host owns allocation (serve/paging.py).


class PagedLMCache(NamedTuple):
    pos: torch.Tensor                  # [B] int32 current lengths
    page_table: torch.Tensor           # [B, max_pages] int32; -1 = none
    mixers: Tuple[str, ...]            # layer i's mixer (a MIXERS name)
    k_pages: Optional[torch.Tensor] = None       # [La, P, Hkv, ps, D] (GQA)
    v_pages: Optional[torch.Tensor] = None       # [La, P, Hkv, ps, D] (GQA)
    c_kv_pages: Optional[torch.Tensor] = None    # [La, P, ps, r] (MLA)
    k_rope_pages: Optional[torch.Tensor] = None  # [La, P, ps, rd] (MLA)
    conv: Optional[torch.Tensor] = None      # [Lm, B, K-1, Din] (Mamba)
    ssm: Optional[torch.Tensor] = None       # [Lm, B, Din, N] fp32 (Mamba)
    mlstm: Optional[xlstm_mod.MLSTMState] = None   # stacks [Lml, B, ...]
    slstm: Optional[xlstm_mod.SLSTMState] = None   # stacks [Ls, B, d]

    def layer(self, i: int):
        """Layer i's view: row j of its kind's stacks, j = the number of
        earlier layers of the same kind."""
        kind = self.mixers[i]
        j = self.mixers[:i].count(kind)
        if kind != "attn":
            return _recurrent_view(self, kind, j)
        if self.c_kv_pages is not None:
            return attn.PagedMLACache(self.c_kv_pages[j],
                                      self.k_rope_pages[j])
        return attn.PagedKVCache(self.k_pages[j], self.v_pages[j])

    @property
    def pools(self) -> Union[attn.PagedKVCache, attn.PagedMLACache,
                             Tuple[()]]:
        """The attention layers' pools, stacked [La, P, ...]; an empty
        tuple when the arch has no attention layer."""
        if self.c_kv_pages is not None:
            return attn.PagedMLACache(self.c_kv_pages, self.k_rope_pages)
        if self.k_pages is not None:
            return attn.PagedKVCache(self.k_pages, self.v_pages)
        return ()

    @property
    def recurrent(self) -> Tuple[torch.Tensor, ...]:
        """The recurrent states present, each [L, B, ...]."""
        return _recurrent_stacks(self)


def init_paged_cache(cfg: ArchConfig, batch: int, max_len: int,
                     page_size: int, num_pages: int,
                     device="cuda") -> PagedLMCache:
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    mixers = tuple(cfg.layer_spec(i).mixer for i in range(cfg.num_layers))
    n_attn = mixers.count("attn")
    max_pages = -(-max_len // page_size)
    cache = PagedLMCache(
        torch.zeros(batch, dtype=torch.int32, device=device),
        torch.full((batch, max_pages), -1, dtype=torch.int32, device=device),
        mixers, **_init_recurrent(cfg, mixers, batch, dtype, device))
    if not n_attn:
        return cache
    if cfg.mla is not None:
        mc = attn.init_paged_mla_cache(cfg, num_pages, page_size, dtype,
                                       device, layers=n_attn)
        return cache._replace(c_kv_pages=mc.c_kv_pages,
                              k_rope_pages=mc.k_rope_pages)
    pools = attn.init_paged_kv_cache(cfg, num_pages, page_size, dtype,
                                     device, layers=n_attn)
    return cache._replace(k_pages=pools.k_pages, v_pages=pools.v_pages)


def fill_slot_paged(cache: PagedLMCache, src: LMCache, slot: int, length,
                    page_ids: torch.Tensor) -> PagedLMCache:
    """Admit a batch-1 contiguous prefill into row ``slot`` in place: its
    attention state is scattered into the host-allocated ``page_ids`` (one
    per bucket page, in position order), its recurrent state lands in the
    slot row as ``fill_slot`` writes it, and the slot's page-table row is
    rewritten to exactly these pages. An arch with no attention layer
    stores nothing in pages: only the table row is written."""
    if src.states:
        attn.fill_pages(cache.pools, src.states, page_ids)
    for dst, s in zip(cache.recurrent, src.recurrent):
        dst[:, slot] = s[:, 0]
    n = page_ids.shape[0]
    cache.page_table[slot] = -1
    cache.page_table[slot, :n] = page_ids.to(torch.int32)
    cache.pos[slot] = length
    return cache


def free_slot_paged(cache: PagedLMCache, slot: int) -> PagedLMCache:
    """Retire row ``slot``: zero its length, recurrent state and page-table
    row, in place. Pool pages keep their bytes; junk is masked at read
    time."""
    cache.pos[slot] = 0
    cache.page_table[slot] = -1
    attn.reset_slot(cache.recurrent, slot)
    return cache


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


# recurrent mixer: (prefill, decode), each (params, x, cfg, policy, state)
_RECURRENT = {
    "mamba": (mamba_mod.apply_mamba, mamba_mod.apply_mamba_decode),
    "mlstm": (xlstm_mod.apply_mlstm, xlstm_mod.apply_mlstm_decode),
    "slstm": (xlstm_mod.apply_slstm, xlstm_mod.apply_slstm_decode),
}


def _apply_layer(p, x: torch.Tensor, cfg: ArchConfig, spec: BlockSpec,
                 policy: str, state, mode: str, cache_pos=None,
                 page_table=None, live=None) -> torch.Tensor:
    """One layer of a serve pass (``_apply_layer_aux``'s x)."""
    return _apply_layer_aux(p, x, cfg, spec, policy, state, mode, cache_pos,
                            page_table, live)[0]


def _apply_layer_aux(p, x: torch.Tensor, cfg: ArchConfig, spec: BlockSpec,
                     policy: str, state, mode: str, cache_pos=None,
                     page_table=None, live=None):
    """One layer: the sequence mixer of ``spec`` (``mode`` train / prefill
    / decode / verify / prefill_shared) then the MLP, the MoE or nothing
    (``ffn == "none"``). Returns (x, the MoE's load-balance aux loss or
    None): mode ``train`` has no state and returns every layer's aux (0
    without an MoE); the serve modes return None. In mode
    ``prefill_shared`` ``page_table`` carries the
    ``attn.SharedPrefillCtx``. ``live`` [B] bool (decode): slots that still
    matter — dead ones are masked out of MoE routing."""
    train = mode == "train"
    h = rmsnorm(p["ln1"], x, policy, cfg.norm_eps)
    m = p["mixer"]
    if spec.mixer in _RECURRENT:    # slot-indexed state, paged cache or not
        prefill, decode = _RECURRENT[spec.mixer]
        fn = prefill if mode in ("prefill", "train") else decode
        out, _ = fn(m, h, cfg, policy, state)
    elif cfg.mla is not None:   # prefill or decode: verify refuses MLA
        if mode in ("prefill", "train"):
            out, _ = attn.apply_mla(m, h, cfg, policy, state)
        elif page_table is None:
            out, _ = attn.apply_mla_decode(m, h, cfg, policy, state,
                                           cache_pos)
        else:
            out, _ = attn.apply_mla_decode_paged(m, h, cfg, policy, state,
                                                 cache_pos, page_table)
    elif train:
        out = attn.apply_attention(m, h, cfg, policy)
    elif mode == "prefill":
        out, _ = attn.apply_attention_prefill(m, h, cfg, policy, state)
    elif mode == "prefill_shared":
        out, _ = attn.apply_attention_prefill_shared(m, h, cfg, policy, state,
                                                     page_table)
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
    aux = None
    if train:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "none":
        return x, aux
    h2 = rmsnorm(p["ln2"], x, policy, cfg.norm_eps)
    if spec.ffn != "moe":
        return x + apply_mlp(p["ffn"], h2, policy), aux
    if mode == "decode" and cfg.moe.dropless_decode:
        out2 = moe_mod.apply_moe_decode(p["ffn"], h2, cfg, policy,
                                        valid=live)
    else:
        groups = 1 if h2.shape[1] == 1 else None
        v2 = None if live is None else live[:, None]
        out2, moe_aux = moe_mod.apply_moe(p["ffn"], h2, cfg, policy, groups,
                                          valid=v2)
        if train:
            aux = moe_aux
    return x + out2, aux


def _run_layers(params, x: torch.Tensor, layers, cfg: ArchConfig,
                policy: str, cache, mode: str, cache_pos=None,
                page_table=None, live=None) -> torch.Tensor:
    for i in layers:
        x = _apply_layer(_layer(params, cfg, i), x, cfg, cfg.layer_spec(i),
                         policy, cache.layer(i), mode, cache_pos, page_table,
                         live)
    return x


def _embed(params, inputs: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """inputs: int token ids [B, T], or (a config with ``frontend_stub``)
    the frontend's embeddings [B, T, d], floating. Returns the embeddings
    in the config's compute dtype (for token ids a no-op cast unless an
    fp32 config runs on lower-precision weights: every op upcasts its
    weights, so that computes the same model without rounding)."""
    dt = getattr(torch, cfg.dtype)
    if inputs.is_floating_point():
        if not cfg.frontend_stub or inputs.dim() != 3:
            raise ValueError(f"{cfg.name}: embeddings [B, T, d] are taken "
                             f"only by a stub frontend (frontend_stub), got "
                             f"{inputs.dtype} {tuple(inputs.shape)}")
        return inputs.to(dt)
    return params["embed"][inputs.long()].to(dt)


def _head(params, x: torch.Tensor, cfg: ArchConfig, policy: str):
    h = rmsnorm(params["final_norm"], x, policy, cfg.norm_eps)
    return xaif.call("gemm", policy, h, params["unembed"])


def _exit_logits(params, x: torch.Tensor, i: int, cfg: ArchConfig,
                 policy: str):
    return apply_exit_head(params["exits"][i], x, params["unembed"], policy,
                           cfg.norm_eps)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


REMAT = ("nothing", "dots", "full")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat="dots"``: keep the
    outputs of the matrix products, recompute everything else."""
    aten = torch.ops.aten
    dots = (aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_wrap(fn, remat: str):
    """The JAX package's ``_remat_wrap`` on ``torch.utils.checkpoint``:
    ``"full"`` keeps only ``fn``'s inputs and recomputes the rest in the
    backward (``jax.checkpoint``); ``"dots"`` also keeps the outputs of
    the matrix products (selective checkpointing on ``aten.mm`` /
    ``bmm`` / ``addmm`` / ``baddbmm``, as ``checkpoint_dots`` keeps the
    dot products; the plain GEMM's products are fp32, so what it keeps is
    fp32); ``"nothing"`` keeps every activation."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: one of {REMAT}")
    if remat == "nothing":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def _train_layers(params, cfg: ArchConfig) -> List[Dict]:
    """Every layer's parameters in absolute order, for training: the prefix
    layers as they are, and each stacked slot tensor split by one
    ``unbind``, whose backward stacks the layers' gradients in one op
    (``_layer``'s ``t[sb]`` would give each layer's gradient the whole
    stack's size)."""
    def row(slot, tensors):
        it = iter(tensors)
        return _map(slot, lambda _: next(it))

    rows = []
    for slot in params["slots"]:
        cols = [t.unbind(0) for t in _leaves(slot)]
        rows.append([row(slot, [c[sb] for c in cols])
                     for sb in range(cfg.num_superblocks)])
    return list(params.get("prefix", ())) + [
        rows[j][sb] for sb in range(cfg.num_superblocks)
        for j in range(cfg.period)]


def _train_trunk(params, inputs: torch.Tensor, cfg: ArchConfig, policy,
                 remat: str):
    """Embed and every layer (mode ``train``, no cache): (the last layer's
    output [B, T, d], [(exit index, hidden at its boundary)], aux). The
    aux loss sums as JAX's: each segment's layers from 0 in order, then the
    segments' sums. ``remat`` wraps each super-block (not the prefix
    layers), as JAX wraps its scan body."""
    x = _embed(params, inputs, cfg)
    layers = _train_layers(params, cfg)
    kd, period = cfg.first_k_dense, cfg.period
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(kd):
        x, a = _apply_layer_aux(layers[i], x, cfg, cfg.layer_spec(i),
                                policy, None, "train")
        aux_total = aux_total + a

    def superblock(x, aux, sb):
        for i in range(kd + sb * period, kd + (sb + 1) * period):
            x, a = _apply_layer_aux(layers[i], x, cfg, cfg.layer_spec(i),
                                    policy, None, "train")
            aux = aux + a
        return x, aux

    body = _remat_wrap(superblock, remat)
    hidden = []
    for start, end, exit_i in _segments(cfg):
        seg_aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for sb in range(start, end):
            x, seg_aux = body(x, seg_aux, sb)
        aux_total = aux_total + seg_aux
        if exit_i is not None:
            hidden.append((exit_i, x))
    return x, hidden, aux_total


def forward_train(params, inputs: torch.Tensor, cfg: ArchConfig, policy,
                  remat: str = "nothing"):
    """Training forward of inputs [B, T] (token ids, or a stub frontend's
    embeddings [B, T, d]) with no cache: (final logits [B, T, V], exit
    logits tuple, {"aux_loss": the MoE layers' summed aux}). Autograd
    reaches the parameters only through plain ops: a kernel launch on a
    tensor that requires grad raises (``xaif.call``), so on the card
    training runs under the ``"ref"`` policy."""
    x, hidden, aux = _train_trunk(params, inputs, cfg, policy, remat)
    exits = tuple(_exit_logits(params, h, i, cfg, policy)
                  for i, h in hidden)
    return _head(params, x, cfg, policy), exits, {"aux_loss": aux}


def forward_train_hidden(params, inputs: torch.Tensor, cfg: ArchConfig,
                         policy, remat: str = "nothing"):
    """``forward_train`` without the heads: (the pre-head hidden [B, T, d],
    the exit boundaries' hiddens (None without exits), aux). The chunked
    head and loss (``train_step.chunked_head_loss``) take it, so the
    [B, T, V] logits never exist whole."""
    x, hidden, aux = _train_trunk(params, inputs, cfg, policy, remat)
    return x, (tuple(h for _, h in hidden) or None), {"aux_loss": aux}


def forward_prefill(params, tokens: torch.Tensor, cfg: ArchConfig,
                    policy: str, cache: LMCache,
                    lengths: Optional[torch.Tensor] = None):
    """Full-sequence prefill of tokens [B, T] (or, for a stub frontend,
    embeddings [B, T, d]) filling ``cache`` (in place); returns
    (last_logits [B, V], cache).

    ``lengths`` [B]: TRUE lengths of right-padded inputs — logits are taken
    at each sequence's last real token and the cache records the true
    length, so one bucket serves every prompt length up to it (all-attention
    archs without an MoE only: an MoE would route the pad tokens and a
    recurrent layer would fold them into its state, so such archs are
    prefilled at their exact length)."""
    x = _embed(params, tokens, cfg)
    b, t = x.shape[0], x.shape[1]
    x = _run_layers(params, x, range(cfg.num_layers), cfg, policy, cache,
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


def copy_pages(cache: PagedLMCache, src: int, dst: int) -> PagedLMCache:
    """Copy-on-write: duplicate pool page ``src`` into ``dst`` in every
    attention layer, in place. The boundary page of a partial prefix match
    is copied here BEFORE the suffix prefill writes into it, so the
    divergent suffix never writes a page another slot still maps."""
    attn.copy_page(cache.pools, src, dst)
    return cache


def gather_pages(cache: PagedLMCache, page_ids: torch.Tensor):
    """Gather pool pages ``page_ids`` (position order) out of every
    attention layer: the device side of a host SWAP-OUT. The port stacks
    every attention layer's pool in one [La, P, ...] tensor (dense prefix
    layers and the super-blocks' layers in absolute order, the layer axis
    first), so the blocks are one ``PagedKVCache`` (GQA K / V) or
    ``PagedMLACache`` (latent / rotary key) of [La, n, ...] tensors.
    Recurrent state is slot-indexed, not paged: an arch with no attention
    layer gives None."""
    pools = cache.pools
    if not pools:
        return None
    ids = page_ids.to(device=pools[0].device, dtype=torch.long)
    return type(pools)(*(pool.index_select(1, ids) for pool in pools))


def scatter_pages(cache: PagedLMCache, page_ids: torch.Tensor,
                  blocks) -> PagedLMCache:
    """Write swapped-out ``blocks`` (a :func:`gather_pages` result) into
    pool pages ``page_ids`` of every attention layer, in place: the device
    side of a SWAP-IN. The ids need not be those the blocks were gathered
    from: the resumed slot maps fresh pages in the same position order,
    so the bytes it attends are the same."""
    pools = cache.pools
    if not pools:
        if blocks is not None:
            raise ValueError("page blocks for a cache without a page pool")
        return cache
    ids = page_ids.to(device=pools[0].device, dtype=torch.long)
    for pool, blk in zip(pools, blocks):
        if blk.shape[1] != ids.shape[0] or blk.shape[2:] != pool.shape[2:]:
            raise ValueError(f"blocks {tuple(blk.shape)} for {ids.shape[0]} "
                             f"pages of a pool {tuple(pool.shape)}")
        pool.index_copy_(1, ids, blk.to(device=pool.device,
                                        dtype=pool.dtype))
    return cache


def forward_prefill_shared(params, inputs: torch.Tensor, cfg: ArchConfig,
                           policy: str, cache: PagedLMCache, slot: int,
                           ctx: attn.SharedPrefillCtx, row_ids,
                           head: bool = True):
    """Fork-point prefill: run ONLY the unshared suffix of a prompt whose
    prefix KV is already resident in the page pools.

    ``inputs`` [1, Tsuf] holds the right-padded suffix (token ids, or a
    stub frontend's embeddings); ``ctx`` the shared / region page ids and
    the absolute positions; ``row_ids`` [max_pages] the slot's complete new
    page-table row (prefix ++ region, -1 beyond), written into the device
    table here with the slot's length ``ctx.true_len`` (other rows are the
    caller's to push). All-attention GQA archs without an MoE only
    (``check_shared_prefill``). Returns (first-token logits [1, V], cache),
    or ``(None, cache)`` with ``head=False`` (chunked prefill's
    intermediate chunks: only the KV writes matter)."""
    check_shared_prefill(cfg)
    x = _embed(params, inputs, cfg)
    x = _run_layers(params, x, range(cfg.num_layers), cfg, policy, cache,
                    "prefill_shared", page_table=ctx)
    cache.page_table[slot] = torch.as_tensor(
        row_ids, dtype=torch.int32).to(cache.page_table.device)
    cache.pos[slot] = ctx.true_len
    if not head:
        return None, cache
    n = ctx.true_len - ctx.start
    logits = _head(params, x[:, n - 1:n].contiguous(), cfg, policy)
    return logits[:, 0], cache


def forward_decode(params, tokens: torch.Tensor, cfg: ArchConfig,
                   policy: str, cache: Union[LMCache, PagedLMCache],
                   with_exits: bool = True,
                   live: Optional[torch.Tensor] = None):
    """One decode step. tokens [B, 1] (or, for a stub frontend, embeddings
    [B, 1, d]). ``cache`` is an LMCache (contiguous KV or MLA latents) or
    a PagedLMCache (page pools attended through the page table: the same
    numerics), each with slot-indexed recurrent state.
    Cached rows are written in place.
    ``live`` [B] bool (optional): the serve engine's occupied, not-done
    slots; dead slots are masked out of MoE routing, which on the dropless
    decode path never changes a live slot's output. Returns (final_logits
    [B, V], exit_logits tuple, cache with pos + 1); each exit's logits come
    from the hidden state at its boundary."""
    page_table = (cache.page_table if isinstance(cache, PagedLMCache)
                  else None)
    x = _embed(params, tokens, cfg)
    kd = cfg.first_k_dense
    run = dict(cfg=cfg, policy=policy, cache=cache, mode="decode",
               cache_pos=cache.pos, page_table=page_table, live=live)
    x = _run_layers(params, x, range(kd), **run)
    exit_lg: List[torch.Tensor] = []
    p = cfg.period
    for start, end, exit_i in _segments(cfg):
        x = _run_layers(params, x, range(kd + start * p, kd + end * p), **run)
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
    the accepted count. Early exits are not consulted. All-attention GQA
    archs only (the JAX package refuses verify for MLA and recurrent
    mixers too)."""
    _check_attention_only(cfg, "speculative verify", SPEC_RECURRENT)
    _check_gqa(cfg, "speculative verify")
    page_table = (cache.page_table if isinstance(cache, PagedLMCache)
                  else None)
    x = _embed(params, tokens, cfg)
    x = _run_layers(params, x, range(cfg.num_layers), cfg, policy, cache,
                    "verify", cache.pos, page_table)
    return _head(params, x, cfg, policy), cache


def _kv_propagate_layer(p, x_exit: torch.Tensor, cfg: ArchConfig,
                        policy: str, state, cache_pos: torch.Tensor) -> None:
    """CALM state propagation for one skipped attention layer: ``ln1`` of
    the exit hidden state, then only the K/V projections (MLA: the latent
    and the rotary key), written in place at ``cache_pos``. No scores, no
    output projection, no FFN: 2 of a dense GQA layer's 7 GEMMs."""
    h = rmsnorm(p["ln1"], x_exit, policy, cfg.norm_eps)
    attn.propagate_kv(p["mixer"], h, cfg, policy, state, cache_pos)


def forward_decode_gated(params, tokens: torch.Tensor, cfg: ArchConfig,
                         policy: str, cache: LMCache,
                         live: Optional[torch.Tensor] = None):
    """Early-exit decode that skips the layers past the (single) exit.

    Runs the layers up to the exit head, takes the entropy decision
    (``entropy_exit``) and, when every LIVE row exits, skips the remaining
    layers: their K/V rows (MLA: latents) are filled by CALM propagation
    from the exit hidden state (``_kv_propagate_layer``), so later steps
    attend a full cache, and the exit logits are returned. Otherwise the
    remaining layers and the final head run for every row, and exited rows
    take their exit logits. ``live`` [B] bool (optional): dead slots never
    veto the skip and are masked out of MoE routing, as in
    ``forward_decode``.

    The JAX package branches on the device (``lax.cond``). Here the branch
    reads ``gate.all()`` on the host: one synchronization a gated step.
    That read is this function's alone; ``forward_decode`` reads nothing
    on the host, so the ungated step can be captured whole.

    Contiguous cache only (the JAX package's gated path is not page-aware
    either). Returns (logits [B, V], exit_mask [B], cache with pos + 1)."""
    check_gated(cfg)
    if not isinstance(cache, LMCache):
        raise ValueError("gated decode is not page-aware: it takes a "
                         "contiguous LMCache")
    el, nl = cfg.early_exit.exit_layers[0], cfg.num_layers
    x = _embed(params, tokens, cfg)
    run = dict(cfg=cfg, policy=policy, cache=cache, mode="decode",
               cache_pos=cache.pos, live=live)
    x = _run_layers(params, x, range(el), **run)
    exit_lg = _exit_logits(params, x, 0, cfg, policy)[:, 0]
    exit_mask, _ = should_exit(exit_lg, cfg.early_exit.entropy_threshold,
                               policy)
    gate = exit_mask if live is None else exit_mask | ~live
    if bool(gate.all()):            # skip: propagate, keep the exit logits
        for i in range(el, nl):
            _kv_propagate_layer(_layer(params, cfg, i), x, cfg, policy,
                                cache.layer(i), cache.pos)
        logits = exit_lg
    else:
        x = _run_layers(params, x, range(el, nl), **run)
        logits = torch.where(exit_mask[:, None], exit_lg,
                             _head(params, x, cfg, policy)[:, 0])
    return logits, exit_mask, cache._replace(pos=cache.pos + 1)
