"""Serving engines (port of ``repro.serve.engine``, contiguous greedy mode):
the slot-based continuous-batching engine and the one-request reference
loop ``generate``.

  * The cache's batch dimension is a fixed set of SLOTS (``capacity``). A
    request is admitted by a bucketed batch-1 prefill written into a free
    slot row (``lm.fill_slot``); prompt length and occupancy are slot
    STATE (per-slot ``pos``/budget/done), never tensor shape.
  * Decode runs in chunks of ``chunk`` steps over the whole slot batch:
    greedy argmax, the early-exit merge and the statistics stay on the
    device, and the scheduler fetches (tokens, slot state) to the host once
    per chunk.

Every step runs the same kernels on the same per-row data whatever the
other slots hold (per-slot cache positions; the GEMM reduces each row in
one fixed order), so the engine's greedy tokens equal ``generate``'s.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.early_exit import (gated_layer_fraction,
                                         merge_exit_logits)
from repro_torch.models import lm


def _as_run(run: Union[RunConfig, ArchConfig]) -> RunConfig:
    return run if isinstance(run, RunConfig) else RunConfig(arch=run)


def _select(logits, exit_lgs, cfg: ArchConfig, policy: str):
    """Early-exit merge: (selected logits, exit index per row)."""
    if cfg.early_exit is not None and exit_lgs:
        return merge_exit_logits(logits, exit_lgs, cfg.early_exit, policy)
    return logits, None


@torch.inference_mode()
def generate(run: Union[RunConfig, ArchConfig], params, prompt,
             max_new_tokens: int, max_len: Optional[int] = None,
             device="cuda") -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy generation, one prompt batch at a time (the REFERENCE loop).
    prompt [B, T] ints. Returns (tokens [B, max_new_tokens], stats);
    statistics stay on the device until one fetch at the end."""
    run = _as_run(run)
    cfg, policy = run.arch, run.policy
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    b, t = prompt.shape
    max_len = max_len or (t + max_new_tokens)
    cache = lm.init_cache(cfg, b, max_len, device=device)
    logits, cache = lm.forward_prefill(params, prompt, cfg, policy, cache)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    exit_rate, gated = [], []
    for _ in range(max_new_tokens - 1):
        logits, exit_lgs, cache = lm.forward_decode(params, tok[:, None], cfg,
                                                    policy, cache)
        logits, exit_idx = _select(logits, exit_lgs, cfg, policy)
        if exit_idx is not None:
            exit_rate.append((exit_idx < len(exit_lgs)).float().mean())
            gated.append(gated_layer_fraction(
                exit_idx, cfg.early_exit.exit_layers, cfg.num_layers))
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    stats = {k: (float(torch.stack(v).mean()) if v else 0.0)
             for k, v in (("exit_rate", exit_rate), ("gated_fraction", gated))}
    return torch.stack(out, dim=1), stats


# ---------------------------------------------------------------------------
# Slot engine: continuous batching over a fixed-capacity slot batch
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    """Per-slot decode state + on-device statistics accumulators.

    Empty slots are born ``done``; admission flips a slot live. The
    tensors are updated in place by admission and replaced step by step by
    the decode chunk. ``quarantined`` is the NaN/Inf logit guard's verdict:
    a live slot whose logits go non-finite is frozen (its token is not
    emitted), marked done and flagged here, so the host sheds exactly that
    request.
    """
    tokens: torch.Tensor       # [S] i32 — last token per slot (next input)
    done: torch.Tensor         # [S] bool
    generated: torch.Tensor    # [S] i32 — tokens produced (incl. prefill's)
    budget: torch.Tensor       # [S] i32 — max_new_tokens per slot
    exit_cnt: torch.Tensor     # f32 — sum over steps of exited live slots
    gated_layers: torch.Tensor  # f32 — sum of per-slot gated fractions
    live_cnt: torch.Tensor     # f32 — sum over steps of live slots
    quarantined: torch.Tensor  # [S] bool
    realized: torch.Tensor     # f32 — tokens emitted by decode chunks


def init_decode_state(capacity: int, device) -> DecodeState:
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return DecodeState(
        tokens=torch.zeros(capacity, **i32),
        done=torch.ones(capacity, dtype=torch.bool, device=device),
        generated=torch.zeros(capacity, **i32),
        budget=torch.zeros(capacity, **i32),
        exit_cnt=z(), gated_layers=z(), live_cnt=z(),
        quarantined=torch.zeros(capacity, dtype=torch.bool, device=device),
        realized=z())


class SlotEngine:
    """Continuous batching over ``capacity`` slots of a ``max_len`` cache.

    ``prompt_bucket``: prompts are right-padded up to the next multiple of
    this for prefill (the pad is masked by the per-slot lengths), so the
    prefill shapes come from a small set of buckets. ``chunk``: decode steps
    per chunk between two host fetches.
    """

    def __init__(self, run: Union[RunConfig, ArchConfig], capacity: int,
                 max_len: int, chunk: int = 8, prompt_bucket: int = 16,
                 device="cuda"):
        self.run = _as_run(run)
        self.capacity = capacity
        self.max_len = max_len
        self.chunk = chunk
        self.prompt_bucket = prompt_bucket
        self.device = resolve_device(device)
        cfg = self.run.arch
        self._bounds = None
        if cfg.early_exit is not None:
            # layers run per exit index (the last entry: ran to the end)
            self._bounds = torch.tensor(
                tuple(cfg.early_exit.exit_layers) + (cfg.num_layers,),
                dtype=torch.float32, device=self.device)
        self.decode_calls = 0
        self.prefill_calls = 0
        # bucketed tokens pushed through prefill (proportional to its FLOPs)
        self.prefill_tokens = 0

    # -- device state ------------------------------------------------------

    @torch.inference_mode()
    def init_state(self) -> Tuple[lm.LMCache, DecodeState]:
        return (lm.init_cache(self.run.arch, self.capacity, self.max_len,
                              device=self.device),
                init_decode_state(self.capacity, self.device))

    # -- admission ---------------------------------------------------------

    def _bucket(self, t: int) -> int:
        b = self.prompt_bucket
        return min(-(-t // b) * b, self.max_len)

    @torch.inference_mode()
    def prefill_into(self, params, cache: lm.LMCache, st: DecodeState,
                     prompt, slot: int, max_new: int):
        """Admit one request: bucketed batch-1 prefill into ``slot``.
        prompt: 1-D ints. ``cache`` and ``st`` are updated in place.
        Returns (cache, st, first_token) with the token on the device."""
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        t = int(prompt.shape[0])
        if t + max_new > self.max_len:
            raise ValueError(f"prompt ({t}) + max_new ({max_new}) exceeds "
                             f"max_len ({self.max_len})")
        cfg, policy = self.run.arch, self.run.policy
        bucket = self._bucket(t)
        padded = torch.zeros(1, bucket, dtype=torch.int32)
        padded[0, :t] = prompt
        padded = padded.to(self.device)
        slot_cache = lm.init_cache(cfg, 1, bucket, device=self.device)
        lengths = torch.tensor([t], dtype=torch.int32, device=self.device)
        logits, slot_cache = lm.forward_prefill(params, padded, cfg, policy,
                                                slot_cache, lengths=lengths)
        lm.fill_slot(cache, slot_cache, slot, t)
        tok0 = logits[0].argmax(-1).to(torch.int32)
        st.tokens[slot] = tok0
        st.done[slot] = max_new <= 1
        st.generated[slot] = 1
        st.budget[slot] = max_new
        st.quarantined[slot] = False
        self.prefill_calls += 1
        self.prefill_tokens += bucket
        return cache, st, tok0

    @torch.inference_mode()
    def scrub_slot_kv(self, cache: lm.LMCache, slot: int) -> lm.LMCache:
        """Zero a quarantined slot's KV row before the slot is reused:
        masked softmax weights are exactly 0 and 0 * NaN = NaN, so a
        poisoned row would leak into its next occupant."""
        return lm.reset_slot(cache, slot)

    # -- decode ------------------------------------------------------------

    def _step(self, params, cache: lm.LMCache, st: DecodeState):
        cfg, policy = self.run.arch, self.run.policy
        live = ~st.done
        logits, exit_lgs, new_cache = lm.forward_decode(
            params, st.tokens[:, None], cfg, policy, cache)
        logits, exit_idx = _select(logits, exit_lgs, cfg, policy)
        if exit_idx is not None:
            exited = exit_idx < len(exit_lgs)
            gated_frac = 1.0 - self._bounds[exit_idx.long()] / cfg.num_layers
        else:
            exited = torch.zeros_like(st.done)
            gated_frac = torch.zeros(st.done.shape, device=self.device)
        next_tok = logits.argmax(-1).to(torch.int32)
        # NaN/Inf logit guard: a live slot whose logits went non-finite is
        # frozen, marked done and flagged — only that slot: rows never read
        # each other's KV, so co-batched requests are untouched
        bad = live & ~torch.isfinite(logits.float()).all(dim=-1)
        ok = live & ~bad
        next_tok = torch.where(ok, next_tok, st.tokens)
        # pin the positions of done/empty slots (their KV write lands one
        # past the valid prefix and is overwritten before it could be read)
        new_cache = new_cache._replace(
            pos=torch.where(live, new_cache.pos, cache.pos))
        generated = st.generated + ok.to(torch.int32)
        live_f = live.float()
        st = st._replace(
            tokens=next_tok,
            done=st.done | (generated >= st.budget) | bad,
            generated=generated,
            exit_cnt=st.exit_cnt + (exited.float() * live_f).sum(),
            gated_layers=st.gated_layers + (gated_frac * live_f).sum(),
            live_cnt=st.live_cnt + live_f.sum(),
            quarantined=st.quarantined | bad,
            realized=st.realized + ok.float().sum())
        return new_cache, st

    @torch.inference_mode()
    def decode(self, params, cache: lm.LMCache, st: DecodeState):
        """Run one chunk of ``chunk`` decode steps over all slots.
        Returns (cache, st, tokens [S, chunk]) with everything on the
        device; slot s's valid tokens are the first (generated delta)."""
        toks = torch.empty(self.capacity, self.chunk, dtype=torch.int32,
                           device=self.device)
        for i in range(self.chunk):
            cache, st = self._step(params, cache, st)
            toks[:, i] = st.tokens
        self.decode_calls += 1
        return cache, st, toks

    @staticmethod
    def stats(st: DecodeState) -> Dict[str, float]:
        """One host fetch of the on-device accumulators."""
        n = max(float(st.live_cnt), 1.0)
        return {"exit_rate": float(st.exit_cnt) / n,
                "gated_fraction": float(st.gated_layers) / n,
                "decode_slot_steps": float(st.live_cnt),
                "realized_tokens": float(st.realized)}
