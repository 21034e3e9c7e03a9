"""The LM trainer (port of ``repro.train.trainer``): the data pipeline,
the training step and a metric history.

This is the path the JAX trainer takes without a checkpoint directory:
checkpoints, ``ResilientLoop`` and ``run_with_restarts`` are not ported
yet (ROADMAP 1.7b), and a ``checkpoint_dir`` raises.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import Prefetcher, lm_batches
from repro_torch.models import lm
from repro_torch.optim.adamw import init_adamw
from repro_torch.train.train_step import TrainState, make_train_step

CHECKPOINTS = ("checkpoints are not ported yet: the torch checkpointer, "
               "ResilientLoop and run_with_restarts are ROADMAP 1.7b")


def train(run: RunConfig, num_steps: int,
          checkpoint_dir: Optional[str] = None, log_every: int = 10,
          batch_override: Optional[int] = None,
          seq_override: Optional[int] = None, print_fn=print,
          params=None, device="cuda") -> Dict[str, list]:
    """Single-host training of ``run`` for ``num_steps`` steps on
    ``lm_batches`` of ``run.seed``; returns the metric history (``loss``,
    ``loss_final``, ``loss_exit{i}``, ``aux_loss``, ``grad_norm``, ``lr``:
    one float a step). Starts from ``params`` (trained in place; e.g. the
    JAX package's ``init_lm`` through ``convert.params_from_jax``) or from
    ``lm.init_lm(run.arch, run.seed)`` on ``device``. Prints a line every
    ``log_every`` steps, as the JAX trainer does."""
    if checkpoint_dir is not None:
        raise NotImplementedError(f"train(checkpoint_dir=...): {CHECKPOINTS}")
    cfg = run.arch
    b = batch_override or run.shape.global_batch
    t = seq_override or run.shape.seq_len
    init_fn, step_fn = make_train_step(run)
    state = (init_fn(run.seed, resolve_device(device)) if params is None
             else TrainState(params, init_adamw(params)))
    device = lm._leaves(state.params)[0].device

    data = Prefetcher(lm_batches(cfg.vocab_size, b, t, seed=run.seed))
    history: Dict[str, list] = {}
    t_last = time.time()
    for i, batch in zip(range(num_steps), data):
        state, metrics = step_fn(state, {
            "inputs": torch.from_numpy(batch["inputs"]).to(device),
            "labels": torch.from_numpy(batch["labels"]).to(device)})
        for k, v in metrics.items():
            history.setdefault(k, []).append(float(v))
        if (i + 1) % log_every == 0:
            dt = (time.time() - t_last) / log_every
            t_last = time.time()
            print_fn(f"step {i+1}: loss={history['loss'][-1]:.4f} "
                     f"grad_norm={history['grad_norm'][-1]:.3f} "
                     f"({dt*1e3:.0f} ms/step)")
    return history
