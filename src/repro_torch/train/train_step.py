"""The training step (port of ``repro.train.train_step``): multi-exit
loss, microbatched gradient accumulation, the remat policy and AdamW, all
from a ``RunConfig``.

``make_train_step(run)`` returns (init_state, train_step). The step runs
autograd through ``run.policy``'s ops: no kernel has a backward, so on the
card that is ``"ref"`` (the plain PyTorch ops); under ``"auto"`` a kernel
launch on a tensor that requires grad raises (``xaif.call``), and the step
never switches policy behind the caller's back. Gradients are taken with
respect to detached views of the parameters, and AdamW then writes the
parameters, moments and master weights in place: the caller's parameter
tree is the trained one, and it never requires grad.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import RunConfig
from repro_torch.core.early_exit import cross_entropy, multi_exit_loss
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     cosine_schedule, init_adamw)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def chunked_head_loss(params, x: torch.Tensor, labels: torch.Tensor, cfg,
                      policy, chunk: int, exit_states=None):
    """The head GEMM and CE over sequence chunks, so the fp32 [B, T, V]
    logits never exist whole: each chunk's head and loss run under
    ``torch.utils.checkpoint`` (JAX: ``jax.checkpoint``), so the backward
    recomputes one chunk's logits at a time.

    x: the final hidden [B, T, d] (after the layers, before the norm);
    ``exit_states``: the exit boundaries' hiddens, or None. The sequence is
    cut into ``max(T // chunk, 1)`` equal chunks, as JAX reshapes it: a T
    that count does not divide raises (JAX's reshape fails there).
    Returns (loss, metrics): the mean over chunks of the chunks' final CE,
    plus the exit weight times the mean over chunks and exits of the
    exits' CE (``loss_exit0``)."""
    b, t, _ = x.shape
    nch = max(t // chunk, 1)
    if t % nch:
        raise ValueError(f"chunked head loss: {nch} chunks (T {t} // chunk "
                         f"{chunk}) do not divide the sequence of {t}")
    size = t // nch

    def one_chunk(xc, lc, *exits_c):
        loss = cross_entropy(lm._head(params, xc, cfg, policy), lc)
        exit_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, ec in enumerate(exits_c):
            el = lm._exit_logits(params, ec, i, cfg, policy)
            exit_loss = exit_loss + cross_entropy(el, lc)
        return loss, exit_loss

    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    exit_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nch):
        sl = slice(c * size, (c + 1) * size)
        exits_c = () if exit_states is None else tuple(
            e[:, sl] for e in exit_states)
        l, le = checkpoint(one_chunk, x[:, sl], labels[:, sl], *exits_c,
                           use_reentrant=False)
        loss_sum, exit_sum = loss_sum + l, exit_sum + le
    loss = loss_sum / nch
    metrics = {"loss_final": loss}
    if exit_states is not None and cfg.early_exit is not None:
        le = exit_sum / nch / max(len(exit_states), 1)
        metrics["loss_exit0"] = le
        loss = loss + cfg.early_exit.loss_weight * le
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(run: RunConfig):
    """(init_state, train_step) for ``run``. ``init_state(seed, device)``
    draws the parameters (``lm.init_lm``) and a fresh AdamW state (fp32
    master weights); ``train_step(state, batch)`` takes {"inputs",
    "labels"} tensors on the parameters' device and returns (state,
    metrics: 0-dim tensors
    ``loss``, ``loss_final``, ``loss_exit{i}``, ``aux_loss``,
    ``grad_norm``, ``lr``). The learning rate is the cosine schedule
    (warmup 100, total 10000) at the step being taken."""
    cfg = run.arch
    policy = run.policy
    schedule = cosine_schedule(run.learning_rate, warmup=100, total=10_000)

    def init_state(seed: int = run.seed, device="cuda") -> TrainState:
        params = lm.init_lm(cfg, seed, device)
        return TrainState(params, init_adamw(params))

    def loss_fn(params, inputs, labels):
        if run.loss_chunk:
            x, exit_states, aux = lm.forward_train_hidden(
                params, inputs, cfg, policy, remat=run.remat)
            loss, metrics = chunked_head_loss(params, x, labels, cfg, policy,
                                              run.loss_chunk, exit_states)
        else:
            logits, exits, aux = lm.forward_train(params, inputs, cfg,
                                                  policy, remat=run.remat)
            if cfg.early_exit is not None:
                loss, metrics = multi_exit_loss(logits, exits, labels,
                                                cfg.early_exit)
            else:
                loss = cross_entropy(logits, labels)
                metrics = {"loss_final": loss}
        loss = loss + aux["aux_loss"]
        metrics["loss"] = loss
        metrics["aux_loss"] = aux["aux_loss"]
        return loss, metrics

    def grad_fn(params, inputs, labels):
        """(metrics detached, gradients in ``lm._leaves`` order) with
        respect to detached views of ``params``."""
        views = lm._map(params, lambda t: t.detach().requires_grad_(True))
        with torch.enable_grad():
            loss, metrics = loss_fn(views, inputs, labels)
            grads = torch.autograd.grad(loss, lm._leaves(views))
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        inputs, labels = batch["inputs"], batch["labels"]
        nmb = run.microbatch
        if nmb > 1:
            # gradient accumulation over a leading split, in fp32; the
            # metrics are the last microbatch's (JAX's scan carry)
            mb = inputs.shape[0] // nmb
            grads = None
            for i in range(nmb):
                sl = slice(i * mb, (i + 1) * mb)
                metrics, g = grad_fn(state.params, inputs[sl], labels[sl])
                grads = ([a.float() for a in g] if grads is None
                         else [a + b.float() for a, b in zip(grads, g)])
            grads = [g / nmb for g in grads]
        else:
            metrics, grads = grad_fn(state.params, inputs, labels)
        lr = schedule(state.opt.step + 1)   # +1: step counts updates done
        params, opt, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        return TrainState(params, opt), metrics

    return init_state, train_step
