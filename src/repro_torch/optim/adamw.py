"""AdamW with fp32 moments and fp32 master weights, global-norm gradient
clipping and decoupled weight decay (port of ``repro.optim.adamw``; its
``use_master=False`` has no caller and is not ported).

Written by hand in the JAX package's order of operations: the gradients
are clipped by the global norm of the unclipped gradients; the bias
corrections come from the incremented step; the update is ``base - lr *
(mhat / (sqrt(vhat) + eps) + wd * base)`` on the fp32 master, then cast
back to the parameter's dtype.
``torch.optim.AdamW`` rounds the same math differently and keeps no
master weights.

The JAX function returns new trees; here the parameters, moments and
master weights are written in place (one leaf's fp32 temporaries at a
time, not a second copy of the whole state), and the same trees are
returned. Every quantity stays on the parameters' device: no host sync.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.lm import _leaves as leaves, _map


class AdamWState(NamedTuple):
    step: torch.Tensor               # int32 [], the updates done
    m: Any                           # fp32 first moments, the params' tree
    v: Any                           # fp32 second moments
    master: Any                      # fp32 copy of the params


def init_adamw(params) -> AdamWState:
    """Zero moments (fp32, each parameter's shape) and an fp32 copy of
    every parameter (its own storage, also for fp32 parameters: the update
    writes it in place)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=device),
        _map(params, zeros), _map(params, zeros),
        _map(params, lambda p: p.detach().to(torch.float32, copy=True)))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update. ``grads``: the params' tree, or its leaves in
    order (any float dtype); ``lr``: a float or an fp32 scalar tensor (a
    schedule's value). Writes the parameters, moments and master weights
    in place; returns (params, the state with the step advanced,
    {"grad_norm": the unclipped global norm})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    step = state.step + 1
    sf = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, device=sf.device), sf)
    for p, g, m, v, base in zip(leaves(params), leaves(grads),
                                leaves(state.m), leaves(state.v),
                                leaves(state.master)):
        gf = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mhat = m / c1
        vhat = v / c2
        base.copy_(base - lr * (mhat / (torch.sqrt(vhat) + eps)
                                + weight_decay * base))
        p.copy_(base)
    return params, state._replace(step=step), {"grad_norm": gnorm}


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine to
    0 at ``total``: ``lr(step)`` of an integer tensor, fp32."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = base_lr * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)
    return lr
