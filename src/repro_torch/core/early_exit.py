"""Early-exit dynamic networks (port of ``repro.core.early_exit``): exit
heads, the normalized-entropy confidence and exit decision, the batched
merge of exit and final logits, and the training loss (token-mean cross
entropy, the multi-exit joint loss).

The exit decision goes through the XAIF ``entropy_exit`` op, so on the card
the entropy of each exit row is one pass of the entropy kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import EarlyExitConfig
from repro_torch.core import xaif
from repro_torch.kernels.entropy_exit.ref import entropy_ref


def normalized_entropy(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy of softmax(logits) normalized to [0, 1] by log(C), in fp32
    (the JAX ``normalized_entropy``: the paper's thresholds 0.1-0.5 only
    make sense on a normalized scale). The plain ``entropy_exit``."""
    return entropy_ref(logits.movedim(dim, -1))


def should_exit(logits: torch.Tensor, threshold: float, policy: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(exit_mask, entropy): exit where the normalized entropy is strictly
    below ``threshold``."""
    ent = xaif.call("entropy_exit", policy, logits)
    return ent < threshold, ent


def init_exit_head(d_model: int, dtype, device) -> Dict[str, torch.Tensor]:
    """One exit head sharing the final unembedding: only its RMSNorm
    scale, created in the model dtype as the JAX package does."""
    return {"norm_scale": torch.ones(d_model, dtype=dtype, device=device)}


def apply_exit_head(params: Dict[str, torch.Tensor], hidden: torch.Tensor,
                    shared_unembed: torch.Tensor, policy: str,
                    norm_eps: float = 1e-5) -> torch.Tensor:
    """hidden [..., d_model] -> exit logits [..., vocab]."""
    x = xaif.call("rmsnorm", policy, hidden, params["norm_scale"],
                  eps=norm_eps)
    w = params.get("unembed", shared_unembed)
    return xaif.call("gemm", policy, x, w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean CE in fp32. logits [..., C], labels [...] integer; with
    ``mask`` [...] the mean over the masked-in tokens (at least 1)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def multi_exit_loss(final_logits: torch.Tensor,
                    exit_logits: Tuple[torch.Tensor, ...],
                    labels: torch.Tensor, cfg: EarlyExitConfig,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L = CE(final) + w * mean_i CE(exit_i) (paper §V). Returns (L,
    metrics: ``loss_final``, ``loss_exit{i}`` and ``loss``)."""
    l_final = cross_entropy(final_logits, labels, mask)
    metrics = {"loss_final": l_final}
    if not exit_logits:
        return l_final, metrics
    l_exits = [cross_entropy(el, labels, mask) for el in exit_logits]
    for i, le in enumerate(l_exits):
        metrics[f"loss_exit{i}"] = le
    l_exit = sum(l_exits) / len(l_exits)
    loss = l_final + cfg.loss_weight * l_exit
    metrics["loss"] = loss
    return loss, metrics


def merge_exit_logits(final_logits: torch.Tensor,
                      exit_logits: Tuple[torch.Tensor, ...],
                      cfg: EarlyExitConfig, policy: str):
    """Batched early-exit selection: each row takes the FIRST confident
    exit's logits (exits are walked deepest first, so the shallowest
    confident one wins), else the final head's. Returns (selected_logits,
    exit_layer_index); the index is len(exit_logits) for rows that ran to
    the end."""
    selected = final_logits
    n = len(exit_logits)
    idx = torch.full(final_logits.shape[:-1], n, dtype=torch.int32,
                     device=final_logits.device)
    for i in reversed(range(n)):
        mask, _ = should_exit(exit_logits[i], cfg.entropy_threshold, policy)
        selected = torch.where(mask[..., None], exit_logits[i], selected)
        idx = torch.where(mask, torch.full_like(idx, i), idx)
    return selected, idx


def gated_layer_fraction(exit_layer_idx: torch.Tensor,
                         exit_layers: Tuple[int, ...],
                         num_layers: int) -> torch.Tensor:
    """Fraction of layer compute an exit would skip ("power-gated")."""
    bounds = torch.tensor(tuple(exit_layers) + (num_layers,),
                          dtype=torch.float32, device=exit_layer_idx.device)
    layers_run = bounds[exit_layer_idx.long()]
    return 1.0 - layers_run.mean() / float(num_layers)
