"""The paper's TinyAI benchmark models (§V; port of ``repro.models.cnn``): a
CNN and an encoder transformer for seizure detection on bio-signal
windows, each with ONE entropy-thresholded early exit after its first
major stage (first conv block / first encoder layer).

~100k-parameter models, trained for real (``repro_torch.train.
early_exit``) on synthetic, highly unbalanced windows, binary
classification of inputs [B, T, C] (T time samples, C electrode
channels); everything is fp32, as in the JAX package. Parameters are plain
dicts and lists of tensors in the JAX package's layout (conv weights
``[k, Cin, Cout]``, dense weights ``[K, N]``), so ``convert.
params_from_jax`` is a pure copy. The ops the JAX models send through
XAIF go through ``xaif.call`` here at the same places: the heads
(``gemm`` with bias), the transformer's norms (``rmsnorm``) and its
non-causal attention (``attention``); the convolutions, the patch
embedding and the encoder's projections are plain PyTorch, as they are
plain jnp there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import EarlyExitConfig
from repro_torch.core import xaif
from repro_torch.core.device import resolve_device
from repro_torch.core.energy import StageCost

# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeizureCNNConfig:
    name: str = "paper_seizure_cnn"
    in_channels: int = 18            # EEG montage channels
    window: int = 1024               # samples per window (4 s @ 256 Hz)
    channels: Tuple[int, ...] = (32, 64, 64, 128)
    kernel: int = 7
    pool: int = 4
    num_classes: int = 2
    early_exit: EarlyExitConfig = EarlyExitConfig(
        exit_layers=(1,), loss_weight=0.01, entropy_threshold=0.35,
        share_unembed=False)


@dataclass(frozen=True)
class SeizureTransformerConfig:
    name: str = "paper_seizure_transformer"
    in_channels: int = 18
    window: int = 1024
    patch: int = 64                  # samples per token
    d_model: int = 64
    num_heads: int = 4
    d_ff: int = 128
    num_layers: int = 4
    num_classes: int = 2
    early_exit: EarlyExitConfig = EarlyExitConfig(
        exit_layers=(1,), loss_weight=0.1, entropy_threshold=0.45,
        share_unembed=False)


# ---------------------------------------------------------------------------
# Init: the JAX package's shapes and scales, drawn from a torch.Generator
# on the host and moved to ``device``, so that the card and the CPU start
# from the same parameters (torch's numbers, not jax.random's: tests that
# compare with JAX load JAX's parameters through ``params_from_jax``)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(*shape, generator=gen) * scale


def _dense(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), d_in ** -0.5)


def _head(gen: torch.Generator, d_in: int, n: int) -> Dict[str, torch.Tensor]:
    return {"w": _dense(gen, d_in, n), "b": torch.zeros(n)}


def _to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# CNN
# ---------------------------------------------------------------------------


def init_cnn(cfg: SeizureCNNConfig, seed: int = 0, device="cuda") -> Dict:
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    blocks = []
    cin = cfg.in_channels
    for cout in cfg.channels:
        blocks.append({"w": _normal(gen, (cfg.kernel, cin, cout),
                                    (cfg.kernel * cin) ** -0.5),
                       "b": torch.zeros(cout)})
        cin = cout
    exit_c = cfg.channels[cfg.early_exit.exit_layers[0] - 1]
    return _to({"blocks": blocks,
                "head": _head(gen, cin, cfg.num_classes),
                "exit_head": _head(gen, exit_c, cfg.num_classes)}, device)


def _conv1d(p, x: torch.Tensor) -> torch.Tensor:
    """Same-padded conv: torch's ``"same"`` pads as JAX's ``SAME`` does,
    (k - 1) // 2 before and the rest after. x [B, T, Cin], w [k, Cin,
    Cout] (JAX's WIO) -> [B, T, Cout]."""
    y = F.conv1d(x.transpose(1, 2), p["w"].permute(2, 1, 0),
                 padding="same")
    return y.transpose(1, 2) + p["b"]


def forward_cnn(params, x: torch.Tensor, cfg: SeizureCNNConfig,
                policy: xaif.PolicyLike
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """x [B, T, C] -> (final_logits [B, 2], (exit_logits [B, 2],))."""
    exit_after = cfg.early_exit.exit_layers[0]
    exit_logits = None
    for i, p in enumerate(params["blocks"]):
        x = torch.relu(_conv1d(p, x))
        # max-pool over windows of `pool`, T cut to a multiple of it
        bt = x.shape[1] // cfg.pool * cfg.pool
        x = x[:, :bt].reshape(x.shape[0], -1, cfg.pool, x.shape[-1]).amax(2)
        if i + 1 == exit_after:
            g = x.mean(dim=1)                             # GAP
            exit_logits = xaif.call("gemm", policy, g,
                                    params["exit_head"]["w"],
                                    bias=params["exit_head"]["b"])
    g = x.mean(dim=1)
    logits = xaif.call("gemm", policy, g, params["head"]["w"],
                       bias=params["head"]["b"])
    return logits, (exit_logits,)


def cnn_stage_costs(cfg: SeizureCNNConfig) -> Tuple[List[StageCost], int]:
    """FLOP/byte cost per stage for the Fig. 3 energy model.
    Returns (stages, exit_stage_index)."""
    stages = []
    t = cfg.window
    cin = cfg.in_channels
    exit_after = cfg.early_exit.exit_layers[0]
    exit_stage = -1
    for i, cout in enumerate(cfg.channels):
        macs = t * cfg.kernel * cin * cout
        byts = 4 * t * (cin + cout)
        stages.append(StageCost(f"conv{i}", macs, byts, offloadable=True))
        t //= cfg.pool
        cin = cout
        if i + 1 == exit_after:
            stages.append(StageCost("exit_head", cin * cfg.num_classes,
                                    4 * cin, offloadable=False))
            exit_stage = len(stages) - 1
    stages.append(StageCost("head", cin * cfg.num_classes, 4 * cin,
                            offloadable=False))
    return stages, exit_stage


# ---------------------------------------------------------------------------
# Encoder transformer (the paper's other benchmark model)
# ---------------------------------------------------------------------------


def init_transformer(cfg: SeizureTransformerConfig, seed: int = 0,
                     device="cuda") -> Dict:
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.d_model
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": torch.ones(d),
            "wq": _dense(gen, d, d),
            "wk": _dense(gen, d, d),
            "wv": _dense(gen, d, d),
            "wo": _dense(gen, d, d),
            "ln2": torch.ones(d),
            "w1": _dense(gen, d, cfg.d_ff),
            "w2": _dense(gen, cfg.d_ff, d),
        })
    n_tok = cfg.window // cfg.patch
    return _to({
        "patch_embed": _dense(gen, cfg.patch * cfg.in_channels, d),
        "pos": _normal(gen, (n_tok, d), 0.02),
        "layers": layers,
        "head": _head(gen, d, cfg.num_classes),
        "exit_head": _head(gen, d, cfg.num_classes),
    }, device)


def _heads(t: torch.Tensor, b: int, n: int, nh: int) -> torch.Tensor:
    """[B, T, d] -> [B, nh, T, d / nh], contiguous (the kernel's layout)."""
    return t.reshape(b, n, nh, -1).transpose(1, 2).contiguous()


def _encoder_layer(p, x: torch.Tensor, cfg: SeizureTransformerConfig,
                   policy: xaif.PolicyLike) -> torch.Tensor:
    h = xaif.call("rmsnorm", policy, x, p["ln1"])
    b, t, d = x.shape
    nh = cfg.num_heads
    q = _heads(h @ p["wq"], b, t, nh)
    k = _heads(h @ p["wk"], b, t, nh)
    v = _heads(h @ p["wv"], b, t, nh)
    out = xaif.call("attention", policy, q, k, v, causal=False)
    out = out.transpose(1, 2).reshape(b, t, d)
    x = x + out @ p["wo"]
    h2 = xaif.call("rmsnorm", policy, x, p["ln2"])
    # jax.nn.gelu defaults to the tanh approximation
    return x + F.gelu(h2 @ p["w1"], approximate="tanh") @ p["w2"]


def forward_transformer(params, x: torch.Tensor,
                        cfg: SeizureTransformerConfig,
                        policy: xaif.PolicyLike):
    """x [B, T, C] -> (final_logits, (exit_logits,))."""
    b = x.shape[0]
    n_tok = cfg.window // cfg.patch
    tok = x[:, : n_tok * cfg.patch].reshape(b, n_tok,
                                            cfg.patch * cfg.in_channels)
    h = tok @ params["patch_embed"] + params["pos"]
    exit_after = cfg.early_exit.exit_layers[0]
    exit_logits = None
    for i, layer in enumerate(params["layers"]):
        h = _encoder_layer(layer, h, cfg, policy)
        if i + 1 == exit_after:
            g = h.mean(dim=1)
            exit_logits = xaif.call("gemm", policy, g,
                                    params["exit_head"]["w"],
                                    bias=params["exit_head"]["b"])
    g = h.mean(dim=1)
    logits = xaif.call("gemm", policy, g, params["head"]["w"],
                       bias=params["head"]["b"])
    return logits, (exit_logits,)


def transformer_stage_costs(cfg: SeizureTransformerConfig
                            ) -> Tuple[List[StageCost], int]:
    n_tok = cfg.window // cfg.patch
    d = cfg.d_model
    stages = [StageCost("patch_embed", n_tok * cfg.patch * cfg.in_channels * d,
                        4 * n_tok * d, offloadable=True)]
    exit_after = cfg.early_exit.exit_layers[0]
    exit_stage = -1
    per_layer_macs = (4 * n_tok * d * d + 2 * n_tok * n_tok * d
                      + 2 * n_tok * d * cfg.d_ff)
    for i in range(cfg.num_layers):
        stages.append(StageCost(f"encoder{i}", per_layer_macs,
                                4 * 8 * n_tok * d, offloadable=True))
        if i + 1 == exit_after:
            stages.append(StageCost("exit_head", d * cfg.num_classes, 4 * d,
                                    offloadable=False))
            exit_stage = len(stages) - 1
    stages.append(StageCost("head", d * cfg.num_classes, 4 * d,
                            offloadable=False))
    return stages, exit_stage
