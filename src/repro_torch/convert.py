"""Load the JAX package's parameters into the port.

``params_from_jax`` takes the JAX ``init_lm`` pytree after
``jax.device_get``: nested dicts, tuples and lists of numpy arrays, with
the per-layer weights stacked ``[n_superblocks, ...]``, DeepSeek's dense
prefix layers as a list (``params["prefix"]``), MoE experts as ``[E, ...]``
stacks with an fp32 router, and every matrix in the ``[K, N]`` layout. The
port keeps the same tree, containers and layout, so loading is a copy of
each array. A quantized tree (``repro.serve.quantize``) holds its
projections as ``WeightQ(q, scale)`` named tuples: each becomes the
port's ``WeightQ``, recognised by its fields. This module takes numpy only
and imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels.gemm.ref import WeightQ


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)          # a writable copy: never aliases the caller's
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: reinterpret the 16-bit patterns
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree for a JAX parameter tree of numpy arrays."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple) and getattr(node, "_fields", None) == \
                WeightQ._fields:
            return WeightQ(*(walk(v) for v in node))
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return _tensor(node, device)

    return walk(tree)
