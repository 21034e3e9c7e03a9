"""Weight-only int8 quantization for serving (port of
``repro.serve.quantize``).

Every projection named in ``_QUANT_NAMES`` becomes a ``WeightQ``: int8
``q`` in the weight's shape and an fp32 ``scale`` ``[..., 1, N]``, one per
output column, in the weight's place in the tree. The ``gemm`` op takes a
``WeightQ`` wherever it takes a weight: its default backend reads the
int8 weight and dequantizes it on the fly (activations stay in the model
dtype); the lossy ``int8`` backend (W8A8, chosen only by a policy that
allows lossy backends: ``core/xaif.py``) also quantizes the activations
and multiplies in integers. Half the weight bytes of bf16.

The numerics are JAX's exactly (``kernels/gemm/ref.py quantize_int8``
along axis -2). A stacked ``[L, K, N]`` leaf is quantized one layer at a
time, so the fp32 temporaries stay one layer's size (yi-9b's whole
``w_gate`` stack in fp32 would be 8.7 GB).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.ref import WeightQ, dequantize, quantize_int8

__all__ = ["WeightQ", "dequantize", "quantize_leaf", "quantize_weights_int8"]

# The projection weights that flow through the XAIF "gemm" op, as in JAX.
# Weights read by other ops (expert stacks, xLSTM cells, MLA's absorbed
# path) stay in the model dtype.
_QUANT_NAMES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "unembed",
    "in_proj", "out_proj", "w_dkv",
})


def quantize_leaf(w: torch.Tensor) -> WeightQ:
    """Per-output-column int8 of w [..., K, N]; leading axes one slice at
    a time."""
    if w.dim() == 2:
        return WeightQ(*quantize_int8(w, dim=-2))
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(*w.shape[:-2], 1, w.shape[-1], dtype=torch.float32,
                        device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = quantize_leaf(w[i])
    return WeightQ(q, scale)


def quantize_weights_int8(params):
    """The params tree with its projection weights replaced by WeightQ;
    every other leaf is the same tensor (not a copy)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: (quantize_leaf(v)
                        if (k in _QUANT_NAMES and isinstance(v, torch.Tensor)
                            and v.dim() >= 2 and v.is_floating_point())
                        else walk(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple) and not isinstance(node, WeightQ):
            return tuple(walk(v) for v in node)
        return node

    return walk(params)
