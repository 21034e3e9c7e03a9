"""Plain PyTorch versions of the fused GEMM (the JAX ``gemm_ref``
numerics), of the integer GEMM of W8A8 serving (the JAX
``quantize_int8`` / ``gemm_int8_ref``) and of the per-head fp32 products
of MLA's absorbed decode.

``WeightQ`` is the int8 weight format the ``gemm`` op accepts (the JAX
``serve/quantize.py`` NamedTuple): ``q`` int8 in the weight's shape and
``scale`` fp32 ``[..., 1, N]``, one scale per output column."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


class WeightQ(NamedTuple):
    q: torch.Tensor          # int8, the weight's shape
    scale: torch.Tensor      # fp32, [..., 1, N] per output column


def dequantize(w: WeightQ, dtype=torch.bfloat16) -> torch.Tensor:
    """(q.f32 * scale).astype(dtype), as the JAX ``dequantize`` and the
    gemm backends' ``_unpack_weight``."""
    return (w.q.float() * w.scale).to(dtype)


def gemm_ref(x: torch.Tensor, w: Union[torch.Tensor, WeightQ],
             bias: Optional[torch.Tensor] = None,
             activation: str = "none") -> torch.Tensor:
    """x [..., K] @ w [K, N] (+ bias) -> activation, fp32 accumulate. A
    ``WeightQ`` is dequantized to x's dtype first, as in JAX."""
    if isinstance(w, WeightQ):
        w = dequantize(w, x.dtype)
    out = torch.matmul(x.float(), w.float())
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(x.dtype)


def quantize_int8(x: torch.Tensor, dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim`` (-1: per row; 0 or -2:
    per column): (q int8, scale fp32 with ``dim`` kept). The JAX numerics:
    amax in fp32, max(amax, 1e-8) / 127, round half to even, clip +-127.

    The divisor is a tensor on x's device, not a Python number: CUDA's
    division by a host scalar multiplies by its reciprocal, which can
    differ from the quotient in the last bit; a division of two tensors
    rounds the quotient itself on either device, as the JAX function is
    written (and as JAX computes it op by op) and as the W8A8 kernel
    (``csrc/gemm_int8.cu``, ``__fdiv_rn``) does. Under ``jax.jit`` XLA
    may rewrite JAX's division by the constant into that product, which
    moves a few percent of the scales by one ulp: the port does not
    follow the rewrite."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-8) / amax.new_full((), 127.0)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ wq [K, N] int8 -> int32, exact. Computed in
    float64, which CUDA's matmul takes (it takes no integer type): every
    product and partial sum is an integer below 127^2 K < 2^53, so each
    addition is exact in any order."""
    return torch.matmul(xq.double(), wq.double()).to(torch.int32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c for fp32 tensors with ONE rounding, as a fused
    multiply-add (CUDA's ``__fmaf_rn``). In float64 the product is exact
    (24 + 24 bits) and the sum s is exact up to an error e that TwoSum
    recovers; fp32(s) is then the rounding of the exact sum, except where
    s lies exactly on a midpoint between two fp32 values: there the sign
    of e picks the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)                   # p + c == s + e
    r = s.float()
    rd = r.double()
    up = s > rd
    other = torch.nextafter(r, torch.where(up, torch.inf, -torch.inf).to(
        r.dtype))
    tie = (rd + other.double()) * 0.5 == s
    beyond = tie & (e != 0) & ((e > 0) == up)
    return torch.where(beyond, other, r)


def gemm_int8_ref(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  activation: str = "none",
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Integer GEMM with int32 accumulation and the JAX epilogue, in its
    order: (acc * x_scale) * w_scale (+ bias) -> activation -> out_dtype.
    xq [M, K] int8, wq [K, N] int8, x_scale [M, 1], w_scale [1, N].

    Each product is rounded on its own; with a bias, the second product
    and the sum are one fused multiply-add, as XLA compiles JAX's
    ``out * w_scale + bias`` (its ref and its Pallas kernel alike)."""
    acc = int_matmul(xq, wq)
    out = acc.float() * x_scale.float()
    if bias is None:
        out = out * w_scale.float()
    else:
        out = fma_f32(out, w_scale.float().expand_as(out),
                      bias.float().expand_as(out))
    return ACTIVATIONS[activation](out).to(out_dtype)


def int8_operands(x2: torch.Tensor, w: Union[torch.Tensor, WeightQ]):
    """(xq, x_scale, wq, w_scale) of the W8A8 GEMM of x2 [M, K]: the
    activations quantized per row; a ``WeightQ``'s int8 tiles and scales
    as they are, any other weight quantized per column (the JAX
    ``gemm_int8_pallas_op``)."""
    xq, xs = quantize_int8(x2, dim=-1)
    if isinstance(w, WeightQ):
        wq, ws = w.q, w.scale.reshape(1, -1)
    else:
        wq, ws = quantize_int8(w, dim=0)
    return xq, xs, wq, ws


def gemm_w8a8_ref(x: torch.Tensor, w: Union[torch.Tensor, WeightQ],
                  bias: Optional[torch.Tensor] = None,
                  activation: str = "none") -> torch.Tensor:
    """The plain version of the lossy ``gemm`` backend ``int8``: x [..., K]
    quantized per row, times the int8 weight, output in x's dtype."""
    k = x.shape[-1]
    xq, xs, wq, ws = int8_operands(x.reshape(-1, k), w)
    out = gemm_int8_ref(xq, wq, xs, ws, bias, activation, x.dtype)
    return out.reshape(*x.shape[:-1], wq.shape[-1])


# elements of one multiply + reduce temporary [rows, H, K, N] (64 MiB fp32)
_CHUNK_ELEMS = 1 << 24


def gemm_heads_ref(x: torch.Tensor, w: torch.Tensor, transpose_w: bool = False,
                   head_major: bool = False) -> torch.Tensor:
    """x fp32 [M, H, K]; w [L, H, D]. ``transpose_w``: the JAX einsum
    "bhd,lhd->bhl" (K = D); else "bhl,lhd->bhd" (K = L); ``head_major``: w
    [H, K, N] and "bhk,hkn->bhn" (the xLSTM mixers' block-diagonal
    weights). fp32 out.

    A multiply + reduce per row, not a batched dot, so that a row's bits
    never depend on how many rows share the call (the serve engine's token
    equality with the one-request loop rests on this). Rows go through in
    chunks, so the temporary stays under 64 MiB at a long prefill."""
    if head_major:
        wf = w.float()                                    # [H, K, N]
    else:
        wf = w.float().permute(1, 0, 2)                   # [H, L, D]
    step = max(1, _CHUNK_ELEMS // max(1, wf.numel()))
    outs = []
    for x_ in x.float().split(step):
        if transpose_w:
            outs.append((x_[:, :, None, :] * wf[None]).sum(dim=-1))
        else:
            outs.append((x_[:, :, :, None] * wf[None]).sum(dim=-2))
    return torch.cat(outs) if len(outs) > 1 else outs[0]
