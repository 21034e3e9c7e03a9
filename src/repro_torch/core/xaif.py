"""XAIF op registry (PyTorch port): one op name, two backends.

The JAX package dispatches each op (``gemm``, ``rmsnorm``, ``attention``,
``attn_decode``, ``attn_decode_paged``, ``verify_decode``,
``verify_decode_paged``, ``entropy_exit``, ``moe_decode``, ``ssm_scan``,
``ssm_decode``) through
``repro.core.xaif`` to a pure-jnp ``ref`` backend or a Pallas TPU kernel.
Here every op has

  * a PLAIN backend — straightforward PyTorch with the JAX ref's numerics,
    used for CPU tensors and as the oracle the kernels are held against;
  * a KERNEL backend — the wrapper of a hand-written CUDA kernel
    (``repro_torch/csrc/``). It raises on a CPU tensor and counts its own
    launches in ``wrapper.launches`` (a plain int).

An op's kernel wrapper may launch one of several kernels (``attn_decode``
launches the GQA kernel or, in precise mode, the MLA kernel); its counter
counts them all. The port adds one op the JAX package has not:
``gemm_heads``, the per-head fp32 products of MLA's absorbed decode and of
the xLSTM mixers' block-diagonal weights (plain einsums in JAX). The
``ssm_decode`` op has two modes, Mamba and mLSTM, each with its own kernel
behind the one wrapper and counter.

``call(op, policy, *args)`` picks the backend from the device of the first
tensor argument: CUDA tensors launch the kernel, CPU tensors run the plain
version. Policy ``"ref"`` forces the plain version on any device; nothing
else does — there is no fallback from a kernel to the plain version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

POLICIES = ("auto", "ref")


@dataclass(frozen=True)
class OpEntry:
    name: str
    plain: Callable
    kernel: Callable


_REGISTRY: Dict[str, OpEntry] = {}
_BUILTINS = []          # set once the built-in ops modules are imported


def register(name: str, plain: Callable, kernel: Callable) -> None:
    _REGISTRY[name] = OpEntry(name, plain, kernel)


def _ensure_builtin_ops() -> None:
    # a flag, not "is the registry empty": importing one ops module
    # directly registers that op alone
    if _BUILTINS:
        return
    # the ops modules import no CUDA toolchain: kernels build at first launch
    from repro_torch.kernels.attn_decode import ops as _ad     # noqa: F401
    from repro_torch.kernels.entropy_exit import ops as _ee    # noqa: F401
    from repro_torch.kernels.flash_attention import ops as _fa  # noqa: F401
    from repro_torch.kernels.gemm import ops as _gemm          # noqa: F401
    from repro_torch.kernels.moe_decode import ops as _moe     # noqa: F401
    from repro_torch.kernels.paged_attention import ops as _pa  # noqa: F401
    from repro_torch.kernels.rmsnorm import ops as _rn         # noqa: F401
    from repro_torch.kernels.ssm_decode import ops as _sd      # noqa: F401
    from repro_torch.kernels.ssm_scan import ops as _ss        # noqa: F401
    from repro_torch.kernels.verify_decode import ops as _vd   # noqa: F401
    _BUILTINS.append(True)


def entry(name: str) -> OpEntry:
    _ensure_builtin_ops()
    return _REGISTRY[name]


def ops() -> Tuple[str, ...]:
    _ensure_builtin_ops()
    return tuple(sorted(_REGISTRY))


def call(op: str, policy: str, *args, **kwargs):
    """Dispatch ``op``: the kernel for CUDA tensors under ``"auto"``, the
    plain version for CPU tensors or under ``"ref"``."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of "
                         f"{POLICIES}")
    e = entry(op)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    if policy == "ref" or device.type == "cpu":
        return e.plain(*args, **kwargs)
    return e.kernel(*args, **kwargs)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last reset."""
    return {name: entry(name).kernel.launches for name in ops()}


def reset_launch_counts() -> None:
    for name in ops():
        entry(name).kernel.launches = 0
