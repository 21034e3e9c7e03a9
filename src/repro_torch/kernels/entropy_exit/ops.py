"""Wrapper of the entropy-exit kernel (``csrc/entropy_exit.cu``) and its op."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import xaif
from repro_torch.kernels._build import (DTYPE_CODE, check, dtype_code,
                                        library, require_cuda, stream_ptr)
from repro_torch.kernels.entropy_exit.ref import entropy_ref, log_vocab


def _lib() -> ctypes.CDLL:
    lib = library("entropy_exit")
    if lib.entropy_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.entropy_launch.argtypes = [p, p, i, i, ctypes.c_float, i, p]
        lib.entropy_launch.restype = i
        for fn in (lib.entropy_cluster_blocks, lib.entropy_loads_per_thread):
            fn.argtypes = [i, i]
            fn.restype = i
    return lib


def entropy_plan(v: int, dtype: torch.dtype) -> str:
    """The plan the kernel takes for rows of v logits of ``dtype``, as the
    card's library computes it from (v, dtype) alone: the blocks of a
    row's cluster and the 16-byte loads a thread issues in a pass."""
    lib, code = _lib(), DTYPE_CODE[dtype]
    c = lib.entropy_cluster_blocks(v, code)
    return (f"a cluster of {c} block{'s' if c > 1 else ''} x 256 threads a "
            f"row, {lib.entropy_loads_per_thread(v, code)} loads a thread")


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., V] -> normalized entropy [...] (fp32), on the card."""
    require_cuda("entropy_exit", logits)
    code = dtype_code("entropy_exit", logits)
    v = logits.shape[-1]
    m = logits.numel() // v
    out = torch.empty(logits.shape[:-1], dtype=torch.float32,
                      device=logits.device)
    if m == 0:
        return out
    lib = _lib()
    rc = lib.entropy_launch(logits.data_ptr(), out.data_ptr(), m, v,
                            log_vocab(v), code, stream_ptr(logits))
    entropy.launches += 1
    check(lib, rc, "entropy_exit")
    return out


entropy.launches = 0

xaif.register("entropy_exit", entropy_ref, entropy)
