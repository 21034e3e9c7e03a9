"""Build and load the port's CUDA kernels.

Every ``repro_torch/csrc/*.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. The build runs at first use,
one ``nvcc`` process per source, all started together. Each library is
named by a hash of its sources and flags, so an edited kernel rebuilds
and an unchanged one is reused. Outputs go to ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), next to the compiler's
log of each source (``-Xptxas -v``: registers, shared memory, spills).

Conventions every C entry point follows: pointers and the stream are
``void*`` (``ctypes.c_void_p``), sizes are ``int``, the kernel launches on
the caller's stream without synchronising, and the function returns
``cudaGetLastError()`` — :func:`check` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns {kernel source stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for src in sorted(SRC_DIR.glob("*.cu")):
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        procs[src.stem] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
             str(src)], stdout=log, stderr=subprocess.STDOUT), tmp, lib, log)
    failed = []
    for stem, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(stem)
    if failed:
        logs = "\n".join((BUILD_DIR / f"{s}.log").read_text()[-4000:]
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    if stem not in _LIBS:
        lib = ctypes.CDLL(str(build_all()[stem]))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return _LIBS[stem]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device, through
    PyTorch's raw accessor: no Stream object is built a call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel runs only on CUDA tensors, all on one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel got a tensor on "
                             f"{t.device}; plain versions serve CPU tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def require_aligned(name: str, *tensors: torch.Tensor) -> None:
    """A kernel that copies rows by 16-byte ``cp.async`` needs each
    tensor's data to start on a 16-byte boundary (its rows then do too)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must start on a 16-byte "
                             f"boundary (offset {t.data_ptr() % 16})")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODE:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(float32 or bfloat16)")
    return DTYPE_CODE[t.dtype]
