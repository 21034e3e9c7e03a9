"""The port stands alone: no JAX and nothing of the JAX package at run
time, the card by default, and kernels that never take CPU tensors."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs.base import get_arch
from repro_torch.kernels.attn_decode.ops import attn_decode
from repro_torch.kernels.entropy_exit.ops import entropy
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.gemm.ops import gemm
from repro_torch.kernels.rmsnorm.ops import rmsnorm

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_port_module_pulls_in_no_jax():
    mods = _port_modules()
    assert "repro_torch.serve.scheduler" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_names_the_jax_package():
    pat = re.compile(r"^\s*(import\s+(repro|jax)\b(?!_)|from\s+(repro|jax)"
                     r"(\.|\s))", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "kernel_ab.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.models import lm
    from repro_torch.serve.engine import SlotEngine
    cfg = get_arch("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotEngine(cfg, capacity=2, max_len=16)


@pytest.mark.parametrize("name", ["gemm", "rmsnorm", "attention",
                                  "attn_decode", "entropy_exit"])
def test_kernel_backend_raises_on_cpu_tensors(name):
    z2, z4 = torch.zeros(4, 128), torch.zeros(1, 2, 4, 128)
    calls = {
        "gemm": lambda: gemm(z2, torch.zeros(128, 8)),
        "rmsnorm": lambda: rmsnorm(z2, torch.ones(128)),
        "attention": lambda: attention(z4, z4, z4),
        "attn_decode": lambda: attn_decode(
            torch.zeros(1, 2, 128), z4, z4, torch.zeros(1, dtype=torch.int32)),
        "entropy_exit": lambda: entropy(z2),
    }
    before = {f.__name__: f.launches for f in (gemm, rmsnorm, attention,
                                               attn_decode, entropy)}
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        calls[name]()
    after = {f.__name__: f.launches for f in (gemm, rmsnorm, attention,
                                              attn_decode, entropy)}
    assert before == after
