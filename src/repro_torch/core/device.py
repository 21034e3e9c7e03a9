"""Device selection for the port's entry points.

Every public entry point takes ``device="cuda"`` by default and runs on the
CPU only when the caller asks for it (the tests do). Without a card the
default raises here: nothing carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
