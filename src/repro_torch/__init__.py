"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

The layout mirrors ``src/repro/``; every op that the JAX package ran as a
Pallas TPU kernel runs here as a hand-written CUDA kernel (``csrc/``),
dispatched through ``core/xaif.py``. The package imports torch, numpy and
the standard library only.
"""
