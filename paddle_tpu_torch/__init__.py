"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu` for NVIDIA Hopper.

The JAX package `paddle_tpu` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports neither `jax` nor
anything of `paddle_tpu`.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises.

Kernels on the serving path are hand-written CUDA C++ for ``sm_90a``
(``paddle_tpu_torch/csrc``), built with ``nvcc`` at first use
(`ops._build`).  On a CPU tensor every wrapper computes its plain PyTorch
version instead — that is what the CPU parity tests run.
"""
from . import amp
from .device import resolve_device

__all__ = ["amp", "resolve_device"]
