"""Dropout keep masks on JAX's keys — the wrapper of
``csrc/threefry_bernoulli.cu``.

`bernoulli(key, p, shape, device)` is ``jax.random.bernoulli(key, p,
shape)`` (`core.random.bernoulli`) on ``device``: on a CUDA device one
launch of the kernel (the key's threefry2x32 hash of each element's
counter, compared with ``p`` in float32; bit for bit the plain version),
counted under ``threefry_bernoulli``; on the CPU the plain version.  The
JAX package has no Pallas kernel here: XLA fuses the draw into the step
(`paddle_tpu/nn/functional/__init__.py:903`)."""
from __future__ import annotations

import ctypes
import math

import torch

from ..core import random as _random
from . import _build

__all__ = ["bernoulli"]

KERNEL = "threefry_bernoulli"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
launches = 0


def _fn():
    fn = _build.load(SOURCE).threefry_bernoulli
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bernoulli(key, p, shape, device):
    """Bool [shape] on ``device``, True with probability ``p`` (a Python
    float, taken in float32), drawn from ``key`` (int64 [2]) as
    ``jax.random.bernoulli`` draws it."""
    global launches
    dev = torch.device(device)
    if dev.type != "cuda":
        return _random.bernoulli(key.to(dev), p, shape)
    shape = tuple(int(d) for d in shape)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    k0, k1 = (int(w) for w in key.tolist())
    err = _fn()(k0, k1, math.prod(shape), float(p), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, KERNEL)
    launches += 1
    return out
