"""Weight initializers — the port of `paddle_tpu/nn/initializer/__init__.py`.

Each initializer is a callable ``init(shape, dtype, *, device=None,
generator=None)`` returning a tensor of ``shape`` in ``dtype`` on
``device`` (None means ``cuda``, as every entry point of the port).

The JAX package draws every random initializer on its global key stack
(``_rng.next_key()``), and so does the port, on `core.random`'s copy of
that stack, one key a call, in JAX's order:

- `Uniform` (and `XavierUniform`, `KaimingUniform`) is
  ``jax.random.uniform`` bit for bit (`core.random.uniform`);
- `Normal` (and `XavierNormal`, `KaimingNormal`) and `TruncatedNormal`
  take JAX's uniform bit for bit and then ``sqrt(2) * erfinv(u)``, as
  ``jax.random.normal`` / ``truncated_normal`` do; torch's ``erfinv`` is
  not XLA's polynomial, so these values agree with JAX's to a few float32
  ulps (2e-5 at |x| ~ 5), not bitwise.

With an explicit ``generator`` (a `torch.Generator`) the normal draws come
from it instead, on the CPU (``normal_``), then move to ``device``: the
GPT of the port builds its weights that way, so one generator seed gives
the same model on every device.  The uniform draws always come from the
key stack.

Weights carried from the JAX package (`Layer.set_state_dict`) need none
of this; the draws only start a model that is trained from scratch.
`Orthogonal`, `Dirac` and `Bilinear` are not ported yet (ROADMAP.md
Queue 1 item 9).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as _random
from ...device import resolve_device

__all__ = [
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "calculate_gain", "set_global_initializer",
]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64}


def to_dtype(dtype):
    """A torch dtype from a torch dtype or a Paddle dtype name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype).replace("paddle.", "")]


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0,
        "linear": 1.0,
        "conv1d": 1.0,
        "conv2d": 1.0,
        "conv3d": 1.0,
        "tanh": 5.0 / 3,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # paddle convention: [in_features, out_features]
        return shape[0], shape[1]
    # conv: [out_c, in_c, *kernel]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


def _uniform(shape, device, minval, maxval):
    """``jax.random.uniform(next_key(), shape, float32, minval, maxval)``,
    drawn on ``device``."""
    key = _random.next_key().to(device)
    return _random.uniform(key, tuple(shape), minval, maxval)


class Initializer:
    def __call__(self, shape, dtype, *, device=None, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, *, device=None, generator=None):
        return torch.full(tuple(shape), self.value, dtype=to_dtype(dtype),
                          device=resolve_device(device))


class Normal(Initializer):
    """``mean + std * n``, n drawn as `jax.random.normal` (module
    docstring)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, device=None, generator=None):
        dev = resolve_device(device)
        if generator is not None:
            out = torch.empty(tuple(shape)).normal_(self.mean, self.std,
                                                    generator=generator)
            return out.to(device=dev, dtype=to_dtype(dtype))
        lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
        out = _SQRT2 * torch.erfinv(_uniform(shape, dev, lo, 1.0))
        return (out * self.std + self.mean).to(to_dtype(dtype))


_SQRT2 = float(np.float32(math.sqrt(2.0)))


class TruncatedNormal(Initializer):
    """``mean + std * n``, n a normal truncated to (-2, 2), drawn as
    ``jax.random.truncated_normal(key, -2, 2)``: JAX's uniform between
    erf(-2 / sqrt 2) and erf(2 / sqrt 2), then ``sqrt(2) erfinv``, clipped
    inside the open interval."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, *, device=None, generator=None):
        dev = resolve_device(device)
        sqrt2 = torch.tensor(_SQRT2)
        a, b = (float(torch.erf(torch.tensor(v) / sqrt2)) for v in (-2., 2.))
        out = _SQRT2 * torch.erfinv(_uniform(shape, dev, a, b))
        lo = float(np.nextafter(np.float32(-2.0), np.float32(np.inf)))
        hi = float(np.nextafter(np.float32(2.0), np.float32(-np.inf)))
        out = out.clamp(lo, hi)
        return (out * self.std + self.mean).to(to_dtype(dtype))


class Uniform(Initializer):
    """``jax.random.uniform`` in [low, high), bit for bit."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, *, device=None, generator=None):
        out = _uniform(shape, resolve_device(device), self.low, self.high)
        return out.to(to_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, *, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device=device,
                                generator=generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, *, device=None, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device=device)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, *, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device=device,
                                                 generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, *, device=None, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in or fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device=device)


class Assign(Initializer):
    """The given value (a tensor, an array or a nested list), reshaped to
    ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, *, device=None, generator=None):
        v = self.value
        arr = (v.detach() if isinstance(v, torch.Tensor)
               else torch.from_numpy(np.array(v)))
        if tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(tuple(shape))
        return arr.to(device=resolve_device(device), dtype=to_dtype(dtype))


_global_initializer = [None]


def set_global_initializer(weight_init, bias_init=None):
    """Default initializers for subsequently created parameters (reference
    nn/initializer/set_global_initializer). Pass None to reset."""
    _global_initializer[0] = (weight_init, bias_init)


def _global_init_for(is_bias):
    g = _global_initializer[0]
    if g is None:
        return None
    return g[1] if is_bias else g[0]
