"""Activation layers — the port of `paddle_tpu/nn/activation.py`, the layers
whose functionals the port has: `ReLU`, `ReLU6`, `GELU`, `Sigmoid`,
`Tanh`, `Softmax`, `LogSoftmax` and `Silu`.  Positional arguments map onto
the functional's parameters after x, in order, as in JAX (``GELU(True)``
is the tanh form, ``Softmax(1)`` normalises axis 1).  The other
activations wait (ROADMAP.md Queue 1 item 9)."""
from __future__ import annotations

import inspect

from . import functional as F
from .layer import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax",
           "LogSoftmax", "Silu"]


def _simple(fn_name, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = {**fixed}
            # positional args map onto the functional's signature in order
            fn = getattr(F, fn_name)
            sig = list(inspect.signature(fn).parameters)[1:]
            for name, val in zip(sig, args):
                self._kwargs[name] = val
            for k, v in kwargs.items():
                if k != "name":
                    self._kwargs[k] = v

        def forward(self, x):
            return getattr(F, fn_name)(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = fn_name
    return _Act


ReLU = _simple("relu")
ReLU6 = _simple("relu6")
GELU = _simple("gelu")
Sigmoid = _simple("sigmoid")
Tanh = _simple("tanh")
Softmax = _simple("softmax")
LogSoftmax = _simple("log_softmax")
Silu = _simple("silu")
