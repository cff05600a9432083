"""Pooling layers — the port of `paddle_tpu/nn/pooling.py`, whole: the
ten classes, in JAX's positional signatures: ``(kernel_size, stride,
padding, ceil_mode, data_format)`` for the window pools and
``(output_size, data_format)`` for the adaptive ones.  Any other keyword
(``exclusive``, ``return_mask``, ``divisor_override``, ``name``) is
accepted and unused, as in JAX: the layers pool with the functionals'
defaults.  A layer has no parameters and no device of its own.
"""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool2D",
]


class _Pool(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format=None, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x):
        kw = {"ceil_mode": self.ceil_mode}
        if self.data_format is not None:
            kw["data_format"] = self.data_format
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **kw)


class MaxPool1D(_Pool):
    _fn = "max_pool1d"


class MaxPool2D(_Pool):
    _fn = "max_pool2d"


class MaxPool3D(_Pool):
    _fn = "max_pool3d"


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"


class AvgPool2D(_Pool):
    _fn = "avg_pool2d"


class AvgPool3D(_Pool):
    _fn = "avg_pool3d"


class _AdaptivePool(Layer):
    _fn = None

    def __init__(self, output_size, data_format=None, **kwargs):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        if self.data_format is not None:
            return getattr(F, self._fn)(x, self.output_size,
                                        data_format=self.data_format)
        return getattr(F, self._fn)(x, self.output_size)


class AdaptiveAvgPool1D(_AdaptivePool):
    _fn = "adaptive_avg_pool1d"


class AdaptiveAvgPool2D(_AdaptivePool):
    _fn = "adaptive_avg_pool2d"


class AdaptiveAvgPool3D(_AdaptivePool):
    _fn = "adaptive_avg_pool3d"


class AdaptiveMaxPool2D(_AdaptivePool):
    _fn = "adaptive_max_pool2d"
