"""Normalization layers — the port of `paddle_tpu/nn/norm.py`:
`BatchNorm`, `BatchNorm1D`, `BatchNorm2D`, `BatchNorm3D` (through
`nn.functional.batch_norm`: Paddle's running statistics, JAX's
roundings), `LayerNorm` (through the gated `nn.functional.layer_norm`:
the LayerNorm kernels under ``PTPU_PALLAS_LN=1``, as JAX's
`nn/functional/__init__.py:684-699`) and `RMSNorm`.  `SyncBatchNorm`,
`GroupNorm`, `InstanceNorm*`, `LocalResponseNorm` and `SpectralNorm` are
still to come (ROADMAP.md Queue 1 item 9).  ``device`` and ``dtype`` are
keyword-only (None: ``cuda``, float32)."""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import functional as F
from .initializer import Constant
from .layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "LayerNorm", "RMSNorm"]


class _BatchNormBase(Layer):
    """Weight ones and bias zeros over ``num_features`` (either left out
    with its attr False); the float32 buffers ``_mean`` (zeros) and
    ``_variance`` (ones), under JAX's names, so that ``state_dict`` keys
    match.  In training mode (unless ``use_global_stats``) the forward
    normalises by the batch statistics and updates the buffers with
    ``momentum``; in eval mode it reads them."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype or "float32")
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=Constant(1.0), device=device)
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True,
                device=device)
        else:
            self.bias = None
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    """Over [N, C] or [N, C, L] (``NCL``), or channel-last (``NLC``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, "NCHW" if data_format == "NCL" else "NLC",
                         use_global_stats, device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr,
                         "NCHW" if data_format == "NCDHW" else "NDHWC",
                         use_global_stats, device=device, dtype=dtype)


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes; weight ones,
    bias zeros (either left out with its attr False)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or "float32")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is not False:
            self.weight = self.create_parameter(
                shape=self._normalized_shape, attr=weight_attr,
                default_initializer=Constant(1.0), device=device)
        else:
            self.weight = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=self._normalized_shape, attr=bias_attr, is_bias=True,
                device=device)
        else:
            self.bias = None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last axis, weight
    ones."""

    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype or "float32")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=list(normalized_shape), attr=weight_attr,
            default_initializer=Constant(1.0), device=device)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)
