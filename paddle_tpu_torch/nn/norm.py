"""Normalization layers — the port of `paddle_tpu/nn/norm.py`: `LayerNorm`
(through the gated `nn.functional.layer_norm`: the LayerNorm kernels
under ``PTPU_PALLAS_LN=1``, as JAX's `nn/functional/__init__.py:684-699`)
and `RMSNorm`.  BatchNorm, GroupNorm and InstanceNorm wait for the conv
slice (ROADMAP.md Queue 1 item 9).  ``device`` and ``dtype`` are
keyword-only (None: ``cuda``, float32)."""
from __future__ import annotations

from . import functional as F
from .initializer import Constant
from .layer import Layer

__all__ = ["LayerNorm", "RMSNorm"]


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
