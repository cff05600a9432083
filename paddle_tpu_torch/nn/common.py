"""Common layers — the port of `paddle_tpu/nn/common.py`: `Linear`,
`Embedding`, `Dropout`, `Dropout2D`, `Dropout3D`, `AlphaDropout`,
`Identity` and `Flatten`, in JAX's positional signatures.

``device``, ``dtype`` and ``generator`` are keyword-only: the device the
parameters live on (None means ``cuda``), their dtype (float32 unless
given) and a `torch.Generator` for the normal initializers (`initializer`;
without one they draw on the `core.random` key stack, as JAX does).
`Pad*`, `Upsample*`, `Unfold`, `Fold` and `CosineSimilarity` are still
to come (ROADMAP.md Queue 1 item 9); the conv, pooling and BatchNorm
layers are in `conv`, `pooling` and `norm`.
"""
from __future__ import annotations

import torch

from . import functional as F
from .initializer import XavierNormal
from .layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Identity"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b with W: [in_features, out_features] (reference layout);
    W drawn XavierNormal, b zeros, unless the attrs say otherwise
    (``bias_attr=False``: no bias)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype or "float32")
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal(), **kw)
        if bias_attr is not False:
            self.bias = self.create_parameter(
                shape=[out_features], attr=bias_attr, is_bias=True, **kw)
        else:
            self.bias = None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(Layer):
    """Rows of ``weight`` [num_embeddings, embedding_dim] by index, drawn
    XavierNormal unless ``weight_attr`` says otherwise; the row
    ``padding_idx`` is zero, and its lookups give zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype or "float32")
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierNormal(), device=device,
            generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """`nn.functional.dropout` with this layer's ``p``, ``axis`` and
    ``mode``, in training mode only (``self.training``); the keep mask
    draws on the `core.random` key stack, as JAX's, or from ``generator``
    (keyword-only) where one is given.  ``name`` is accepted and unused,
    as in JAX."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Flatten(Layer):
    """Axes ``start_axis`` .. ``stop_axis`` merged into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)

