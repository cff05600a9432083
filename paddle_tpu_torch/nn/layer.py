"""Layers of the port with the Paddle conventions of `paddle_tpu.nn`
(`nn/common.py` `Linear`, `Embedding`, `Dropout`; `nn/norm.py`
`LayerNorm`):
``Linear.weight`` is [in, out], ``LayerNorm`` holds ``weight`` and
``bias``.  Weights are drawn on the CPU from an explicit `torch.Generator`
(default: a fresh one seeded 0), then moved to ``device`` (None means
``cuda``), so one seed gives the same layer on every device."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from .functional import dropout, embedding, layer_norm, linear

__all__ = ["Linear", "LayerNorm", "Embedding", "Dropout"]


def _param(t, device, dtype):
    return nn.Parameter(t.to(device=resolve_device(device), dtype=dtype))


def _normal(shape, std, generator):
    g = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    return torch.empty(shape).normal_(0.0, std, generator=g)


def _xavier_std(shape):
    """XavierNormal's std for a [fan_in, fan_out] weight."""
    return math.sqrt(2.0 / (shape[0] + shape[1]))


class Linear(nn.Module):
    """``y = x @ weight + bias``, weight [in, out] drawn XavierNormal, bias
    zeros (or None with ``bias=False``)."""

    def __init__(self, in_features, out_features, bias=True, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        shape = (in_features, out_features)
        self.weight = _param(_normal(shape, _xavier_std(shape), generator),
                             device, dtype)
        self.bias = (_param(torch.zeros(out_features), device, dtype)
                     if bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` axes through the
    gated `nn.functional.layer_norm`; weight ones, bias zeros."""

    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = _param(torch.ones(self.normalized_shape), device, dtype)
        self.bias = _param(torch.zeros(self.normalized_shape), device, dtype)

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)


class Embedding(nn.Module):
    """Rows of ``weight`` [num_embeddings, embedding_dim] by index, drawn
    normal with std ``std`` (default XavierNormal's)."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=torch.float32, generator=None, std=None):
        super().__init__()
        shape = (num_embeddings, embedding_dim)
        std = _xavier_std(shape) if std is None else std
        self.weight = _param(_normal(shape, std, generator), device, dtype)

    def forward(self, ids):
        return embedding(ids, self.weight)


class Dropout(nn.Module):
    """`nn.functional.dropout` with this layer's ``p``, ``axis`` and
    ``mode``, in training mode only (``self.training``); draws from
    ``generator``, else the default generator of the input's device."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"
