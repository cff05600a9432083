"""Functional ops — the counterparts of
`paddle_tpu/nn/functional/__init__.py` (and of the Tensor-level
`pallas_ops.flash_attention`) that the serving and training paths need.

The ops that the JAX package dispatches under a name its AMP lists or
`cast_plan` decide on (``linear``, ``layer_norm``, ``cross_entropy``,
``softmax``, ``embedding``, ``flash_attention``) cast their inputs first
with `amp.cast_inputs` under that name, as the JAX dispatch layer does;
outside `amp.auto_cast` that is a no-op.

Dropout keeps an element where a uniform draw in [0, 1) falls below
``1 - p`` (JAX's ``bernoulli(key, 1 - p)``); the draws come from the
``generator`` given, else from the default `torch.Generator` of the
tensor's device (`_keep_mask`), which `recompute` preserves."""
from __future__ import annotations

import math
import os

import torch

from ..amp import cast_inputs
from ..ops.flash_attention import flash_attention_arrays
from ..ops.fused_mlp import fused_layernorm_arrays, ln_geometry_ok

__all__ = ["linear", "layer_norm", "layer_norm_arrays", "fused_ln_applies",
           "cross_entropy", "softmax", "embedding", "dropout",
           "flash_attention"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with weight shaped [in, out] (the Paddle
    convention, `nn/functional/__init__.py:245-250`); the op ``linear``."""
    if bias is None:
        x, weight = cast_inputs("linear", x, weight)
        return x @ weight
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return x @ weight + bias


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``, first cast to ``dtype`` when given; the op
    ``softmax``.  ``name`` is accepted and unused, as in JAX."""
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by the ids ``x`` (zeros at ``padding_idx``); the
    op ``embedding``.  ``sparse`` and ``name`` are accepted and unused, as
    in JAX."""
    (weight,) = cast_inputs("embedding", weight)
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def _keep_mask(shape, keep, device, generator=None):
    """Bool keep mask of ``shape``: uniform draws in [0, 1) below
    ``keep``, from ``generator`` or the default generator of ``device``."""
    return torch.rand(shape, device=device, generator=generator) < keep


def _drop(x, keep_mask, p):
    """``where(keep, x / (1 - p), 0)`` in x's dtype."""
    return torch.where(keep_mask, x / (1.0 - p),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """`nn/functional/__init__.py:892-909`: in training, ``upscale_in_train``
    keeps an element with probability ``1 - p`` and divides it by ``1 -
    p``, ``downscale_in_infer`` keeps it as it is; ``axis`` (an int or a
    list) draws one decision per index of those axes, shared along the
    others.  Outside training ``downscale_in_infer`` multiplies by ``1 -
    p`` and ``upscale_in_train`` returns x; p = 0 returns x.  ``name`` is
    accepted and unused, as in JAX; ``generator`` is keyword-only."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return x * (1.0 - p)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = _keep_mask(tuple(shape), 1.0 - p, x.device, generator)
    if mode == "upscale_in_train":
        return _drop(x, keep, p)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def flash_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                    is_causal=False, training=True, segment_ids=None,
                    generator=None):
    """The Tensor-level flash attention (`pallas_ops.flash_attention`,
    `pallas_ops.py:880-905`): the op ``flash_attention`` over
    `flash_attention_arrays` (the kernels on the card), then, in training
    with ``dropout_p > 0``, dropout of its output: ``where(keep, out / (1 -
    p), 0)`` in out's dtype, after the kernel, as JAX applies it."""
    query, key, value = cast_inputs("flash_attention", query, key, value)
    out = flash_attention_arrays(query, key, value, attn_mask, is_causal,
                                 segment_ids=segment_ids)
    if dropout_p > 0.0 and training:
        out = _drop(out, _keep_mask(out.shape, 1.0 - dropout_p, out.device,
                                    generator), dropout_p)
    return out


def layer_norm_arrays(a, w, b, epsilon=1e-5, naxes=(-1,)):
    """LayerNorm over ``naxes`` with fp32 statistics — the arithmetic of
    `paddle_tpu.nn.functional.layer_norm_arrays` (mean, biased variance,
    ``(a - mu) * rsqrt(var + eps)`` cast back to a's dtype, then ``* w``
    and ``+ b``).  Not the block's `_stacked_ln`, which orders its
    operations differently."""
    a32 = a.float()
    mu = a32.mean(naxes, keepdim=True)
    var = a32.var(naxes, unbiased=False, keepdim=True)
    out = ((a32 - mu) * torch.rsqrt(var + epsilon)).to(a.dtype)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def fused_ln_applies(n_rows, h, weight, bias, n_axes=1):
    """The gate of `layer_norm` (`nn/functional/__init__.py:684-693`):
    one normalised axis, weight and bias given, ``PTPU_PALLAS_LN == "1"``
    and `ln_geometry_ok` for ``n_rows`` rows of width ``h``."""
    return (n_axes == 1 and weight is not None and bias is not None
            and os.environ.get("PTPU_PALLAS_LN") == "1"
            and ln_geometry_ok(n_rows, h))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes — the
    counterpart of `paddle_tpu.nn.functional.layer_norm`: the fused kernels
    (`fused_layernorm_arrays`, differentiable) where `fused_ln_applies`,
    else `layer_norm_arrays`; the op ``layer_norm``.  ``name`` is accepted
    and unused, as in JAX."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    n_axes = len(normalized_shape)
    if fused_ln_applies(math.prod(x.shape[:-1]), x.shape[-1], weight, bias,
                        n_axes):
        return fused_layernorm_arrays(x, weight, bias, eps=epsilon)
    return layer_norm_arrays(x, weight, bias, epsilon,
                             tuple(range(-n_axes, 0)))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross entropy over ``axis`` in fp32 — the arithmetic of
    `paddle_tpu.nn.functional.cross_entropy` (`nn/functional/__init__.py:
    975-1043`), in its argument order; the op ``cross_entropy`` (``input``
    and ``weight`` cast by `amp.cast_inputs`).

    Hard labels: ``logsumexp(float(input)) - float(input[label])``, the
    label clipped into range for the gather (no fp32 log-prob tensor
    beyond what `torch.logsumexp` needs); with ``label_smoothing`` ε,
    ``(1 - ε) nll + ε (lse - mean(input))``; with ``use_softmax=False``
    ``input`` holds probabilities: ``-log(max(p[label], 1e-30))`` and the
    smoothing term ``-mean(log(max(p, 1e-30)))``.  0 where the label is
    ``ignore_index``; times ``weight[label]`` with class weights.
    ``"mean"`` divides the sum by the count of valid labels (at least 1),
    or with ``weight`` by the sum of the valid labels' weights.

    Soft labels: ``-sum(label * log_softmax(input))`` over ``axis`` (or
    of ``log(max(input, 1e-30))`` without softmax); ``weight`` and
    ``ignore_index`` do not apply, ``"mean"`` is the plain mean.
    ``reduction`` ``"none"`` / ``"sum"`` as named."""
    if weight is None:
        (input,) = cast_inputs("cross_entropy", input)
    else:
        input, weight = cast_inputs("cross_entropy", input,
                                    torch.as_tensor(weight,
                                                    device=input.device))
    dim = axis % input.dim()
    if soft_label:
        if use_softmax:
            logp = torch.log_softmax(input.float(), dim=dim)
        else:
            logp = torch.log(input.float().clamp(min=1e-30))
        tgt = torch.as_tensor(label, device=input.device).float()
        return _reduce_loss(-(tgt * logp).sum(dim), reduction)
    lbl = torch.as_tensor(label, device=input.device).long()
    if lbl.dim() == input.dim():
        lbl = lbl.squeeze(dim)
    clipped = lbl.clamp(0, input.shape[dim] - 1)
    picked = input.gather(dim, clipped.unsqueeze(dim)).squeeze(dim).float()
    if use_softmax:
        lse = torch.logsumexp(input.float(), dim=dim)
        nll = lse - picked
        if label_smoothing > 0.0:
            smooth = lse - input.float().mean(dim)
            nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    else:
        nll = -torch.log(picked.clamp(min=1e-30))
        if label_smoothing > 0.0:
            smooth = -torch.log(input.float().clamp(min=1e-30)).mean(dim)
            nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    valid = lbl != ignore_index
    loss = torch.where(valid, nll, torch.zeros((), device=nll.device))
    if weight is not None:
        wt = weight[clipped]
        loss = loss * wt
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, wt, torch.zeros((), dtype=wt.dtype,
                                                       device=wt.device)).sum()
        else:
            denom = valid.sum().float().clamp(min=1.0)
        return loss.sum() / denom
    return _reduce_loss(loss, reduction)


def _reduce_loss(loss, reduction):
    """``"mean"`` / ``"sum"`` over every element, anything else as is
    (`nn/functional/__init__.py:966-971`)."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
