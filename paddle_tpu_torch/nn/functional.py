"""Array-level functional ops — the counterparts of
`paddle_tpu/nn/functional/__init__.py` that the serving and training
paths need."""
from __future__ import annotations

import math
import os

import torch

from ..ops.fused_mlp import fused_layernorm_arrays, ln_geometry_ok

__all__ = ["linear", "layer_norm", "layer_norm_arrays", "fused_ln_applies",
           "cross_entropy"]


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with weight shaped [in, out] (the Paddle
    convention, `nn/functional/__init__.py:245-250`)."""
    y = x @ weight
    return y if bias is None else y + bias


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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes — the
    counterpart of `paddle_tpu.nn.functional.layer_norm`: the fused kernels
    (`fused_layernorm_arrays`, differentiable) where `fused_ln_applies`,
    else `layer_norm_arrays`."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    n_axes = len(normalized_shape)
    if fused_ln_applies(math.prod(x.shape[:-1]), x.shape[-1], weight, bias,
                        n_axes):
        return fused_layernorm_arrays(x, weight, bias, eps=epsilon)
    return layer_norm_arrays(x, weight, bias, epsilon,
                             tuple(range(-n_axes, 0)))


def cross_entropy(logits, labels, ignore_index=-100, reduction="mean"):
    """Hard-label softmax cross entropy over the last axis, in fp32 — the
    hard-label branch of `paddle_tpu.nn.functional.cross_entropy`:
    ``logsumexp(float(logits)) - float(logits[label])``, the label clipped
    into range for the gather, and 0 where the label is ``ignore_index``.
    ``reduction="none"`` returns the per-position loss, ``"mean"`` its sum
    over the count of valid labels (at least 1).  No fp32 log-prob tensor
    is formed beyond what `torch.logsumexp` needs."""
    if reduction not in ("none", "mean"):
        raise ValueError(f"reduction must be 'none' or 'mean', got "
                         f"{reduction!r}")
    lbl = torch.as_tensor(labels, device=logits.device).long()
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(-1)
    clipped = lbl.clamp(0, logits.shape[-1] - 1)
    picked = logits.gather(-1, clipped.unsqueeze(-1)).squeeze(-1).float()
    nll = torch.logsumexp(logits.float(), dim=-1) - picked
    valid = lbl != ignore_index
    loss = torch.where(valid, nll, torch.zeros((), device=nll.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    return loss
