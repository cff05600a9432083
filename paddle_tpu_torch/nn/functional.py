"""Functional ops — the counterparts of
`paddle_tpu/nn/functional/__init__.py` (and of the Tensor-level
`pallas_ops.flash_attention`) that the port's layers and models call.

Every op casts its inputs first with `amp.cast_inputs` under the name the
JAX package dispatches it by (``linear``, ``layer_norm``, ``softmax``,
``relu``, ``dropout``, ``flash_attention``, ...), as the JAX dispatch
layer does, so the AMP lists and O2 treat each op alike in both packages;
outside `amp.auto_cast` that is a no-op.

Dropout keeps an element where ``jax.random.bernoulli(next_key(), 1 - p,
shape)`` draws True, on a key split off the `core.random` key stack, one
key a call, in JAX's order (`ops.threefry.bernoulli`: the kernel
``csrc/threefry_bernoulli.cu`` on the card, `core.random.bernoulli` on the
CPU, bit for bit the same), so one
`paddle_tpu_torch.seed` gives the JAX package's masks bit for bit
(`_keep_mask`; `recompute` puts the stack back for its second run).  An
explicit ``generator`` (keyword-only) draws from that `torch.Generator`
instead.

`flash_attention` (``scaled_dot_product_attention``) keeps JAX's head-dim
gate (`pallas_ops.py:646-648`): a head_dim that is neither 64, 128 nor a
multiple of 128 runs the plain `mha_reference`, on every device, and
counts ``attn_fallback:head_dim`` under ``PTPU_ATTN_DEBUG=1``
(`ops.flash_attention.attention_path_counts`); any other head_dim goes to
the kernels (D = 384, 512, ... to those of ``csrc/flash_wide_fwd.cu`` and
``csrc/flash_wide_bwd.cu``).  A kernel that fails to build or launch is
never replaced by the plain version.

The conv path (`conv1d` .. `conv3d_transpose`, the pools, `batch_norm`)
has no kernel of the port's own: JAX computes it outside any Pallas
kernel (``lax.conv_general_dilated``, ``reduce_window``, jnp), and the
port with cuDNN's convolutions and torch's pools and elementwise ops, in
JAX's arithmetic:

- float32 convolutions run at float32, forward and backward, whatever
  ``torch.backends.cudnn.allow_tf32`` says (torch's default, True, runs
  them in TF32): `_Convolution` clears the flag around each call and
  puts it back;
- a channel-last input (``NHWC``, ``NLC``, ``NDHWC``) is permuted to a
  channels-first view, which for a contiguous input is a
  ``channels_last`` tensor that cuDNN and the pools take as it is, and
  the output is permuted back: no copy of the activation around a call;
- padding takes every Paddle form (`_conv_padding`: an int, one int a
  dimension, the flat ``[lo0, hi0, lo1, hi1, ...]``, pairs, ``"SAME"`` /
  ``"VALID"``), resolved to XLA's pairs (``"SAME"`` puts the odd pixel
  on the high side; torch's ``padding="same"`` refuses strides), unequal
  pairs padded explicitly;
- pooling keeps Paddle's ceil windows that start inside the right
  padding (`_ceil_extra`), ``exclusive`` divisors and the clipped
  divisor of an inclusive ceil window; max pooling pads with -inf;
- `batch_norm` normalises in float32, casts to x's dtype, then applies
  weight and bias in that dtype (two roundings in bf16, as JAX), and
  updates the running statistics as Paddle does: ``m * running + (1 -
  m) * batch`` with the biased batch variance, in float32, cast to the
  buffer's dtype (torch's ``F.batch_norm`` would weigh them the other
  way round and take the unbiased variance)."""
from __future__ import annotations

import math
import os

import torch

from ..amp import cast_inputs
from ..core import random as _random
from ..ops.flash_attention import (count_path, flash_attention_arrays,
                                   head_dim_ok, mha_reference)
from ..ops import threefry
from ..ops.fused_mlp import fused_layernorm_arrays, ln_geometry_ok

__all__ = ["linear", "layer_norm", "layer_norm_arrays", "fused_ln_applies",
           "rms_norm", "cross_entropy", "softmax", "log_softmax",
           "embedding", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "flash_attention", "scaled_dot_product_attention", "relu",
           "relu6", "sigmoid", "tanh", "silu", "gelu", "conv1d", "conv2d",
           "conv3d", "conv1d_transpose", "conv2d_transpose",
           "conv3d_transpose", "max_pool1d", "max_pool2d", "max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool2d", "batch_norm"]


def _unary(fn, op_name):
    """The op ``op_name``: ``fn`` of x cast by `amp.cast_inputs`; its
    ``name`` is accepted and unused, as in JAX."""
    def op(x, name=None):
        (x,) = cast_inputs(op_name, x)
        return fn(x)

    op.__name__ = op_name
    return op


relu = _unary(torch.relu, "relu")
relu6 = _unary(lambda a: torch.clamp(a, 0, 6), "relu6")
sigmoid = _unary(torch.sigmoid, "sigmoid")
tanh = _unary(torch.tanh, "tanh")
silu = _unary(torch.nn.functional.silu, "silu")


def gelu(x, approximate=False, name=None):
    """``jax.nn.gelu``: exact (erf) unless ``approximate`` (tanh)."""
    (x,) = cast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def log_softmax(x, axis=-1, dtype=None, name=None):
    """Log-softmax over ``axis``, first cast to ``dtype`` when given."""
    (x,) = cast_inputs("log_softmax", x)
    if dtype is not None:
        x = x.to(dtype)
    return torch.log_softmax(x, dim=axis)


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
    """Bool keep mask of ``shape`` on ``device``: ``jax.random.bernoulli(
    next_key(), keep, shape)`` (`ops.threefry.bernoulli`: the kernel on the
    card, `core.random.bernoulli` on the CPU), or uniform draws of
    ``generator`` below ``keep`` where one is given."""
    if generator is not None:
        return torch.rand(shape, device=device, generator=generator) < keep
    return threefry.bernoulli(_random.next_key(), keep, shape, device)


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
    p`` and ``upscale_in_train`` returns x; p = 0 returns x.  The op
    ``dropout``; ``name`` is accepted and unused, as in JAX; ``generator``
    is keyword-only (module docstring)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            (x,) = cast_inputs("dropout", x)
            return x * (1.0 - p)
        return x
    (x,) = cast_inputs("dropout", x)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = _keep_mask(tuple(shape), 1.0 - p, x.device, generator)
    if mode == "upscale_in_train":
        return _drop(x, keep, p)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One decision per (sample, channel) of a 4-D input."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """One decision per (sample, channel) of a 5-D input."""
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=ax, training=training)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps SELU's mean and variance: a dropped element
    takes ``-alpha * scale``, then ``a * x + b`` (`nn/functional/
    __init__.py:922-941`); the op ``alpha_dropout``."""
    if not training or p == 0.0:
        return x
    (x,) = cast_inputs("alpha_dropout", x)
    keep = _keep_mask(tuple(x.shape), 1.0 - p, x.device)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    kept = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                           device=x.device))
    return (a_coef * kept + b_coef).to(x.dtype)


def flash_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                    is_causal=False, training=True, name=None,
                    segment_ids=None, *, generator=None):
    """The Tensor-level flash attention (`pallas_ops.flash_attention`,
    `pallas_ops.py:880-905`), [B, S, H, D]: the op ``flash_attention``
    over `flash_attention_arrays` (the kernels on the card), or
    `mha_reference` where JAX's head-dim gate sends it (module docstring);
    then, in training with ``dropout_p > 0``, dropout of its output:
    ``where(keep, out / (1 - p), 0)`` in out's dtype, after the kernel, as
    JAX applies it, the key drawn before the attention as JAX draws it.
    ``attn_mask``: bool (True attends) or additive, [Sq, Sk], [B, Sq, Sk],
    [Bm, Hm, Sq, Sk] or a key mask [Bm, Hm, 1, Sk] (`normalize_mask`)."""
    query, key, value = cast_inputs("flash_attention", query, key, value)
    keep = None
    if dropout_p > 0.0 and training:
        b, sq, h, d = query.shape
        keep = _keep_mask((b, sq, h, value.shape[-1]), 1.0 - dropout_p,
                          query.device, generator)
    if head_dim_ok(query.shape[-1]):          # JAX's gate, `:646-648`
        out = flash_attention_arrays(query, key, value, attn_mask,
                                     is_causal, segment_ids=segment_ids)
    else:
        count_path("attn_fallback:head_dim")
        out = mha_reference(query, key, value, attn_mask, is_causal,
                            segment_ids=segment_ids).to(query.dtype)
    if keep is not None:
        out = _drop(out, keep, dropout_p)
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """`nn/functional/__init__.py:1325-1337`: `flash_attention` in the
    layout [batch, seq, heads, head_dim]."""
    return flash_attention(query, key, value, attn_mask=attn_mask,
                           dropout_p=dropout_p, is_causal=is_causal,
                           training=training)


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


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """``(x * rsqrt(mean(x^2) + eps))`` over the last axis in fp32, cast
    back to x's dtype, times ``weight``; the op ``rms_norm``."""
    x, weight = cast_inputs("rms_norm", x, weight)
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = (x32 * torch.rsqrt(var + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


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


# ---------------------------------------------------------------------------
# conv / pool / batch norm (`nn/functional/__init__.py:253-810`)
# ---------------------------------------------------------------------------

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC")


def _tuplize(v, n):
    """An int or a sequence as an ``n``-tuple of ints (a 1-sequence
    repeated; any other length kept as it is)."""
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(i) for i in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(i) for i in v)
    return tuple(int(v) for _ in range(n))


def _conv_padding(padding, nd, kind="conv"):
    """A Paddle padding as ``nd`` (lo, hi) pairs, or ``"SAME"`` /
    ``"VALID"``.  A list of pairs of another length than ``nd`` (Paddle's
    form with the N and C pairs included, say) raises what JAX raises at
    the functional of ``kind``: ``"conv"`` a TypeError (a ValueError for
    2 nd pairs, which JAX reads as 2 nd ints), ``"pool"`` a ValueError (a
    TypeError for 2 nd pairs); a ``"transpose"`` takes the first nd of
    more pairs (a TypeError for 2 nd) and raises an IndexError for fewer,
    as JAX's does."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        if len(padding) == nd:
            return [(p, p) for p in padding]
        if len(padding) == 2 * nd:
            return [(padding[2 * i], padding[2 * i + 1]) for i in range(nd)]
    elif all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(p) for p in padding]
        n = len(pairs)
        if n == nd or (kind == "transpose" and nd < n != 2 * nd):
            return pairs[:nd]
        if kind == "transpose" and n < nd:
            raise IndexError(f"{n} padding pairs for a {nd}-D transposed "
                             f"convolution")
        if (n == 2 * nd) == (kind == "conv"):
            raise ValueError(f"padding of a {nd}-D {kind} must be {nd} "
                             f"(low, high) pairs, got {n}")
        if kind == "conv":
            raise TypeError(f"Wrong number of explicit pads for "
                            f"convolution: expected {nd}, got {n}.")
        raise TypeError(f"padding of a {nd}-D {kind} must be {nd} (low, "
                        f"high) pairs, got {n}")
    raise ValueError(f"bad padding {padding}")


def _window_outs(spatial, windows, strides, pads):
    """Outputs along each axis of windows over ``spatial`` padded by
    ``pads`` (0 where the window is larger than the padded input)."""
    return [max((n + lo + hi - k) // s + 1, 0) for n, k, s, (lo, hi)
            in zip(spatial, windows, strides, pads)]


def _empty_like_windows(xc, channels, outs, *others):
    """JAX's empty output [N, channels, *outs] (some out 0) of a window
    larger than its padded input, where torch raises; in the autograd
    graph of ``xc`` and ``others`` (their gradients zeros)."""
    shape = (xc.shape[0], channels, *outs)
    link = sum((t.sum() for t in (xc, *others)), xc.new_zeros(()))
    return torch.zeros(shape, dtype=xc.dtype, device=xc.device) + link * 0


def _same_pads(sizes, windows, strides):
    """XLA's ``"SAME"``: ``ceil(n / s)`` outputs, the odd pixel of the
    total padding on the high side."""
    pads = []
    for n, k, s in zip(sizes, windows, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _flat_pads(pads):
    """(lo, hi) pairs of the leading spatial axes as `F.pad` takes them
    (last axis first)."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channels_first(x, data_format):
    """x as channels-first: a channel-last input permuted (a view)."""
    if data_format in _CHANNEL_LAST:
        return x.movedim(-1, 1)
    return x


def _restore(y, data_format):
    return y.movedim(1, -1) if data_format in _CHANNEL_LAST else y


class _Fp32Convs:
    """cuDNN's TF32 switch off while a float32 CUDA convolution runs."""

    def __init__(self, x):
        self.on = x.dtype == torch.float32 and x.is_cuda

    def __enter__(self):
        if self.on:
            self.prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        if self.on:
            torch.backends.cudnn.allow_tf32 = self.prev


class _Convolution(torch.autograd.Function):
    """``torch.convolution`` and its backward (``aten.convolution_backward``),
    each under `_Fp32Convs`: a float32 convolution runs at float32 in both
    directions, whatever the global cuDNN flags (the backward runs on
    autograd's thread, long after a flag set around the forward is
    back)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, groups)
        zeros = [0] * len(stride)
        with _Fp32Convs(x):
            return torch.convolution(x, w, None, stride, padding, dilation,
                                     transposed, zeros, groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, groups = ctx.conf
        with _Fp32Convs(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, dilation, transposed,
                [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, nd,
             data_format, transpose=False, output_padding=0):
    """`nn/functional/__init__.py:280-358`: the convolution of x by
    ``weight`` ([out, in/groups, *k]; a transpose [in, out/groups, *k])
    with Paddle's padding, strides and dilation, plus ``bias`` after it in
    the output's dtype (promoted as JAX adds it); the op ``conv{nd}d`` or
    ``conv{nd}d_transpose``.  A float input meeting float weights of
    another dtype is cast to theirs.

    A transpose runs unpadded and is cropped (or extended) to JAX's
    output: XLA's lhs-dilated convolution with pads ``(k_eff - 1 - lo,
    k_eff - 1 - hi + output_padding)``; a string padding raises there,
    as ``lax`` raises."""
    name = f"conv{nd}d{'_transpose' if transpose else ''}"
    if bias is None:
        x, weight = cast_inputs(name, x, weight)
    else:
        x, weight, bias = cast_inputs(name, x, weight, bias)
    if x.dtype != weight.dtype and weight.is_floating_point():
        x = x.to(weight.dtype)
    strides = _tuplize(stride, nd)
    dils = _tuplize(dilation, nd)
    pad = _conv_padding(padding, nd, "transpose" if transpose else "conv")
    xc = _channels_first(x, data_format)
    if transpose:
        if isinstance(pad, str):
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        opad = _tuplize(output_padding, nd)
        out = _Convolution.apply(xc, weight, strides, [0] * nd, dils, True,
                                 groups)
        crop = [(lo, hi - op) for (lo, hi), op in zip(pad, opad)]
        if any(c for pair in crop for c in pair):
            out = torch.nn.functional.pad(
                out, [-c for c in _flat_pads(crop)])
    else:
        k_eff = [d * (k - 1) + 1 for d, k in zip(dils, weight.shape[2:])]
        if isinstance(pad, str):
            pad = (_same_pads(xc.shape[2:], k_eff, strides)
                   if pad == "SAME" else [(0, 0)] * nd)
        outs = _window_outs(xc.shape[2:], k_eff, strides, pad)
        if not all(outs):
            out = _empty_like_windows(xc, weight.shape[0], outs, weight)
        else:
            if any(lo != hi for lo, hi in pad):
                xc = torch.nn.functional.pad(xc, _flat_pads(pad))
                pad = [(0, 0)] * nd
            out = _Convolution.apply(xc, weight, strides,
                                     [lo for lo, _ in pad], dils, False,
                                     groups)
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return _restore(out, data_format)


def _fmt1d(data_format):
    return "NLC" if data_format == "NLC" else "NCL"


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    _fmt1d(data_format))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    _fmt1d(data_format), transpose=True,
                    output_padding=output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, transpose=True,
                    output_padding=output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, transpose=True,
                    output_padding=output_padding)


def _ceil_extra(size, k, s, lo, hi):
    """Extra high-side padding so that the output size is the ceil
    division: Paddle keeps a window that starts inside the right padding
    (phi/kernels/funcs/pooling.h:368), torch's ``ceil_mode`` drops it."""
    floor_out = (size + lo + hi - k) // s + 1
    ceil_out = -((size + lo + hi - k) // -s) + 1
    return (ceil_out - floor_out) * s


def _pool_pads(spatial, ks, st, padding, nd, ceil_mode):
    """(pads with the ceil extra, pads without it) as (lo, hi) pairs."""
    pad = _conv_padding(padding, nd, "pool")
    if isinstance(pad, str):
        pad = ([(0, 0)] * nd if pad == "VALID"
               else _same_pads(spatial, ks, st))
    base = list(pad)
    if ceil_mode:
        pad = [(lo, hi + _ceil_extra(spatial[i], ks[i], st[i], lo, hi))
               for i, (lo, hi) in enumerate(pad)]
    return pad, base


_MAX_POOL = {1: torch.nn.functional.max_pool1d,
             2: torch.nn.functional.max_pool2d,
             3: torch.nn.functional.max_pool3d}


def _max_pool_cf(xc, ks, st, pads, return_mask=False):
    """Max over windows of channels-first ``xc`` padded by ``pads`` with
    -inf (torch's own padding where it is equal and at most k // 2, else
    `F.pad`); with ``return_mask`` (2-D) also the flat H * W index of each
    window's first maximum in the input, int32, clipped into it as JAX's
    `_max_pool_mask` (a window wholly in the padding points at its first
    in-range cell)."""
    pool = _MAX_POOL[len(ks)]
    outs = _window_outs(xc.shape[2:], ks, st, pads)
    if not all(outs):
        out = _empty_like_windows(xc, xc.shape[1], outs)
        if not return_mask:
            return out
        return out, torch.zeros(out.shape, dtype=torch.int32,
                                device=xc.device)
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, ks)):
        out = pool(xc, ks, st, [lo for lo, _ in pads],
                   return_indices=return_mask)
        if not return_mask:
            return out
        out, idx = out
        return out, idx.to(torch.int32)
    fill = (-math.inf if xc.is_floating_point()
            else torch.iinfo(xc.dtype).min)
    xp = torch.nn.functional.pad(xc, _flat_pads(pads), value=fill)
    out = pool(xp, ks, st, 0, return_indices=return_mask)
    if not return_mask:
        return out
    out, idx = out
    h, w = xc.shape[-2:]
    gi = (idx // xp.shape[-1] - pads[0][0]).clamp(0, h - 1)
    gj = (idx % xp.shape[-1] - pads[1][0]).clamp(0, w - 1)
    return out, (gi * w + gj).to(torch.int32)


def _window_sums(xc, ks, st, pads):
    """Sums over windows of ``xc`` padded by ``pads`` with zeros."""
    outs = _window_outs(xc.shape[2:], ks, st, pads)
    if not all(outs):
        return _empty_like_windows(xc, xc.shape[1], outs)
    if any(p for pair in pads for p in pair):
        xc = torch.nn.functional.pad(xc, _flat_pads(pads))
    if len(ks) == 1:
        return torch.nn.functional.avg_pool2d(
            xc.unsqueeze(-2), (1, ks[0]), (1, st[0]),
            divisor_override=1).squeeze(-2)
    pool = (torch.nn.functional.avg_pool2d if len(ks) == 2
            else torch.nn.functional.avg_pool3d)
    return pool(xc, ks, st, divisor_override=1)


def _avg_divisor(spatial, ks, st, pads, base, exclusive, dtype, device):
    """The divisor of each window, broadcast over [1, 1, *out]: with
    ``exclusive`` the count of input cells in it (at least 1), in x's
    dtype; else the window clipped to the input plus its original high
    pad, left padding counted (reference pooling.cc:84), float32 as JAX's
    (at least 1)."""
    div = None
    nd = len(ks)
    for i in range(nd):
        lo, hi = pads[i]
        out_i = max((spatial[i] + lo + hi - ks[i]) // st[i] + 1, 0)
        starts = torch.arange(out_i, dtype=torch.float64) * st[i] - lo
        ends = starts + ks[i]
        if exclusive:
            ext = (ends.clamp(max=spatial[i]) - starts.clamp(min=0)).clamp(
                min=0)
        else:
            ext = (ends.clamp(max=spatial[i] + base[i][1]) - starts).clamp(
                min=1)
        shape = [1] * (nd + 2)
        shape[2 + i] = out_i
        ext = ext.reshape(shape)
        div = ext if div is None else div * ext
    if exclusive:
        return div.clamp(min=1).to(device=device, dtype=dtype)
    return div.to(device=device, dtype=torch.float32)


def _pool_nd(x, kernel, stride, padding, nd, op, data_format,
             ceil_mode=False, exclusive=True):
    """`nn/functional/__init__.py:387-460`: ``op`` ``"max"``, ``"avg"`` or
    ``"sum"`` over windows (stride defaults to the window); the op
    ``{op}_pool{nd}d``."""
    (x,) = cast_inputs(f"{op}_pool{nd}d", x)
    ks = _tuplize(kernel, nd)
    st = _tuplize(stride if stride is not None else kernel, nd)
    xc = _channels_first(x, data_format)
    spatial = tuple(xc.shape[2:])
    pads, base = _pool_pads(spatial, ks, st, padding, nd, ceil_mode)
    if op == "max":
        return _restore(_max_pool_cf(xc, ks, st, pads), data_format)
    s = _window_sums(xc, ks, st, pads)
    if op == "sum":
        out = s
    elif not exclusive and not ceil_mode:
        out = s / float(math.prod(ks))
    else:
        out = s / _avg_divisor(spatial, ks, st, pads, base, exclusive,
                               s.dtype, s.device)
    return _restore(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL", name=None):
    """``return_mask`` is accepted and unused, as in JAX."""
    return _pool_nd(x, kernel_size, stride, padding, 1, "max",
                    _fmt1d(data_format), ceil_mode=ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """With ``return_mask`` also the flat H * W index of each window's
    maximum (`_max_pool_cf`); for a string padding JAX takes the mask's
    windows unpadded, and so does the port."""
    out = _pool_nd(x, kernel_size, stride, padding, 2, "max", data_format,
                   ceil_mode=ceil_mode)
    if not return_mask:
        return out
    ks = _tuplize(kernel_size, 2)
    st = _tuplize(stride if stride is not None else kernel_size, 2)
    pad = _conv_padding(padding, 2, "pool")
    if isinstance(pad, str):
        pad = [(0, 0), (0, 0)]
    xc = _channels_first(x, data_format)
    if ceil_mode:
        pad = [(lo, hi + _ceil_extra(xc.shape[2 + i], ks[i], st[i], lo, hi))
               for i, (lo, hi) in enumerate(pad)]
    with torch.no_grad():
        _, mask = _max_pool_cf(xc, ks, st, pad, return_mask=True)
    return out, _restore(mask, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    """``return_mask`` is accepted and unused, as in JAX."""
    return _pool_nd(x, kernel_size, stride, padding, 3, "max", data_format,
                    ceil_mode=ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, "avg",
                    _fmt1d(data_format), ceil_mode=ceil_mode,
                    exclusive=exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """With ``divisor_override`` the window sums times ``1 /
    divisor_override``."""
    if divisor_override:
        s = _pool_nd(x, kernel_size, stride, padding, 2, "sum", data_format,
                     ceil_mode=ceil_mode)
        return s * (1.0 / float(divisor_override))
    return _pool_nd(x, kernel_size, stride, padding, 2, "avg", data_format,
                    ceil_mode=ceil_mode, exclusive=exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """``divisor_override`` is accepted and unused, as in JAX."""
    return _pool_nd(x, kernel_size, stride, padding, 3, "avg", data_format,
                    ceil_mode=ceil_mode, exclusive=exclusive)


_ADAPTIVE_AVG = {1: torch.nn.functional.adaptive_avg_pool1d,
                 2: torch.nn.functional.adaptive_avg_pool2d,
                 3: torch.nn.functional.adaptive_avg_pool3d}


def _adaptive_avg(x, output_size, nd, data_format):
    """Means over the bins ``[floor(j n / o), ceil((j + 1) n / o))`` of
    each spatial axis (`_adaptive_pool_core`); the op
    ``adaptive_avg_pool{nd}d``."""
    (x,) = cast_inputs(f"adaptive_avg_pool{nd}d", x)
    out = _ADAPTIVE_AVG[nd](_channels_first(x, data_format),
                            _tuplize(output_size, nd))
    return _restore(out, data_format)


def adaptive_avg_pool1d(x, output_size, data_format="NCL", name=None):
    return _adaptive_avg(x, output_size, 1, _fmt1d(data_format))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg(x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg(x, output_size, 3, data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False,
                        data_format="NCHW", name=None):
    """Maxima over the adaptive bins; with ``return_mask`` also the flat
    H * W index of each bin's first maximum, int32; the op
    ``adaptive_max_pool2d``."""
    (x,) = cast_inputs("adaptive_max_pool2d", x)
    out = torch.nn.functional.adaptive_max_pool2d(
        _channels_first(x, data_format), _tuplize(output_size, 2),
        return_indices=return_mask)
    if not return_mask:
        return _restore(out, data_format)
    out, idx = out
    return (_restore(out, data_format),
            _restore(idx.to(torch.int32), data_format))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """`nn/functional/__init__.py:734-810`, over every axis but the
    channel's (the last for ``NHWC`` / ``NLC`` / ``NDHWC``, else axis 1);
    the op ``batch_norm`` (module docstring).  In training, unless
    ``use_global_stats``, the batch's float32 mean and biased variance
    normalise x (gradients flow through them) and update
    ``running_mean`` / ``running_var`` in place; otherwise the running
    statistics normalise it."""
    ch = x.dim() - 1 if data_format in _CHANNEL_LAST else 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    if training and not use_global_stats:
        x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
        xf = x.float()
        var, mu = torch.var_mean(
            xf, dim=[i for i in range(x.dim()) if i != ch], correction=0)
        out = ((xf - mu.reshape(shape)) * torch.rsqrt(var.reshape(shape)
                                                      + epsilon))
        with torch.no_grad():
            for buf, stat in ((running_mean, mu), (running_var, var)):
                buf.copy_((momentum * buf.float()
                           + (1 - momentum) * stat).to(buf.dtype))
    else:
        x, running_mean, running_var, weight, bias = cast_inputs(
            "batch_norm", x, running_mean, running_var, weight, bias)
        out = ((x.float() - running_mean.float().reshape(shape))
               * torch.rsqrt(running_var.float().reshape(shape) + epsilon))
    out = out.to(x.dtype)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out
