"""Weight-only quantized inference: swap `nn.Linear` for `WeightOnlyLinear`
— the port of `paddle_tpu/lowbit/weight_only.py`.

Weights are stored as int8 codes (or int4, two to a byte) with
per-channel float32 scales, and the product dequantizes with fp32
accumulation (`ops.lowbit.quantized_matmul_arrays`).  Activations stay in
the model's dtype.  Inference only: no gradient reaches the codes.

`quantize_for_inference` deep-copies the model unless ``inplace``; a
`GPTForCausalLM` copy starts without the original's captured decode
steps (their CUDA graphs hold the original's buffers), so the copy
captures its own and the original keeps generating.  On the stacked GPT
layout it swaps nothing, as in the JAX package: that layout holds raw
stacked weights, not `Linear` layers.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from .. import monitor
from ..amp import cast_inputs
from ..device import resolve_device
from ..nn.layer import Linear
from ..ops.lowbit import (pack_int4_arrays, qmax_for_bits,
                          quantize_absmax_arrays, quantize_with_scale_arrays,
                          quantized_bytes, quantized_matmul_arrays)

__all__ = ["WeightOnlyLinear", "quantize_for_inference"]

_BITS = {"int8": 8, "int4": 4}


def _check_dtype(weight_dtype):
    if weight_dtype not in _BITS:
        raise ValueError(
            f"weight_dtype must be one of {sorted(_BITS)}, got "
            f"{weight_dtype!r}")


class WeightOnlyLinear(nn.Module):
    """Inference-only Linear over packed low-bit weights.

    Buffers (so ``state_dict`` carries them, under the JAX package's
    names and dtypes): ``qweight``, int8 [in, out] codes or uint8
    [ceil(in/2), out] packed nibbles for int4; ``scale``, float32 [out]
    per channel (or a scalar per tensor).  ``bias`` is the original
    layer's bias parameter.  Forward: ``(x @ q) * scale + b`` with fp32
    accumulation, dispatched under the op name ``weight_only_linear``
    (`amp.cast_inputs`).  ``device`` (keyword-only) places the empty
    buffers; `from_linear` puts them on the layer's device."""

    def __init__(self, in_features, out_features, weight_dtype="int8",
                 per_channel=True, *, device=None):
        super().__init__()
        _check_dtype(weight_dtype)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.weight_dtype = weight_dtype
        self.bits = _BITS[weight_dtype]
        self.per_channel = bool(per_channel)
        dev = resolve_device(device)
        rows = ((self.in_features + 1) // 2 if self.bits == 4
                else self.in_features)
        cdtype = torch.uint8 if self.bits == 4 else torch.int8
        self.register_buffer("qweight", torch.zeros(
            (rows, self.out_features), dtype=cdtype, device=dev))
        scale_shape = (self.out_features,) if per_channel else ()
        self.register_buffer("scale", torch.zeros(
            scale_shape, dtype=torch.float32, device=dev))
        self.register_parameter("bias", None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, layer, weight_dtype="int8", per_channel=True,
                    scale=None):
        """Quantize a linear-shaped layer's live weight (an [in, out]
        ``weight`` and an optional ``bias``).  ``scale`` overrides the
        abs-max scale (already in dequant-ready ``absmax / qmax`` form)."""
        w = layer.weight.detach()
        in_features, out_features = w.shape
        m = cls(in_features, out_features, weight_dtype=weight_dtype,
                per_channel=per_channel, device=w.device)
        if scale is not None:
            s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
            q = quantize_with_scale_arrays(w, s, qmax_for_bits(m.bits))
        else:
            q, s = quantize_absmax_arrays(w, bits=m.bits,
                                          axis=0 if per_channel else None)
        if m.bits == 4:
            q = pack_int4_arrays(q)
        m.qweight = q
        m.scale = torch.broadcast_to(
            s, m.scale.shape if m.per_channel else ()).float().contiguous()
        if layer.bias is not None:
            m.bias = layer.bias
        return m

    def forward(self, x):
        if self.bias is not None:
            x, q, s, b = cast_inputs("weight_only_linear", x, self.qweight,
                                     self.scale, self.bias)
            return quantized_matmul_arrays(
                x, q, s, bits=self.bits, in_features=self.in_features) + b
        x, q, s = cast_inputs("weight_only_linear", x, self.qweight,
                              self.scale)
        return quantized_matmul_arrays(x, q, s, bits=self.bits,
                                       in_features=self.in_features)

    # -- accounting ---------------------------------------------------------

    @property
    def packed_bytes(self) -> int:
        return quantized_bytes((self.in_features, self.out_features),
                               self.bits, self.scale.numel())

    @property
    def dense_bytes(self) -> int:
        """The fp32 bytes of the weight (4 an element whatever the
        model's dtype, as the JAX package counts them)."""
        return self.in_features * self.out_features * 4

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, "
                f"weight_dtype={self.weight_dtype}, "
                f"per_channel={self.per_channel}")


def quantize_for_inference(model, weight_dtype="int8", per_channel=True,
                           inplace=False):
    """Swap every `nn.Linear` in ``model`` for a `WeightOnlyLinear` holding
    packed low-bit codes of its current weight.  Returns the model (a deep
    copy unless ``inplace``) in eval mode.  Emits
    ``lowbit/bytes_saved{wing=weights}`` (fp32 bytes less packed bytes)
    and ``lowbit/weight_layers``."""
    _check_dtype(weight_dtype)
    if not inplace:
        model = copy.deepcopy(model)
    saved = swapped = 0

    def _swap(layer):
        nonlocal saved, swapped
        for name, sub in list(layer.named_children()):
            if isinstance(sub, Linear):
                wol = WeightOnlyLinear.from_linear(
                    sub, weight_dtype=weight_dtype, per_channel=per_channel)
                setattr(layer, name, wol)
                saved += wol.dense_bytes - wol.packed_bytes
                swapped += 1
            else:
                _swap(sub)

    _swap(model)
    if monitor.enabled():
        monitor.counter("lowbit/bytes_saved",
                        "storage bytes removed by low-bit packing").labels(
            wing="weights").add(saved)
        monitor.counter("lowbit/weight_layers",
                        "Linears swapped to WeightOnlyLinear").add(swapped)
    model.eval()
    return model
