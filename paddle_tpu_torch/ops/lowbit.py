"""Low-bit storage and compute primitives, array level — the port of
`paddle_tpu/ops/lowbit.py`, the op layer under `paddle_tpu_torch.lowbit`.
This module has no kernel of its own: the JAX package computes the
dequantizing product in XLA (``jnp.matmul`` with fp32 accumulation), and
so does the port, in plain PyTorch.

Conventions, as the JAX package's:

- **symmetric abs-max quantization**: ``q = clip(round(x / scale),
  -qmax, qmax)`` with ``scale = absmax / qmax``, so ``dequant(q) = q *
  scale``.  The scale is a true fp32 division, as eager JAX computes it
  (`quantize_absmax_arrays` runs eagerly in ``from_linear``), by a tensor
  on the data's device: torch multiplies by the reciprocal of a CPU
  scalar divisor on the card.  The KV-pool quantizer of
  `ops.paged_attention` forms its scale as ``amax * fl(1/127)`` instead,
  as the JAX engine's jitted programs do; the two are kept apart.
- **int4 packing**: two 4-bit codes per byte along the FIRST axis (the
  reduction axis of an [in, out] weight), low nibble = even row; odd
  first dims are zero-padded, and the unpack takes the true row count.
- **fp32 accumulation**: `quantized_matmul_arrays` forms ``x @ q`` from x
  and the codes in fp32, applies the per-output-channel scale in fp32
  after the contraction, then casts once to x's dtype.

Rounding of the product against the JAX package's.  Both sides convert x
and the codes to fp32 exactly (a bf16 or fp16 value and an integer code
of at most 7 bits are fp32 values), so every product term ``x_k q_k`` is
exact; the two differ only in the order of the fp32 sum over the K
inputs, by at most ``(K - 1) 2^-24`` of ``sum_k |x_k q_k|`` (a few
``sqrt(K) 2^-24`` for random signs), then by the same relative amount
after the scale (one fp32 multiply, the same on both sides).  In fp32
that is the limit; x bf16 adds one bf16 step of the output, 2^-8 of it
on each side where the fp32 values sit across a rounding boundary, so
``|out - ref| <= 2^-7 |ref| + K 2^-24 scale sum_k |x_k q_k|``.

Telemetry: ``lowbit/dequant_calls{site}`` counts the calls of
`dequantize_arrays` and `quantized_matmul_arrays` on eager forwards.  The
JAX package counts once per trace inside its compiled ``generate``; the
port counts nothing inside ``generate`` or a CUDA-graph capture
(`graphs.tracing`).
"""
from __future__ import annotations

import math

import torch

from .. import monitor
from ..graphs import tracing

__all__ = [
    "qmax_for_bits", "quantize_absmax_arrays", "quantize_with_scale_arrays",
    "dequantize_arrays", "pack_int4_arrays", "unpack_int4_arrays",
    "quantized_matmul_arrays", "quantized_bytes",
]


def qmax_for_bits(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"lowbit supports 4- and 8-bit codes, got {bits}")
    return 2 ** (bits - 1) - 1


def _count(name, **labels):
    """Eager-forward telemetry: ``name`` is a full ``subsystem/metric``
    literal at every call site; nothing is counted inside ``generate`` or
    a capture."""
    if monitor.enabled() and not tracing():
        c = monitor.counter(name)
        (c.labels(**labels) if labels else c).inc()


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def quantize_with_scale_arrays(x, scale, qmax):
    """``clip(round(x / scale), +-qmax)`` as int8 codes (round half to
    even), with the zero-scale guard: scale 0 (an all-zero input) gives
    all-zero codes, so callers only ever multiply by the stored scale."""
    x = torch.as_tensor(x)
    scale = _f32(scale, x.device)
    pos = scale > 0
    q = torch.where(pos, torch.round(x / torch.where(pos, scale, 1.0)), 0.0)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def quantize_absmax_arrays(x, bits=8, axis=None):
    """Symmetric abs-max quantization -> (codes int8, scale float32).
    ``axis``: the reduction axis (or axes) of the abs-max, e.g. 0 on an
    [in, out] weight gives one scale per output channel ([out]); None
    one scalar scale.  Zero inputs get scale 0 and all-zero codes."""
    qmax = qmax_for_bits(bits)
    x = torch.as_tensor(x)
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    # a true division: the divisor is a tensor on x's device
    scale = amax.float() / torch.full((), float(qmax), device=x.device)
    q = quantize_with_scale_arrays(x, scale, qmax)
    if axis is not None:
        scale = scale.squeeze(axis)
    return q, scale


def dequantize_arrays(q, scale, axis=None):
    """``q * scale`` in float32.  ``axis``: the axis the per-channel scale
    runs along (so it broadcasts against q); None, a scalar or
    pre-broadcast scale."""
    _count("lowbit/dequant_calls", site="dequantize")
    q = torch.as_tensor(q).float()
    scale = _f32(scale, q.device)
    if axis is not None and scale.dim():
        shape = [1] * q.dim()
        shape[axis] = scale.shape[0]
        scale = scale.reshape(shape)
    return q * scale


def pack_int4_arrays(q):
    """Pack int8 codes in [-7, 7] two to a byte along axis 0: uint8
    [ceil(n/2), ...], low nibble = row 2i, high nibble = row 2i+1
    (two's-complement nibbles).  Odd n is zero-padded; pass the true n to
    `unpack_int4_arrays`."""
    q = torch.as_tensor(q).to(torch.int8)
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))])
    u = (q.to(torch.int16) & 0xF).to(torch.uint8)
    return u[0::2] | (u[1::2] << 4)


def unpack_int4_arrays(packed, rows):
    """Inverse of `pack_int4_arrays`: uint8 [ceil(rows/2), ...] -> int8
    [rows, ...] with nibble sign extension."""
    packed = torch.as_tensor(packed).to(torch.uint8)
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    inter = torch.stack([lo, hi], dim=1)             # [n2, 2, ...]
    return inter.reshape((-1,) + tuple(packed.shape[1:]))[:rows]


def quantized_matmul_arrays(x, qweight, scale, bits=8, in_features=None):
    """``x @ dequant(qweight)`` with fp32 accumulation.

    x: [..., in] activations of any float dtype; qweight: int8 [in, out]
    codes, or packed uint8 [ceil(in/2), out] when ``bits`` is 4 (pass
    ``in_features``); scale: float32 [out] per output channel, or a
    scalar, applied after the contraction.  Returns [..., out] in x's
    dtype (module docstring: the product's rounding)."""
    _count("lowbit/dequant_calls", site="matmul")
    x = torch.as_tensor(x)
    if bits == 4:
        rows = int(in_features if in_features is not None else x.shape[-1])
        q = unpack_int4_arrays(qweight, rows)
    elif bits == 8:
        q = torch.as_tensor(qweight).to(torch.int8)
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    acc = x.float() @ q.float()
    out = acc * _f32(scale, acc.device)
    return out.to(x.dtype)


def quantized_bytes(shape, bits, scale_elems):
    """Storage bytes of a quantized tensor: packed codes + fp32 scales."""
    n = math.prod(int(s) for s in shape)
    code_bytes = n if bits == 8 else (n + 1) // 2
    return code_bytes + 4 * int(scale_elems)
