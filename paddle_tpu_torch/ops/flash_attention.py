"""Causal flash attention — the port of the flash-forward part of
`paddle_tpu/ops/pallas_ops.py`.

`flash_attention_arrays` launches the CUDA kernel
``csrc/flash_fwd_causal.cu`` on a CUDA tensor and computes `mha_reference`
(the plain version, `pallas_ops.py:73`) on a CPU tensor.  Layout
``[batch, seq, heads, head_dim]``, as in the JAX package.

Left out for later slices: the additive mask, ``kv_lens`` and packed
``segment_ids`` variants, non-causal attention on the card, and the
backward kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_arrays", "mha_reference"]

KERNEL = "flash_fwd_causal"
launches = 0          # kernel launches since the last reset

_NEG_INF = -1e30


def mha_reference(q, k, v, is_causal=False, scale=None, return_lse=False):
    """q, k, v: [B, S, H, D] -> [B, Sq, H, D] in v's dtype.  fp32 logits
    (einsum of the operands widened to fp32, as JAX's
    ``preferred_element_type=float32``), additive -1e30 causal mask aligned
    at the end (query i sees keys <= i + Sk - Sq), fp32 softmax, probs cast
    to v's dtype.  With ``return_lse`` also the fp32 logsumexp [B, H, Sq]."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check_qkv(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share one device and dtype")
        if t.stride(3) != 1 or (t.shape[2] > 1
                                and t.stride(2) != t.shape[3]):
            raise ValueError(f"{name} needs unit stride in D and stride D "
                             f"between heads, got strides {t.stride()}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    if k.shape[1] < sq:
        raise ValueError("causal attention needs Sk >= Sq")


def _launch(q, k, v, scale):
    global launches
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd_causal(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, int(q.dtype == torch.bfloat16),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    launches += 1
    return out, lse


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.flash_fwd_causal
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [i] * 6 + [ll] * 6 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_arrays(q, k, v, is_causal=True, scale=None,
                           return_lse=False):
    """Causal attention over [B, S, H, D].  Returns ``out`` (in q's dtype)
    and, with ``return_lse``, the fp32 logsumexp [B, H, Sq].

    On a CUDA tensor this launches the hand-written kernel — any S, head
    dims 64 and 128, float32 or bfloat16 — and raises on anything the
    kernel does not take; it never falls back.  On a CPU tensor it computes
    `mha_reference`."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.is_cuda:
        if not is_causal:
            raise NotImplementedError(
                "the CUDA flash kernel is the causal variant only")
        out, lse = _launch(q, k, v, scale)
        return (out, lse) if return_lse else out
    out = mha_reference(q, k, v, is_causal=is_causal, scale=scale,
                        return_lse=return_lse)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)
