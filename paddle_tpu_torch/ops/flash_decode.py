"""Dense KV-cache attention for autoregressive decoding — the port of
`cached_attention_arrays` and `flash_decode_arrays`
(`paddle_tpu/ops/pallas_ops.py:812-877`, `:1047-1130`).

The caches are flat ``[B, S_max, H*D]`` rings.  `cached_attention_arrays`
writes the current chunk at row ``t`` IN PLACE (JAX returns new arrays;
the rings are also returned, so the signature matches).  A mask-free
S_q = 1 step with q and the rings of one dtype goes to
`flash_decode_arrays`, which on a CUDA tensor launches the kernel of
``csrc/flash_decode.cu`` (the port of `_decode_kernel`,
`pallas_ops.py:1008`) and on a CPU tensor computes
`flash_decode_reference`.  The kernel splits each row's keys into chunks
of 128 (split-K: ``flash_decode_splits(length)`` blocks per row and head);
with more than one split the wrapper hands it an fp32 scratch buffer for
the partial softmax states and the per-device int32 tickets of
`_build.tickets`, through which the last block of each (row, head)
merges the partials in split order.  Everything else (prefill chunks, an extra
mask) runs the masked-softmax branch of `:862-877`, which is XLA in the
JAX package and torch code here.

The JAX gate `_decode_ok` (`:1133-1174`) also sends short rings
(``S_max < PTPU_FLASH_DECODE_MIN_SMAX``) and non-TPU backends to that
branch, and honours ``PTPU_FLASH_DECODE``.  Those state TPU tuning
limits; here every mask-free S_q = 1 step takes the kernel, at any
``S_max``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["cached_attention_arrays", "flash_decode_arrays",
           "flash_decode_reference"]

KERNEL = "flash_decode"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
launches = 0          # kernel launches since the last reset

_NEG_INF = -1e30


def flash_decode_reference(q, k_cache, v_cache, length, scale=None):
    """Plain decode attention: q [B, 1, H, D] against the first ``length``
    rows of flat [B, S_max, H*D] rings -> [B, 1, H, D] in q's dtype.

    The kernel's arithmetic: fp32 logits ``q . k`` (the products are NOT
    rounded to bf16 first, unlike the TPU kernel's per-head matmul against
    an indicator), fp32 softmax statistics, each probability ``exp(s - m)``
    rounded to the cache dtype before the value product (`seg_dot(p,
    expand)`, `pallas_ops.py:997`), the sum divided by the fp32 ``l``."""
    b, _, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kc = k_cache[:, :length].reshape(b, length, h, d).float()
    vc = v_cache[:, :length].reshape(b, length, h, d)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kc) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)                                            # [B, H]
    acc = torch.einsum("bhk,bkhd->bhd", p.to(vc.dtype).float(), vc.float())
    out = acc / l.clamp(min=1e-30)[..., None]
    return out[:, None].to(q.dtype)


def _check(q, k_cache, v_cache, length):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    if q.stride(3) != 1 or (h > 1 and q.stride(2) != d):
        raise ValueError(f"q needs unit stride in D and stride D between "
                         f"heads, got strides {q.stride()}")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (c.dim() != 3 or c.shape[0] != b or c.shape[2] != h * d
                or not c.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{b}, S_max, "
                             f"{h * d}] ring, got {tuple(c.shape)}")
        if c.dtype != q.dtype or c.device != q.device:
            raise ValueError("q and the rings must share one device and "
                             "dtype")
        if c.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes for the "
                             f"kernel's 16-byte loads")
    if k_cache.shape != v_cache.shape:
        raise ValueError("k_cache and v_cache differ in shape")
    if not 1 <= length <= k_cache.shape[1]:
        raise ValueError(f"length {length} outside [1, {k_cache.shape[1]}]")


def _lib():
    lib = _build.load(SOURCE)
    fn = lib.flash_decode
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 6 + [i] * 6 + [ll, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        lib.flash_decode_splits.argtypes = [i]
        lib.flash_decode_splits.restype = ctypes.c_int
    return lib


def flash_decode_arrays(q, k_cache, v_cache, length, scale=None):
    """Decode attention of q [B, 1, H, D] against the first ``length``
    (>= 1, shared by the batch) rows of the flat rings.  Returns
    [B, 1, H, D] in q's dtype.

    On a CUDA tensor this launches the kernel (float32 / bfloat16, head
    dims 64 and 128, q and rings of one dtype) and raises on anything it
    does not take; it never falls back.  On a CPU tensor it computes
    `flash_decode_reference`."""
    global launches
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    length = int(length)
    if not q.is_cuda:
        return flash_decode_reference(q, k_cache, v_cache, length, scale)
    _check(q, k_cache, v_cache, length)
    b, _, h, _ = q.shape
    lib = _lib()
    splits = lib.flash_decode_splits(length)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    # each split's (m, l) and acc[D] in fp32 (freed on return, reused only
    # by work queued later on this stream); one split writes out directly
    part = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    tickets = _build.tickets(q.device, b * h)   # one per (row, head)
    err = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), tickets.data_ptr(),
        b, h, d, k_cache.shape[1], length, int(q.dtype == torch.bfloat16),
        q.stride(0), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    launches += 1
    return out


def _masked_cached_attention(q, k_cache, v_cache, t, scale, mask):
    """The XLA branch of `cached_attention_arrays` (`pallas_ops.py:862-877`):
    fp32 logits over all S_max rows, causal by absolute position, the
    optional mask (bool: True attends; float: added), softmax, the
    probabilities cast to the cache dtype."""
    b, s, h, d = q.shape
    s_max = k_cache.shape[1]
    kc4 = k_cache.reshape(b, s_max, h, d)
    vc4 = v_cache.reshape(b, s_max, h, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kc4.float()) * scale
    q_pos = t + torch.arange(s, device=q.device)
    k_pos = torch.arange(s_max, device=q.device)
    causal = k_pos[None, :] <= q_pos[:, None]
    logits = logits.masked_fill(~causal[None, None], _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, _NEG_INF)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vc4.dtype).float(),
                       vc4.float())
    return out.to(q.dtype)


def cached_attention_arrays(q, k, v, k_cache, v_cache, t, scale=None,
                            mask=None):
    """KV-cache attention for one chunk.  q, k, v: [B, S, H, D] (S = 1 per
    decode step); k_cache, v_cache: flat [B, S_max, H*D] rings; t: the
    absolute position of the chunk's first token.  Writes k and v at rows
    ``[t, t + S)`` in place, then attends causally over the rings.

    Returns ``(out [B, S, H, D] in q's dtype, k_cache, v_cache)``."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    t = int(t)
    k_cache[:, t:t + s] = k.reshape(b, s, h * d).to(k_cache.dtype)
    v_cache[:, t:t + s] = v.reshape(b, s, h * d).to(v_cache.dtype)
    if mask is None and s == 1 and q.dtype == k_cache.dtype == v_cache.dtype:
        out = flash_decode_arrays(q, k_cache, v_cache, t + 1, scale=scale)
    else:
        out = _masked_cached_attention(q, k_cache, v_cache, t, scale, mask)
    return out, k_cache, v_cache
