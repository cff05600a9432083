"""Fused cache write + causal paged attention for a ragged batch — the port
of `paddle_tpu/ops/ragged_paged_attention.py` at full precision.

On a CUDA tensor `ragged_paged_attention_arrays` launches the kernel in
``csrc/ragged_paged_attention.cu`` (any chunk width C >= 1: decode rows and
chunked-prefill continuations).  On a CPU tensor it computes
`ragged_paged_attention_reference`, the JAX fallback composition
(`paged_cache_update_arrays` then `paged_attention_arrays`), which is the
oracle this port is held against.

Left out for a later slice: int8 pools with per-block-per-head scales.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import (paged_attention_arrays,
                              paged_cache_update_arrays)

__all__ = ["ragged_paged_attention_arrays",
           "ragged_paged_attention_reference"]

KERNEL = "ragged_paged_attention"
launches = 0          # kernel launches since the last reset


def ragged_paged_attention_reference(q, k_new, v_new, k_blocks, v_blocks,
                                     block_table, pos0, kv_lens, slots,
                                     scale=None):
    """The plain version: write, then attend over the padded extent.
    ``kv_lens`` is unused here, as in the JAX fallback (the causal mask by
    ``pos0`` covers it).  Updates the pools in place."""
    del kv_lens
    paged_cache_update_arrays(k_blocks, k_new, slots)
    paged_cache_update_arrays(v_blocks, v_new, slots)
    out = paged_attention_arrays(q, k_blocks, v_blocks, block_table, pos0,
                                 scale=scale)
    return out, k_blocks, v_blocks


def _check(q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
           slots):
    b, c, h, d = q.shape
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, c, h, d):
            raise ValueError(f"{name} must be {(b, c, h, d)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1 or (h > 1 and t.stride(2) != d):
            raise ValueError(f"{name} needs unit stride in D and stride D "
                             f"between heads, got strides {t.stride()}")
    nb, bs = k_blocks.shape[0], k_blocks.shape[1]
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        if tuple(t.shape) != (nb, bs, h, d) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{(nb, bs, h, d)} pool")
    if k_blocks.data_ptr() % 16 or v_blocks.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (vector loads)")
    for t in (k_new, v_new, k_blocks, v_blocks):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k_new, v_new and the pools must share one "
                             "device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    shapes = (("block_table", block_table, 2), ("pos0", pos0, 1),
              ("kv_lens", kv_lens, 1), ("slots", slots, 2))
    for name, t, nd in shapes:
        if (t.dtype != torch.int32 or t.device != q.device
                or not t.is_contiguous() or t.dim() != nd
                or t.shape[0] != b):
            raise ValueError(f"{name} must be a contiguous int32 tensor of "
                             f"{nd} dims and batch {b} on {q.device}")
    if slots.shape[1] != c:
        raise ValueError(f"slots must be [{b}, {c}]")


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.ragged_paged_attention
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 10 + [i] * 8 + [ll] * 6
                       + [ctypes.c_float, vp])
        fn.restype = ctypes.c_int
    return lib


def ragged_paged_attention_arrays(q, k_new, v_new, k_blocks, v_blocks,
                                  block_table, pos0, kv_lens, slots,
                                  scale=None):
    """Write the current tokens' K/V into their slots, then attend.

    q, k_new, v_new: [B, C, H, D] (C = 1 at decode, > 1 for a
    chunked-prefill continuation); k_blocks/v_blocks: [num_blocks,
    block_size, H, D] pools; block_table: [B, max_blocks] int32; pos0: [B]
    int32 position of each row's first query; kv_lens: [B] int32 key count
    after the write; slots: [B, C] int32, entries outside the pool are
    dropped.  Query j of row r attends keys 0 .. pos0[r] + j.

    The pools are updated IN PLACE (JAX returns new arrays); they are also
    returned, so ``(out, k_blocks, v_blocks)`` mirrors the JAX signature.
    Output at padding rows and padded query positions is unspecified.

    On a CUDA tensor this launches the kernel (float32 / bfloat16, head
    dims 64 and 128) and raises on anything it does not take; it never
    falls back.  On a CPU tensor it computes the reference."""
    global launches
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return ragged_paged_attention_reference(
            q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
            slots, scale=scale)
    _check(q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
           slots)
    b, c, h, _ = q.shape
    nb, bs = k_blocks.shape[0], k_blocks.shape[1]
    out = torch.empty((b, c, h, d), dtype=q.dtype, device=q.device)
    err = _lib().ragged_paged_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_blocks.data_ptr(), v_blocks.data_ptr(), block_table.data_ptr(),
        pos0.data_ptr(), kv_lens.data_ptr(), slots.data_ptr(),
        out.data_ptr(), b, c, h, d, nb, bs, block_table.shape[1],
        int(q.dtype == torch.bfloat16), q.stride(0), q.stride(1),
        k_new.stride(0), k_new.stride(1), v_new.stride(0), v_new.stride(1),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    launches += 1
    return out, k_blocks, v_blocks
