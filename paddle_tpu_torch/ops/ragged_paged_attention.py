"""Fused cache write + causal paged attention for a ragged batch — the port
of `paddle_tpu/ops/ragged_paged_attention.py`, full-precision pools and
int8 pools with per-block-per-head scales.

On a CUDA tensor `ragged_paged_attention_arrays` launches a kernel of
``csrc/ragged_paged_attention.cu`` (any chunk width C >= 1: decode rows and
chunked-prefill continuations): ``ragged_paged_attention`` for fp pools,
``ragged_paged_attention_int8`` (counted apart, as `int8`) for int8 pools.
Its attend launch is split-K: `ragged_splits` takes the grid's splits
per (row, query, head) from host-known shapes alone (B, C, H and the
table's width), and each block finds its row's own split count from
pos0 and kv_lens on the card, so a call reads no device value on the
host and adds no sync.  The partials live in a kept per-device scratch
buffer; the tickets are `_build.tickets`.
On a CPU tensor it computes `ragged_paged_attention_reference`, the JAX
fallback composition (`:521-534`), which is the oracle this port is held
against: the paged write then `paged_attention_arrays` for fp pools; the
quantized write then the scale-folded attention `folded_quant_attention`
for int8 pools.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .paged_attention import (INV_QMAX, _NEG_INF, paged_attention_arrays,
                              paged_cache_update_arrays,
                              quantized_cache_update_arrays, ragged_causal)

__all__ = ["ragged_paged_attention_arrays",
           "ragged_paged_attention_reference", "folded_quant_attention",
           "ragged_paged_attention_part", "ragged_splits", "int8"]

KERNEL = "ragged_paged_attention"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
launches = 0          # fp-pool kernel launches since the last reset

CHUNK = 128           # keys per split: 8 pool blocks of 16
_WAVE = 8             # attend blocks an SM that the splits aim to fill


class _Int8Kernel:
    """Launch counter of the int8-pool entry of the same source."""
    KERNEL = "ragged_paged_attention:int8"
    SOURCE = SOURCE
    launches = 0


int8 = _Int8Kernel()


def folded_quant_attention(q, k_blocks, v_blocks, k_scales, v_scales,
                           block_table, pos0, scale):
    """int8 paged attention without the dequantizing gather
    (`ragged_paged_attention.py:431-465`): the codes are gathered as
    fp32, ``k_scale`` multiplies the scaled logits and ``v_scale`` the
    normalised probabilities (the scale is constant along the contracted
    head dim).  Same causal -1e30 mask over the padded extent as
    `paged_attention_arrays`."""
    b, s, h, d = q.shape
    nb, bs = k_blocks.shape[0], k_blocks.shape[1]
    tbl = block_table.long().clamp(0, nb - 1)
    maxb = tbl.shape[1]
    s_pad = maxb * bs
    kg = k_blocks[tbl].reshape(b, s_pad, h, d).float()
    vg = v_blocks[tbl].reshape(b, s_pad, h, d).float()
    # per-position scales [B, S_pad, H]
    ksg = k_scales[tbl][:, :, None, :].expand(b, maxb, bs, h).reshape(
        b, s_pad, h)
    vsg = v_scales[tbl][:, :, None, :].expand(b, maxb, bs, h).reshape(
        b, s_pad, h)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg) * scale
    logits = logits * ksg.permute(0, 2, 1)[:, :, None, :]
    logits = logits.masked_fill(~ragged_causal(pos0, s, s_pad), _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    pw = probs * vsg.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", pw, vg)
    return out.to(q.dtype)


def ragged_paged_attention_reference(q, k_new, v_new, k_blocks, v_blocks,
                                     block_table, pos0, kv_lens, slots,
                                     k_scales=None, v_scales=None,
                                     scale=None):
    """The plain version: write, then attend over the padded extent.
    ``kv_lens`` is unused here, as in the JAX fallback (the causal mask by
    ``pos0`` covers it).  Updates the pools (and scales) in place."""
    del kv_lens
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if k_scales is None:
        paged_cache_update_arrays(k_blocks, k_new, slots)
        paged_cache_update_arrays(v_blocks, v_new, slots)
        out = paged_attention_arrays(q, k_blocks, v_blocks, block_table,
                                     pos0, scale=scale)
        return out, k_blocks, v_blocks
    quantized_cache_update_arrays(k_blocks, k_scales, k_new, slots)
    quantized_cache_update_arrays(v_blocks, v_scales, v_new, slots)
    out = folded_quant_attention(q, k_blocks, v_blocks, k_scales, v_scales,
                                 block_table, pos0, scale)
    return out, k_blocks, v_blocks, k_scales, v_scales


def ragged_splits(b, c, h, width, sms):
    """Blocks per (row, query, head) of the attend launch: enough that the
    B * C * H groups fill ``_WAVE`` blocks an SM of ``sms``, at most the
    CHUNKs of the table's ``width`` (blocks per row times block size).  A
    row longer than that many CHUNKs takes wider chunks on the card; a
    chunked-prefill call (C = 188, 512) already fills the card and gets
    1, so it needs no partials."""
    groups = b * c * h
    return max(1, min(-(-width // CHUNK), -(-_WAVE * sms // groups)))


def _scratch_bytes(b, c, h, d, splits):
    """Bytes of the attend's partials: (m, l) and acc[D] in fp32 for each
    split of each (row, query, head); none with one split."""
    return 0 if splits == 1 else b * c * h * splits * (d + 2) * 4


def _check(q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
           slots, k_scales, v_scales):
    b, c, h, d = q.shape
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, c, h, d):
            raise ValueError(f"{name} must be {(b, c, h, d)}, got "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1 or (h > 1 and t.stride(2) != d):
            raise ValueError(f"{name} needs unit stride in D and stride D "
                             f"between heads, got strides {t.stride()}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k_new and v_new must share one device and "
                             "dtype")
    nb, bs = k_blocks.shape[0], k_blocks.shape[1]
    pool_dt = torch.int8 if k_scales is not None else q.dtype
    for name, t in (("k_blocks", k_blocks), ("v_blocks", v_blocks)):
        if tuple(t.shape) != (nb, bs, h, d) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous "
                             f"{(nb, bs, h, d)} pool")
        if t.dtype != pool_dt or t.device != q.device:
            raise ValueError(f"{name} must be {pool_dt} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if k_blocks.data_ptr() % 16 or v_blocks.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (vector loads)")
    if k_scales is None:
        # the fp attend reads the call's own rows from k_new / v_new with
        # 16-byte loads
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            steps = [t.stride(i) for i in (0, 1) if t.shape[i] > 1]
            if t.data_ptr() % 16 or any(x * t.element_size() % 16
                                        for x in steps):
                raise ValueError(f"{name} must start on 16 bytes with row "
                                 f"and position strides of a multiple of "
                                 f"16 bytes, got strides {t.stride()}")
    if k_scales is not None:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if (tuple(t.shape) != (nb, h) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"{(nb, h)} on {q.device}")
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


def _fn(name, n_ptr, n_float):
    """The C entry ``name``: n_ptr pointers, 11 ints, 6 strides, n_float
    floats and the stream."""
    fn = getattr(_build.load(SOURCE), name)
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * n_ptr + [i] * 11 + [ll] * 6
                       + [ctypes.c_float] * n_float + [vp])
        fn.restype = ctypes.c_int
    return fn


def _launch(parts, q, k_new, v_new, k_blocks, v_blocks, block_table, pos0,
            kv_lens, slots, k_scales, v_scales, scale):
    """Checks, then the write launch (parts 1), the attend launch (2) or
    both (3) of the entry for the pools' type; returns out."""
    _check(q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
           slots, k_scales, v_scales)
    b, c, h, d = q.shape
    nb, bs = k_blocks.shape[0], k_blocks.shape[1]
    maxb = block_table.shape[1]
    dev = q.device
    splits = ragged_splits(b, c, h, maxb * bs, _build.sms(dev))
    out = torch.empty((b, c, h, d), dtype=q.dtype, device=dev)
    quant = k_scales is not None
    ptrs = [q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_blocks.data_ptr(), v_blocks.data_ptr()]
    if quant:
        ptrs += [k_scales.data_ptr(), v_scales.data_ptr()]
    nbytes = _scratch_bytes(b, c, h, d, splits)
    ptrs += [block_table.data_ptr(), pos0.data_ptr(), kv_lens.data_ptr(),
             slots.data_ptr(), out.data_ptr(),
             _build.scratch(KERNEL, dev, nbytes) if nbytes else 0,
             _build.tickets(dev, b * c * h).data_ptr() if nbytes else 0]
    ints = [b, c, h, d, nb, bs, maxb, int(q.dtype == torch.bfloat16),
            splits, CHUNK, parts]
    strides = [q.stride(0), q.stride(1), k_new.stride(0), k_new.stride(1),
               v_new.stride(0), v_new.stride(1)]
    floats = [float(scale)] + ([INV_QMAX] if quant else [])
    name = "ragged_paged_attention_int8" if quant else KERNEL
    err = _fn(name, len(ptrs), len(floats))(
        *ptrs, *ints, *strides, *floats,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    return out


def ragged_paged_attention_part(part, q, k_new, v_new, k_blocks, v_blocks,
                                block_table, pos0, kv_lens, slots,
                                k_scales=None, v_scales=None):
    """One launch of `ragged_paged_attention_arrays` alone on CUDA tensors,
    ``part`` "write" (the pools and scales updated in place) or "attend"
    (returns out), to time the two apart.  Not counted as a launch of the
    kernel."""
    return _launch({"write": 1, "attend": 2}[part], q, k_new, v_new,
                   k_blocks, v_blocks, block_table, pos0, kv_lens, slots,
                   k_scales, v_scales, 1.0 / math.sqrt(q.shape[-1]))


def ragged_paged_attention_arrays(q, k_new, v_new, k_blocks, v_blocks,
                                  block_table, pos0, kv_lens, slots,
                                  k_scales=None, v_scales=None, scale=None):
    """Write the current tokens' K/V into their slots, then attend.

    q, k_new, v_new: [B, C, H, D] (C = 1 at decode, > 1 for a
    chunked-prefill continuation); k_blocks/v_blocks: [num_blocks,
    block_size, H, D] pools — fp, or int8 codes with ``k_scales`` /
    ``v_scales`` fp32 [num_blocks, H]; block_table: [B, max_blocks] int32;
    pos0: [B] int32 position of each row's first query; kv_lens: [B] int32
    key count after the write; slots: [B, C] int32, the slot of position
    pos0 + j or an entry outside the pool (dropped).  Query j of row r
    attends keys 0 .. pos0[r] + j.

    The pools (and scales) are updated IN PLACE (JAX returns new arrays);
    they are also returned, so ``(out, k_blocks, v_blocks)`` — plus
    ``(k_scales, v_scales)`` for int8 pools — mirrors the JAX signature.
    Output at padding rows and padded query positions is unspecified.

    On a CUDA tensor this launches the kernel (q float32 / bfloat16, head
    dims 64 and 128) and raises on anything it does not take; it never
    falls back.  On a CPU tensor it computes the reference."""
    global launches
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if not q.is_cuda:
        return ragged_paged_attention_reference(
            q, k_new, v_new, k_blocks, v_blocks, block_table, pos0, kv_lens,
            slots, k_scales, v_scales, scale=scale)
    out = _launch(3, q, k_new, v_new, k_blocks, v_blocks, block_table,
                  pos0, kv_lens, slots, k_scales, v_scales, scale)
    if quant:
        int8.launches += 1
        return out, k_blocks, v_blocks, k_scales, v_scales
    launches += 1
    return out, k_blocks, v_blocks
