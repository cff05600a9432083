"""Paged-KV-cache attention, array level — the port of
`paddle_tpu/ops/paged_attention.py`, full-precision pools and int8 pools
with per-block-per-head scales.  This module has no kernel of its own.

Layout: K/V live in physical blocks ``[num_blocks, block_size, H, D]`` and
each sequence owns a block table row; token ``p`` of a sequence lives at
slot ``table[p // block_size] * block_size + p % block_size``.  An int8
pool holds codes beside fp32 scales ``[num_blocks, H]``: value = code *
scale.

Differences from JAX: `paged_cache_update_arrays` and
`quantized_cache_update_arrays` write the pools (and scales) IN PLACE
and return them, where JAX returns new arrays.
"""
from __future__ import annotations

import math

import torch

__all__ = ["slot_mapping", "paged_cache_update_arrays",
           "paged_gather_kv_arrays", "paged_attention_arrays",
           "quantized_cache_update_arrays", "quantized_gather_kv_arrays",
           "ragged_causal", "QMAX", "INV_QMAX"]

_NEG_INF = -1e30
QMAX = 127
# XLA rewrites the JAX package's ``amax / 127`` into a product with the
# fp32 reciprocal inside every jitted program (its engine's), so the port
# forms the scale candidate that way, bit for bit; the CUDA kernel too
INV_QMAX = float(torch.tensor(1.0 / QMAX, dtype=torch.float32))


def slot_mapping(block_table, positions, block_size, num_slots, valid=None):
    """Physical slot of each (row, position): ``[B, S]`` int32.  Invalid
    entries (``valid`` False) map to ``num_slots`` so a write drops them."""
    block_table = torch.as_tensor(block_table, dtype=torch.int32)
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=block_table.device)
    bs = int(block_size)
    maxb = block_table.shape[1]
    logical = torch.div(positions, bs, rounding_mode="floor")
    phys = torch.gather(block_table, 1,
                        logical.clamp(0, maxb - 1).long())
    slots = phys * bs + torch.remainder(positions, bs)
    if valid is not None:
        slots = torch.where(torch.as_tensor(valid, device=slots.device),
                            slots, torch.full_like(slots, int(num_slots)))
    return slots.to(torch.int32)


def paged_cache_update_arrays(blocks, rows, slots):
    """Write new K (or V) rows into the paged pool, in place.

    blocks: [num_blocks, block_size, H, D]; rows: [B, S, H, D]; slots:
    [B, S] int physical slots.  Out-of-range entries (padding / inactive
    rows) are DROPPED, never clamped — a clamp would silently corrupt the
    last block — with no read to the host (`_kept_entries`), so a
    captured step may call it.  Returns ``blocks``."""
    nb, bs = blocks.shape[0], blocks.shape[1]
    feat = tuple(blocks.shape[2:])
    flat = blocks.view((nb * bs,) + feat)
    s, src, any_kept = _kept_entries(slots, nb * bs)
    r = rows.reshape((-1,) + feat).to(blocks.dtype)
    flat.index_copy_(0, s, torch.where(any_kept, r[src], flat[s]))
    return blocks


def _kept_entries(slots, n):
    """(slot, row, any): for each entry of ``slots`` a slot in [0, n) and
    the row it writes, found on the device with no read to the host (a
    CUDA-graph capture allows none, so no boolean indexing).  An entry
    outside [0, n) repeats the first kept entry, its slot and its row, so
    the write puts that row twice at its own slot; with no kept entry
    (``any`` False) every entry points at slot 0, and the caller writes
    back what is there."""
    s = slots.reshape(-1).long()
    keep = (s >= 0) & (s < n)
    first = keep.to(torch.int32).argmax()       # 0 when none is kept
    src = torch.where(keep, torch.arange(s.numel(), device=s.device), first)
    any_kept = keep.any()
    return torch.where(any_kept, s[src], 0), src, any_kept


def paged_gather_kv_arrays(blocks, block_table):
    """Sequence-major view of the pool: [B, max_blocks * block_size, H, D].
    Table entries are clamped into range; rows past a sequence's context
    hold whatever those blocks hold and are masked by the caller."""
    nb, bs = blocks.shape[0], blocks.shape[1]
    tbl = block_table.long().clamp(0, nb - 1)
    b, maxb = tbl.shape
    return blocks[tbl].reshape((b, maxb * bs) + tuple(blocks.shape[2:]))


def quantized_cache_update_arrays(blocks, scales, rows, slots):
    """Write new K (or V) rows into an int8 pool with per-block-per-head
    abs-max scales, in place (`paged_attention.py:99-156`).

    blocks: int8 [num_blocks, block_size, H, D] codes; scales: fp32
    [num_blocks, H]; rows: [B, S, H, D] float; slots: [B, S] physical
    slots, entries outside the pool dropped (and left out of the amax),
    with no read to the host (`_kept_entries`).

    A block's scale only grows: ``new = max(old, amax * (1/127))`` over
    every row this call writes into the block.  Where it grew, the block's
    old codes become ``round(code * old / new)``; where it did not, the
    factor is exactly 1 and the codes stay as they are.  The new rows are
    ``round(x / new)``.  Rounding is half to even, codes are clipped to
    +-127.  Returns ``(blocks, scales)``."""
    nb, bs, h, d = blocks.shape
    s, src, any_kept = _kept_entries(slots, nb * bs)
    x = rows.reshape(-1, h, d)[src].float()
    bid = torch.div(s, bs, rounding_mode="floor")
    cand = torch.zeros((nb, h), dtype=torch.float32, device=blocks.device)
    cand.scatter_reduce_(0, bid[:, None].expand(-1, h),
                         torch.where(any_kept, x.abs().amax(-1), 0.0),
                         "amax")
    new = torch.maximum(scales, cand * INV_QMAX)
    factor = torch.where(new > 0, scales / torch.where(new > 0, new, 1.0),
                         1.0)
    # rescale the written blocks (a block written by several rows is
    # gathered and scattered once per row, with the same values)
    resc = torch.round(blocks[bid].float() * factor[bid][:, None, :, None])
    blocks.index_copy_(0, bid, resc.clamp(-QMAX, QMAX).to(torch.int8))
    ws = new[bid]
    ws = torch.where(ws > 0, ws, 1.0)[:, :, None]
    codes = torch.round(x / ws).clamp(-QMAX, QMAX).to(torch.int8)
    flat = blocks.view(nb * bs, h, d)
    flat.index_copy_(0, s, torch.where(any_kept, codes, flat[s]))
    scales.copy_(new)
    return blocks, scales


def quantized_gather_kv_arrays(blocks, scales, block_table):
    """Dequantizing gather: fp32 [B, max_blocks * block_size, H, D] =
    codes * their block's per-head scale (`paged_attention.py:159-178`)."""
    nb, bs = blocks.shape[0], blocks.shape[1]
    tbl = block_table.long().clamp(0, nb - 1)
    b, maxb = tbl.shape
    deq = blocks[tbl].float() * scales[tbl][:, :, None, :, None]
    return deq.reshape((b, maxb * bs) + tuple(blocks.shape[2:]))


def ragged_causal(pos0, s, s_pad):
    """[B, 1, S, S_pad] bool: query j of row r (at position pos0[r] + j)
    sees keys 0 .. pos0[r] + j of the padded extent."""
    q_pos = pos0.to(torch.int32)[:, None] + torch.arange(
        s, dtype=torch.int32, device=pos0.device)[None, :]
    k_pos = torch.arange(s_pad, dtype=torch.int32, device=pos0.device)
    return (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]


def paged_attention_arrays(q, k_blocks, v_blocks, block_table, pos0,
                           scale=None, k_scales=None, v_scales=None):
    """Causal attention of a ragged batch against its paged KV cache (the
    current chunk's K/V already written).  q: [B, S, H, D]; pos0: [B]
    absolute position of each row's first query.  Query at position p
    attends keys k <= p over the padded ``max_blocks * block_size`` extent:
    fp32 logits, additive -1e30 mask, fp32 softmax, probs cast to the pool
    dtype.  With ``k_scales`` / ``v_scales`` the pools are int8 codes and
    the gather dequantizes them to fp32 (so the probabilities stay fp32).
    Returns [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if k_scales is not None:
        kg = quantized_gather_kv_arrays(k_blocks, k_scales, block_table)
        vg = quantized_gather_kv_arrays(v_blocks, v_scales, block_table)
    else:
        kg = paged_gather_kv_arrays(k_blocks, block_table)
        vg = paged_gather_kv_arrays(v_blocks, block_table)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg.float()) * scale
    logits = logits.masked_fill(~ragged_causal(pos0, s, kg.shape[1]),
                                _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vg.dtype), vg)
    return out.to(q.dtype)
