"""Paged-KV-cache attention, array level — the port of
`paddle_tpu/ops/paged_attention.py` at full precision (the int8 pools
are a later slice).  This module has no kernel of its own.

Layout: K/V live in physical blocks ``[num_blocks, block_size, H, D]`` and
each sequence owns a block table row; token ``p`` of a sequence lives at
slot ``table[p // block_size] * block_size + p % block_size``.

Differences from JAX: `paged_cache_update_arrays` writes the pool IN PLACE
(and returns it), where JAX returns a new array.
"""
from __future__ import annotations

import math

import torch

__all__ = ["slot_mapping", "paged_cache_update_arrays",
           "paged_gather_kv_arrays", "paged_attention_arrays"]

_NEG_INF = -1e30


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
    last block.  Returns ``blocks``."""
    nb, bs = blocks.shape[0], blocks.shape[1]
    feat = tuple(blocks.shape[2:])
    flat = blocks.view((nb * bs,) + feat)
    s = slots.reshape(-1).long()
    keep = (s >= 0) & (s < nb * bs)
    r = rows.reshape((-1,) + feat).to(blocks.dtype)
    flat.index_copy_(0, s[keep], r[keep])
    return blocks


def paged_gather_kv_arrays(blocks, block_table):
    """Sequence-major view of the pool: [B, max_blocks * block_size, H, D].
    Table entries are clamped into range; rows past a sequence's context
    hold whatever those blocks hold and are masked by the caller."""
    nb, bs = blocks.shape[0], blocks.shape[1]
    tbl = block_table.long().clamp(0, nb - 1)
    b, maxb = tbl.shape
    return blocks[tbl].reshape((b, maxb * bs) + tuple(blocks.shape[2:]))


def paged_attention_arrays(q, k_blocks, v_blocks, block_table, pos0,
                           scale=None):
    """Causal attention of a ragged batch against its paged KV cache (the
    current chunk's K/V already written).  q: [B, S, H, D]; pos0: [B]
    absolute position of each row's first query.  Query at position p
    attends keys k <= p over the padded ``max_blocks * block_size`` extent:
    fp32 logits, additive -1e30 mask, fp32 softmax, probs cast to the pool
    dtype.  Returns [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kg = paged_gather_kv_arrays(k_blocks, block_table)
    vg = paged_gather_kv_arrays(v_blocks, block_table)
    s_pad = kg.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kg.float()) * scale
    q_pos = pos0.to(torch.int32)[:, None] + torch.arange(
        s, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.arange(s_pad, dtype=torch.int32, device=q.device)
    causal = k_pos[None, None, :] <= q_pos[:, :, None]      # [B, S, S_pad]
    logits = logits.masked_fill(~causal[:, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vg.dtype), vg)
    return out.to(q.dtype)
