"""Block-paged KV cache with a free-list allocator — the port of
`paddle_tpu/serving/kv_cache.py` `BlockKVCache`.

K/V live per layer in pools of fixed-size physical blocks on the device

    k_blocks[l], v_blocks[l] : [num_blocks, block_size, H, D]

and each sequence owns a block table (list of physical ids), so a request
holds exactly ``ceil(len / block_size)`` blocks.  The engine's step
programs write the pools in place.  With ``kv_quant="int8"`` the pools
hold int8 codes beside per-block-per-head fp32 scales

    k_scales[l], v_scales[l] : [num_blocks, H]     (value = code * scale)

and a block's scales are zeroed whenever the allocator hands it out.

Host logic ported one-to-one: LIFO free list and refcounts, `truncate_to`,
and bit-exact `swap_out`/`swap_in` for preemption.  Every transition
asserts the refcount/free-list invariants.

Left out for later slices: fork with copy-on-write of a shared last block,
automatic prefix caching (index, LRU parking, adoption) — and with them
the scale copies of a copied block — and the memory-microscope lifecycle
ledger.  Until fork is ported no block is
shared, so `_needs_cow` is always False.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["BlockKVCache", "BlockAllocatorError"]


class BlockAllocatorError(RuntimeError):
    pass


class _Block:
    __slots__ = ("idx", "ref")

    def __init__(self, idx):
        self.idx = idx
        self.ref = 0


class BlockKVCache:
    def __init__(self, num_layers, num_blocks, block_size, num_heads,
                 head_dim, dtype=torch.float32, device=None, kv_quant=None):
        if kv_quant not in (None, "int8"):
            raise ValueError(
                f'kv_quant must be None or "int8", got {kv_quant!r}')
        self.num_layers = int(num_layers)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.dtype = dtype
        self.kv_quant = kv_quant
        self.device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, self.num_heads,
                 self.head_dim)
        pool_dt = torch.int8 if kv_quant else dtype
        self.k_blocks = [torch.zeros(shape, dtype=pool_dt, device=self.device)
                         for _ in range(num_layers)]
        self.v_blocks = [torch.zeros(shape, dtype=pool_dt, device=self.device)
                         for _ in range(num_layers)]
        self.k_scales = self.v_scales = self._scales = None
        if kv_quant:
            # one [K|V, L, num_blocks, H] tensor, so that a reset or a swap
            # of a few blocks is one op over all layers; k_scales[l] and
            # v_scales[l] are contiguous views of it
            self._scales = torch.zeros(
                (2, self.num_layers, self.num_blocks, self.num_heads),
                dtype=torch.float32, device=self.device)
            self.k_scales = list(self._scales[0].unbind(0))
            self.v_scales = list(self._scales[1].unbind(0))
        self._blocks = [_Block(i) for i in range(self.num_blocks)]
        self._free = list(range(self.num_blocks - 1, -1, -1))  # LIFO
        self._tables: dict = {}        # seq_id -> [physical ids]
        self._lengths: dict = {}       # seq_id -> token count covered
        self.peak_blocks_in_use = 0

    # -- introspection ------------------------------------------------------

    @staticmethod
    def block_bytes(block_size, num_heads, head_dim, dtype=torch.float32,
                    kv_quant=None) -> int:
        """Bytes ONE physical block costs per layer: K and V pools, plus
        the fp32 per-head scales when quantized."""
        per_tok = int(num_heads) * int(head_dim)
        if kv_quant == "int8":
            return 2 * (int(block_size) * per_tok + 4 * int(num_heads))
        itemsize = torch.empty((), dtype=dtype).element_size()
        return 2 * int(block_size) * per_tok * itemsize

    @property
    def bytes_per_block(self) -> int:
        """Bytes one block costs across all layers."""
        return self.num_layers * self.block_bytes(
            self.block_size, self.num_heads, self.head_dim, self.dtype,
            self.kv_quant)

    @property
    def pool_bytes(self) -> int:
        return self.num_blocks * self.bytes_per_block

    @property
    def num_slots(self) -> int:
        """Total physical token slots — also the "dropped write" sentinel:
        a slot id >= num_slots marks a padding row whose write is
        discarded, never clamped."""
        return self.num_blocks * self.block_size

    def counts(self) -> dict:
        """The one accounting source every capacity view derives from.
        Invariants: ``free + in_use == total`` and ``allocatable == free +
        parked`` (``parked`` is 0 until prefix caching is ported)."""
        free = len(self._free)
        return {
            "total": self.num_blocks,
            "free": free,
            "parked": 0,
            "allocatable": free,
            "in_use": self.num_blocks - free,
            "referenced": self.num_blocks - free,
            "peak_in_use": self.peak_blocks_in_use,
        }

    @property
    def num_free_blocks(self) -> int:
        return self.counts()["allocatable"]

    @property
    def blocks_in_use(self) -> int:
        return self.counts()["in_use"]

    def padded_table(self, seq_id, width):
        """Block table padded to `width` entries with num_blocks (an
        out-of-range id that no kernel dereferences)."""
        t = self._tables[seq_id]
        if len(t) > width:
            raise BlockAllocatorError(
                f"sequence {seq_id} spans {len(t)} blocks > table width "
                f"{width}")
        return t + [self.num_blocks] * (width - len(t))

    def slot(self, seq_id, position) -> int:
        """Physical slot of an (allocated) token position."""
        t = self._tables[seq_id]
        return t[position // self.block_size] * self.block_size \
            + position % self.block_size

    def blocks_needed(self, num_tokens) -> int:
        return -(-int(num_tokens) // self.block_size)

    # -- allocate / grow / free --------------------------------------------

    def _take(self) -> int:
        if not self._free:
            raise BlockAllocatorError("out of KV blocks")
        i = self._free.pop()
        blk = self._blocks[i]
        assert blk.ref == 0, f"free list handed out a referenced block {i}"
        blk.ref = 1
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return i

    def _release(self, idx):
        blk = self._blocks[idx]
        assert blk.ref > 0, f"double free of block {idx}"
        blk.ref -= 1
        if blk.ref == 0:
            self._free.append(idx)

    def _needs_cow(self, seq_id, num_tokens) -> bool:
        """Will growing to `num_tokens` write into a SHARED partially-
        filled last block?  (A full shared block is never written again.)"""
        t = self._tables.get(seq_id)
        old = self._lengths.get(seq_id, 0)
        return bool(t) and num_tokens > old \
            and old % self.block_size != 0 \
            and self._blocks[t[-1]].ref > 1

    def can_grow_to(self, seq_id, num_tokens) -> bool:
        """Enough free blocks (plus a possible copy-on-write block) to
        cover `num_tokens` for this sequence?"""
        have = len(self._tables.get(seq_id, ()))
        need = self.blocks_needed(num_tokens) - have
        if self._needs_cow(seq_id, num_tokens):
            need += 1
        return need <= self.num_free_blocks

    def allocate(self, seq_id, num_tokens):
        """Register `seq_id` and give it blocks covering `num_tokens`."""
        if seq_id in self._tables:
            raise BlockAllocatorError(f"sequence {seq_id} already allocated")
        need = self.blocks_needed(num_tokens)
        if need > self.num_free_blocks:
            raise BlockAllocatorError("out of KV blocks")
        ids = [self._take() for _ in range(need)]
        self._tables[seq_id] = ids
        self._lengths[seq_id] = int(num_tokens)
        self._reset_scales(ids)

    def grow_to(self, seq_id, num_tokens):
        """Extend a sequence's table to cover `num_tokens` tokens."""
        t = self._tables[seq_id]
        if self._needs_cow(seq_id, num_tokens):
            raise BlockAllocatorError(
                f"sequence {seq_id} would write a shared block: "
                "copy-on-write is not ported")
        new_ids = []
        while len(t) < self.blocks_needed(num_tokens):
            new_ids.append(self._take())
            t.append(new_ids[-1])
        self._lengths[seq_id] = max(self._lengths[seq_id], int(num_tokens))
        self._reset_scales(new_ids)

    def _reset_scales(self, ids):
        """Zero the scales of freshly allocated blocks: a block's scale
        only grows while it is owned, so a reallocated block must not
        inherit the previous owner's range."""
        if not self.kv_quant or not ids:
            return
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        self._scales[:, :, idx] = 0.0

    def free(self, seq_id):
        for idx in self._tables.pop(seq_id):
            self._release(idx)
        self._lengths.pop(seq_id, None)

    def truncate_to(self, seq_id, num_tokens):
        """Shrink a sequence's table to cover exactly `num_tokens` tokens
        (decref — a shared block survives for its other holders)."""
        t = self._tables[seq_id]
        keep = self.blocks_needed(num_tokens)
        while len(t) > keep:
            self._release(t.pop())
        self._lengths[seq_id] = min(self._lengths[seq_id],
                                    int(num_tokens))

    # -- preemption swap ----------------------------------------------------

    def swap_out(self, seq_id):
        """Evict: host-snapshot the sequence's block contents and free its
        blocks.  Returns the opaque saved state for `swap_in`."""
        idx = torch.tensor(self._tables[seq_id], dtype=torch.long,
                           device=self.device)
        saved = {
            "len": self._lengths[seq_id],
            "k": [k[idx].cpu() for k in self.k_blocks],
            "v": [v[idx].cpu() for v in self.v_blocks],
        }
        if self.kv_quant:
            # the codes mean nothing without their scales; [L, n, H] each
            saved["ks"] = self._scales[0][:, idx].cpu()
            saved["vs"] = self._scales[1][:, idx].cpu()
        self.free(seq_id)
        return saved

    def swap_in(self, seq_id, saved):
        """Restore an evicted sequence bit-exactly into fresh blocks."""
        n = len(saved["k"][0])
        if n > self.num_free_blocks:
            raise BlockAllocatorError("out of KV blocks")
        self._tables[seq_id] = [self._take() for _ in range(n)]
        self._lengths[seq_id] = saved["len"]
        idx = torch.tensor(self._tables[seq_id], dtype=torch.long,
                           device=self.device)
        for l in range(self.num_layers):
            self.k_blocks[l][idx] = saved["k"][l].to(self.device)
            self.v_blocks[l][idx] = saved["v"][l].to(self.device)
        if self.kv_quant:
            self._scales[0][:, idx] = saved["ks"].to(self.device)
            self._scales[1][:, idx] = saved["vs"].to(self.device)
