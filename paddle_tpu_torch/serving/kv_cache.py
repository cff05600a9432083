"""Block-paged KV cache with a free-list allocator — the port of
`paddle_tpu/serving/kv_cache.py` `BlockKVCache`.

K/V live per layer in pools of fixed-size physical blocks on the device

    k_blocks[l], v_blocks[l] : [num_blocks, block_size, H, D]

and each sequence owns a block table (list of physical ids), so a request
holds exactly ``ceil(len / block_size)`` blocks.  The engine's step
programs write the pools in place; no operation here reallocates a pool,
so a captured step graph that reads them stays valid.  With
``kv_quant="int8"`` the pools hold int8 codes beside per-block-per-head
fp32 scales

    k_scales[l], v_scales[l] : [num_blocks, H]     (value = code * scale)

and a block's scales are zeroed whenever the allocator hands it out.

Host logic ported one-to-one:

- **free list** — LIFO stack of physical ids and refcounts;
- **copy-on-fork** — `fork(parent, child)` shares every parent block by
  bumping refcounts; the first append into a SHARED partially filled last
  block copies it (`_cow_last_block`: codes, and for int8 pools the K and
  V scales of every layer), and `privatize_last_block` does so at once for
  a child that re-writes its last inherited position;
- **preemption by eviction** — bit-exact `swap_out` / `swap_in`;
- **automatic prefix caching** — a map from chained content keys
  (`prefix_block_keys`: block j's key is the sha1 of key j-1 and block j's
  tokens) to the FULL blocks that hold them (`register_prefix`);
  `match_prefix` walks a new prompt's chain to its longest indexed prefix
  and `adopt_prefix` starts the sequence's table from those blocks by
  refcount bump.  A block whose refcount drops to 0 while indexed is
  PARKED on an LRU instead of the free list: it stays adoptable and is
  reclaimed last (`_take` drains the free list first, then the
  least-recently-used parked block, dropping its index entry).  Parked
  blocks count as allocatable (`num_free_blocks`) and as in use
  (`blocks_in_use`): they hold live bytes.  Every capacity view derives
  from `counts()`;
- **speculative rollback** — `truncate_to` releases the blocks reserved
  for rejected draft positions.

Every transition asserts the refcount/free-list invariants.  The JAX
package's monitor counters are plain ints here (``prefix_hits``,
``prefix_hit_tokens``, ``prefix_evictions``).

Left out for later slices: the memory-microscope lifecycle ledger
(``acct``) and its chain ids.
"""
from __future__ import annotations

import hashlib
import struct
import time
from collections import OrderedDict

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["BlockKVCache", "BlockAllocatorError", "prefix_block_keys",
           "snapshot_to_handoff", "snapshot_from_handoff"]


class BlockAllocatorError(RuntimeError):
    pass


def prefix_block_keys(token_ids, block_size) -> list:
    """Chained content keys for every FULL block of `token_ids`:
    key_j = sha1(key_{j-1} || tokens[j*bs:(j+1)*bs] as little-endian
    int64), so equal keys imply equal block-aligned token prefixes (the
    JAX package's keys, byte for byte)."""
    bs = int(block_size)
    keys = []
    prev = b""
    for j in range(len(token_ids) // bs):
        block = token_ids[j * bs:(j + 1) * bs]
        prev = hashlib.sha1(
            prev + struct.pack(f"<{bs}q", *[int(t) for t in block])
        ).digest()
        keys.append(prev)
    return keys


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
        # prefix cache (inert until register_prefix)
        self._prefix_index: dict = {}  # chain key (bytes) -> physical id
        self._block_key: dict = {}     # physical id -> chain key
        self._lru: "OrderedDict" = OrderedDict()   # parked id -> monotonic
        #                                park time, least recent first
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_evictions = 0

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
        parked``: parked prefix blocks are allocatable (reclaimed last by
        `_take`) but in use for the utilization view."""
        free = len(self._free)
        parked = len(self._lru)
        return {
            "total": self.num_blocks,
            "free": free,
            "parked": parked,
            "allocatable": free + parked,
            "in_use": self.num_blocks - free,
            "referenced": self.num_blocks - free - parked,
            "peak_in_use": self.peak_blocks_in_use,
        }

    @property
    def num_free_blocks(self) -> int:
        """Allocatable blocks: free plus parked, the number admission
        budgets against."""
        return self.counts()["allocatable"]

    @property
    def num_parked_blocks(self) -> int:
        """Unreferenced blocks held by the prefix index."""
        return self.counts()["parked"]

    @property
    def blocks_in_use(self) -> int:
        """Blocks holding live bytes: referenced or parked."""
        return self.counts()["in_use"]

    @property
    def utilization(self) -> float:
        c = self.counts()
        return c["in_use"] / max(c["total"], 1)

    def block_table(self, seq_id):
        return list(self._tables[seq_id])

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
        if self._free:
            i = self._free.pop()
        elif self._lru:
            # reclaimed last, least recently used first: the parked block
            # stops being adoptable the moment its bytes are handed out
            i, _ = self._lru.popitem(last=False)
            self._drop_index(i)
            self.prefix_evictions += 1
        else:
            raise BlockAllocatorError("out of KV blocks")
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
            if idx in self._block_key:
                # indexed prefix block: park (its content stays adoptable)
                self._lru[idx] = time.monotonic()
                self._lru.move_to_end(idx)
            else:
                self._free.append(idx)

    def _drop_index(self, idx) -> None:
        key = self._block_key.pop(idx, None)
        if key is not None:
            self._prefix_index.pop(key, None)

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
        """Extend a sequence's table to cover `num_tokens` tokens,
        copying a shared partially filled last block first (the append
        target must be privately owned: forked siblings keep reading the
        original)."""
        t = self._tables[seq_id]
        if self._needs_cow(seq_id, num_tokens):
            self._cow_last_block(seq_id)
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

    # -- copy-on-fork -------------------------------------------------------

    def fork(self, parent_id, child_id):
        """Share the parent's blocks with a new sequence (refcount bump:
        no copy until one of them appends into the shared last block)."""
        if child_id in self._tables:
            raise BlockAllocatorError(f"sequence {child_id} already exists")
        t = self._tables[parent_id]
        for idx in t:
            self._blocks[idx].ref += 1
        self._tables[child_id] = list(t)
        self._lengths[child_id] = self._lengths[parent_id]

    def _copy_block(self, src, dst):
        """Copy block ``src`` into ``dst`` in every layer's pools, and for
        int8 pools both its K and V scales."""
        for l in range(self.num_layers):
            self.k_blocks[l][dst] = self.k_blocks[l][src]
            self.v_blocks[l][dst] = self.v_blocks[l][src]
        if self.kv_quant:
            self._scales[:, :, dst] = self._scales[:, :, src]

    def _cow_last_block(self, seq_id):
        t = self._tables[seq_id]
        src = t[-1]
        dst = self._take()
        self._copy_block(src, dst)
        t[-1] = dst
        self._release(src)

    def privatize_last_block(self, seq_id):
        """Copy the sequence's last block now if it is shared.  A forked
        child re-writes its last inherited position (it re-feeds the
        parent's last sampled token), and that write must never land in
        a block the parent still reads."""
        t = self._tables[seq_id]
        if t and self._blocks[t[-1]].ref > 1:
            self._cow_last_block(seq_id)

    # -- automatic prefix caching -------------------------------------------

    def register_prefix(self, seq_id, keys, num_tokens) -> None:
        """Index `seq_id`'s fully written leading blocks under their chain
        keys (`prefix_block_keys` of the prompt).  Only blocks wholly
        inside the first `num_tokens` computed tokens are indexed: a full
        block is never written again while referenced.  First writer
        wins: an existing key keeps pointing at its original block."""
        t = self._tables[seq_id]
        full = min(len(keys), int(num_tokens) // self.block_size, len(t))
        for j in range(full):
            key = keys[j]
            if key in self._prefix_index:
                continue
            idx = t[j]
            if idx in self._block_key:
                continue   # already indexed under another chain
            self._prefix_index[key] = idx
            self._block_key[idx] = key

    def match_prefix(self, keys, max_blocks=None) -> int:
        """Longest indexed prefix of `keys`, in blocks.  Walks the chain in
        order and stops at the first miss; refreshes the recency of every
        parked block it matches."""
        limit = len(keys) if max_blocks is None else min(len(keys),
                                                        int(max_blocks))
        n = 0
        for j in range(limit):
            idx = self._prefix_index.get(keys[j])
            if idx is None:
                break
            if idx in self._lru:
                self._lru.move_to_end(idx)
            n += 1
        return n

    def adoptable_free_blocks(self, keys, n_blocks) -> int:
        """`num_free_blocks` minus the first `n_blocks` matched blocks that
        are parked: adopting revives them, so an admission check must not
        count them as reclaimable capacity too."""
        parked = sum(1 for key in keys[:n_blocks]
                     if self._prefix_index.get(key) in self._lru)
        return self.num_free_blocks - parked

    def adopt_prefix(self, seq_id, keys, n_blocks) -> int:
        """Start `seq_id` from the cached chain: its table begins with the
        `n_blocks` indexed blocks (refcount bump; parked blocks leave the
        LRU; no bytes move).  Returns the adopted token count."""
        if seq_id in self._tables:
            raise BlockAllocatorError(f"sequence {seq_id} already exists")
        ids = []
        for key in keys[:n_blocks]:
            idx = self._prefix_index[key]
            blk = self._blocks[idx]
            if blk.ref == 0:
                self._lru.pop(idx, None)
            blk.ref += 1
            ids.append(idx)
        self._tables[seq_id] = ids
        hit_tokens = len(ids) * self.block_size
        self._lengths[seq_id] = hit_tokens
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        if ids:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
        return hit_tokens

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


def snapshot_to_handoff(saved) -> dict:
    """A `swap_out` snapshot in the JAX package's layout, the ``kv`` of a
    migration handoff: per-layer lists ``k``, ``v`` of [n, block_size, H,
    D] and, for int8 pools, ``ks``, ``vs`` of [n, H], as numpy arrays (a
    bf16 pool's as torch bf16 tensors: numpy has no bf16)."""
    def host(t):
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()

    out = {"len": saved["len"], "k": [host(t) for t in saved["k"]],
           "v": [host(t) for t in saved["v"]]}
    if "ks" in saved:
        out["ks"] = [s.numpy().copy() for s in saved["ks"].unbind(0)]
        out["vs"] = [s.numpy().copy() for s in saved["vs"].unbind(0)]
    return out


def snapshot_from_handoff(kv) -> dict:
    """The inverse of `snapshot_to_handoff`: a handoff's ``kv`` (from
    either package) as a snapshot `BlockKVCache.swap_in` takes."""
    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))

    out = {"len": int(kv["len"]), "k": [tensor(a) for a in kv["k"]],
           "v": [tensor(a) for a in kv["v"]]}
    if "ks" in kv:
        out["ks"] = torch.stack([tensor(a) for a in kv["ks"]])
        out["vs"] = torch.stack([tensor(a) for a in kv["vs"]])
    return out
