"""Inputs and a fixture shared by the port's tests (no JAX)."""
import zlib

import numpy as np
import pytest
import torch

__all__ = ["MIXES", "mix", "one_torch_thread"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread a worker, for a module that imports this
    fixture: under ``-n`` the workers' torch thread pools and JAX's contend
    for the cores, which slowed small ops many times over.  Put back after
    the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

MIXES = ["all_decode", "all_prefill_chunk", "mixed", "single_row",
         "evicted_mid_batch"]


def mix(name, bs=4, nb=12, maxb=4):
    """The row mixes of tests/test_ragged_attention.py as numpy arrays:
    (q, k_new, v_new, tables, pos0, lens, slots, valid, qlens, geometry)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 2**31)
    rows = {"all_decode": [(6, 1), (9, 1), (1, 1)],
            "all_prefill_chunk": [(4, 4), (8, 4)],
            "mixed": [(4, 4), (9, 1), (13, 2)],
            "single_row": [(7, 1)],
            "evicted_mid_batch": [(6, 1), None, (9, 1)]}[name]
    C = max(r[1] for r in rows if r is not None)
    B, H, D = len(rows), 2, 4
    num_slots = nb * bs
    tables = np.full((B, maxb), nb, np.int32)
    pos0 = np.zeros((B,), np.int32)
    lens = np.zeros((B,), np.int32)
    slots = np.full((B, C), num_slots, np.int32)
    used = list(rng.permutation(nb))
    for b, r in enumerate(rows):
        if r is None:
            continue
        kv_len, q_len = r
        nblk = -(-kv_len // bs)
        tables[b, :nblk] = [used.pop() for _ in range(nblk)]
        pos0[b] = kv_len - q_len
        lens[b] = kv_len
        for i in range(q_len):
            p = pos0[b] + i
            slots[b, i] = tables[b, p // bs] * bs + p % bs
    q = rng.randn(B, C, H, D).astype(np.float32)
    kn = rng.randn(B, C, H, D).astype(np.float32)
    vn = rng.randn(B, C, H, D).astype(np.float32)
    valid = [b for b, r in enumerate(rows) if r is not None]
    qlens = [0 if r is None else r[1] for r in rows]
    return q, kn, vn, tables, pos0, lens, slots, valid, qlens, (nb, bs, H, D)

