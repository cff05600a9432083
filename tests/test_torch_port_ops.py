"""paddle_tpu_torch ops against the JAX package on the same numpy inputs.

CPU tests hold the port's plain PyTorch versions (what a wrapper computes
on a CPU tensor) against the JAX functions, which on the CPU run their XLA
reference paths.  Tolerances: fp32 throughout; 1e-5 absolute where the two
frameworks reduce in different orders, bitwise where the op is a pure
copy (slot mapping, pool writes).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_port_kernels.py.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.gpt import _stacked_block_body as jax_block_body
from paddle_tpu.nn.functional import layer_norm_arrays as jax_layer_norm
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrp
from paddle_tpu.serving.kv_cache import BlockKVCache as JaxBlockKVCache

from paddle_tpu_torch.models.gpt import _stacked_block_body
from paddle_tpu_torch.nn.functional import layer_norm_arrays
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving.kv_cache import BlockKVCache

from _torch_port_util import MIXES, mix as _mix

REPO = pathlib.Path(__file__).resolve().parents[1]

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash attention (plain version) vs JAX flash_attention_arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, 17, 128])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_causal_matches_jax(s, d):
    rng = np.random.RandomState(s * 100 + d)
    q, k, v = (rng.randn(2, s, 3, d).astype(np.float32) for _ in range(3))
    want = np.asarray(jpo.flash_attention_arrays(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True))
    got = fa.flash_attention_arrays(_t(q), _t(k), _t(v), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_flash_lse_is_logsumexp_of_masked_logits():
    rng = np.random.RandomState(0)
    q, k, v = (_t(rng.randn(1, 9, 2, 16).astype(np.float32))
               for _ in range(3))
    out, lse = fa.flash_attention_arrays(q, k, v, return_lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    mask = torch.ones(9, 9, dtype=torch.bool).tril()
    want = torch.logsumexp(logits.masked_fill(~mask, -1e30), dim=-1)
    assert out.shape == (1, 9, 2, 16) and lse.shape == (1, 2, 9)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# paged attention pieces
# ---------------------------------------------------------------------------

def test_slot_mapping_bitwise():
    rng = np.random.RandomState(3)
    table = rng.permutation(12)[:8].reshape(2, 4).astype(np.int32)
    positions = rng.randint(0, 16, (2, 5)).astype(np.int32)
    valid = rng.rand(2, 5) > 0.3
    want = np.asarray(jpa.slot_mapping(table, positions, 4, 48, valid=valid))
    got = pa.slot_mapping(_t(table), _t(positions), 4, 48, valid=_t(valid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_cache_update_bitwise_drops_out_of_range():
    rng = np.random.RandomState(4)
    blocks = rng.randn(6, 4, 2, 8).astype(np.float32)
    rows = rng.randn(2, 3, 2, 8).astype(np.float32)
    slots = np.array([[0, 5, 24], [23, 30, 7]], np.int32)   # 24, 30 drop
    want = np.asarray(jpa.paged_cache_update_arrays(
        jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(slots)))
    pool = _t(blocks.copy())
    got = pa.paged_cache_update_arrays(pool, _t(rows), _t(slots))
    assert got is pool                           # written in place
    np.testing.assert_array_equal(pool.numpy(), want)


@pytest.mark.parametrize("mix", MIXES)
def test_ragged_matches_jax_fallback(mix):
    q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = _mix(mix)
    nb, bs, H, D = geo
    rng = np.random.RandomState(1)
    kb = rng.randn(nb, bs, H, D).astype(np.float32)
    vb = rng.randn(nb, bs, H, D).astype(np.float32)
    want, k2, v2 = jrp.ragged_paged_attention_arrays(
        *(jnp.asarray(a) for a in (q, kn, vn, kb, vb, tables, pos0, lens,
                                   slots)))
    kp, vp = _t(kb.copy()), _t(vb.copy())
    got, kp2, vp2 = rpa.ragged_paged_attention_arrays(
        *(_t(a) for a in (q, kn, vn)), kp, vp,
        *(_t(a) for a in (tables, pos0, lens, slots)))
    assert kp2 is kp and vp2 is vp               # pools written in place
    np.testing.assert_array_equal(kp.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(v2))
    want = np.asarray(want)
    for b in valid:
        np.testing.assert_allclose(got[b, :qlens[b]].numpy(),
                                   want[b, :qlens[b]], atol=1e-5, rtol=0,
                                   err_msg=f"{mix} row {b}")


# ---------------------------------------------------------------------------
# model arithmetic
# ---------------------------------------------------------------------------

def _block_params(rng, H, I):
    shapes = {"ln1_w": (H,), "ln1_b": (H,), "qkv_w": (H, 3 * H),
              "qkv_b": (3 * H,), "out_w": (H, H), "out_b": (H,),
              "ln2_w": (H,), "ln2_b": (H,), "fc_in_w": (H, I),
              "fc_in_b": (I,), "fc_out_w": (I, H), "fc_out_b": (H,)}
    return {n: (rng.randn(*s) * (0.05 if len(s) == 2 else 0.5)
                + (1.0 if n.startswith("ln") and n.endswith("_w") else 0.0)
                ).astype(np.float32) for n, s in shapes.items()}


def test_stacked_block_body_matches_jax():
    # gpt_test_config widths: H=64, 4 heads, I=128
    H, nh, I = 64, 4, 128
    rng = np.random.RandomState(5)
    p = _block_params(rng, H, I)
    h = rng.randn(2, 7, H).astype(np.float32)
    want, _ = jax_block_body(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(h),
        lambda q, k, v: (jpo.flash_attention_arrays(q, k, v,
                                                    is_causal=True), None),
        nh, H // nh, 1e-5)
    got, _ = _stacked_block_body(
        {n: _t(a) for n, a in p.items()}, _t(h),
        lambda q, k, v: (fa.flash_attention_arrays(q, k, v), None),
        nh, H // nh, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_final_layer_norm_matches_jax():
    rng = np.random.RandomState(6)
    a = (rng.randn(3, 64) * 3 + 1).astype(np.float32)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = np.asarray(jax_layer_norm(jnp.asarray(a), jnp.asarray(w),
                                     jnp.asarray(b)))
    got = layer_norm_arrays(_t(a), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_kv_cache_counts_match_jax_under_one_op_sequence():
    mine = BlockKVCache(1, 8, 4, 1, 2, device="cpu")
    ref = JaxBlockKVCache(1, 8, 4, 1, 2)
    ops = [("allocate", 0, 6), ("allocate", 1, 3), ("allocate", 2, 3),
           ("grow_to", 2, 5), ("grow_to", 0, 9), ("truncate_to", 0, 4),
           ("swap_out", 1), ("free", 2), ("grow_to", 0, 13)]
    saved = {}
    for op, *args in ops:
        for cache in (mine, ref):
            if op == "swap_out":
                saved[id(cache)] = cache.swap_out(*args)
            else:
                getattr(cache, op)(*args)
            assert cache._needs_cow(0, 14) is False
        assert mine.counts() == ref.counts(), op
        assert mine._tables == ref._tables, op
    mine.swap_in(1, saved[id(mine)])
    ref.swap_in(1, saved[id(ref)])
    assert mine.counts() == ref.counts()
    assert mine.padded_table(1, 3) == ref.padded_table(1, 3)
    assert [mine.slot(0, p) for p in range(13)] == \
        [ref.slot(0, p) for p in range(13)]


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((REPO / "paddle_tpu_torch").rglob("*.py"))
    + [REPO / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_paddle_tpu(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), \
            f"{path} imports {name}"
