"""paddle_tpu_torch's int8 KV-cache serving against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through both packages:

- `quantized_cache_update_arrays`: codes and scales bitwise equal to the
  JAX function's, on the five row mixes of tests/test_ragged_attention.py
  with fp32 and bf16 rows, and on rows built to grow a scale, to keep one
  (factor exactly 1) and to land on x / scale = n + 1/2 (half to even).
  The JAX function runs under `jax.jit`, as it runs in the JAX engine's
  step programs: XLA turns its ``amax / 127`` into a product with the fp32
  reciprocal there, and the port computes that product.
- the int8 ragged plain version against the JAX fallback
  `ragged_paged_attention_arrays(k_scales=...)` (jitted, likewise): pools
  and scales bitwise, out within 1e-5 (fp32 q; one bf16 step plus 1e-5
  for bf16 q, each side rounding its fp32 result once).  The oracle is the
  fallback, not the interpret-mode kernel (ROADMAP, "Caveat about the
  reference").
- `paged_attention_arrays` with scales (the dequantizing gather), within
  1e-5.
- `BlockKVCache.block_bytes` and the engine's default ``num_blocks`` equal
  to the JAX package's.
- the int8 `LLMEngine`: greedy tokens identical to the JAX int8 engine
  (its XLA fallback: ``PTPU_PALLAS_INTERPRET`` unset) in a mixed batch,
  under chunked prefill and through a preemption that swaps codes and
  scales.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu.ops import ragged_paged_attention as jrp
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving.kv_cache import BlockKVCache as JaxBlockKVCache

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import (BlockKVCache, EngineConfig, LLMEngine,
                                      SamplingParams)

from _torch_port_util import MIXES, mix
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_jit_update = jax.jit(jpa.quantized_cache_update_arrays)
_jit_ragged = jax.jit(jrp.ragged_paged_attention_arrays)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _pools(geo, seed):
    """Random int8 pools and fp32 scales in [0, 0.2), as the JAX test."""
    nb, bs, h, d = geo
    rng = np.random.RandomState(seed)
    codes = [rng.randint(-127, 128, (nb, bs, h, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.rand(nb, h) * 0.2).astype(np.float32) for _ in range(2)]
    return codes, scales


def _jrows(a, jdt):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def _update_both(codes, scales, rows, slots, dtype):
    jdt, tdt = DTYPES[dtype]
    wb, ws = _jit_update(jnp.asarray(codes), jnp.asarray(scales),
                         _jrows(rows, jdt), jnp.asarray(slots))
    blocks, sc = _t(codes), _t(scales)
    gb, gs = pa.quantized_cache_update_arrays(blocks, sc, _t(rows, tdt),
                                              _t(slots))
    assert gb is blocks and gs is sc           # written in place
    return (np.asarray(wb), np.asarray(ws)), (gb.numpy(), gs.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix_name", MIXES)
def test_quantized_update_bitwise(mix_name, dtype):
    _, kn, _, _, _, _, slots, _, _, geo = mix(mix_name)
    (codes, _), (scales, _) = _pools(geo, 2)
    want, got = _update_both(codes, scales, kn, slots, dtype)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_quantized_update_scale_paths_and_half_to_even():
    """Block 0 grows its scale to exactly twice the old one, so its odd
    old codes land on n + 1/2 when rescaled; block 1 keeps a scale of 0.5
    (factor exactly 1: old codes unchanged) and takes rows at (n + 1/2) *
    0.5.  Both round half to even, as in the JAX package."""
    nb, bs, h, d = 3, 4, 1, 4
    new0 = np.float32(100.0) * np.float32(pa.INV_QMAX)
    codes = np.zeros((nb, bs, h, d), np.int8)
    codes[0, 0, 0] = [5, 7, -5, 3]
    codes[1, 0, 0] = [11, -13, 127, -127]
    scales = np.array([[new0 / 2], [0.5], [0.0]], np.float32)
    rows = np.zeros((1, 2, h, d), np.float32)
    rows[0, 0, 0] = [100.0, 1.0, -2.0, 0.0]          # block 0, slot 1
    rows[0, 1, 0] = [1.25, 1.75, -1.25, 0.25]        # block 1, slot 5
    slots = np.array([[1, 5]], np.int32)
    want, got = _update_both(codes, scales, rows, slots, "float32")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    gb, gs = got
    assert gs[0, 0] == new0 and gs[1, 0] == 0.5 and gs[2, 0] == 0.0
    np.testing.assert_array_equal(gb[0, 0, 0], [2, 4, -2, 2])   # rescaled
    np.testing.assert_array_equal(gb[1, 0, 0], [11, -13, 127, -127])
    np.testing.assert_array_equal(gb[1, 1, 0], [2, 4, -2, 0])   # new row
    assert gb[0, 1, 0, 0] == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix_name", MIXES)
def test_ragged_int8_plain_matches_jax_fallback(mix_name, dtype,
                                                monkeypatch):
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    jdt, tdt = DTYPES[dtype]
    q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = mix(mix_name)
    (kc, vc), (ks, vs) = _pools(geo, 3)
    idx = (tables, pos0, lens, slots)
    want = _jit_ragged(*(_jrows(a, jdt) for a in (q, kn, vn)),
                       jnp.asarray(kc), jnp.asarray(vc),
                       *(jnp.asarray(a) for a in idx),
                       k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    ops.reset_launch_counts()
    got = rpa.ragged_paged_attention_arrays(
        *(_t(a, tdt) for a in (q, kn, vn)), _t(kc), _t(vc),
        *(_t(a) for a in idx), k_scales=_t(ks), v_scales=_t(vs))
    assert set(ops.launch_counts().values()) == {0}
    assert len(got) == 5 and got[0].dtype == tdt
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out = got[0].float()
    ref = _t(np.asarray(jnp.asarray(want[0], jnp.float32)))
    for b in valid:
        o, r = out[b, :qlens[b]], ref[b, :qlens[b]]
        limit = TOL if dtype == "float32" else (
            2.0 ** -7 * torch.maximum(o.abs(), r.abs()) + TOL)
        assert ((o - r).abs() <= limit).all(), (mix_name, b)


def test_ragged_scales_must_pair():
    q, kn, vn, tables, pos0, lens, slots, _, _, geo = mix("single_row")
    (kc, vc), (ks, _) = _pools(geo, 4)
    with pytest.raises(ValueError, match="both k_scales and v_scales"):
        rpa.ragged_paged_attention_arrays(
            *(_t(a) for a in (q, kn, vn, kc, vc, tables, pos0, lens,
                              slots)), k_scales=_t(ks))


@pytest.mark.parametrize("mix_name", MIXES)
def test_paged_attention_with_scales_matches_jax(mix_name):
    q, _, _, tables, pos0, _, _, valid, qlens, geo = mix(mix_name)
    (kc, vc), (ks, vs) = _pools(geo, 5)
    want = np.asarray(jpa.paged_attention_arrays(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(pos0), k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs)))
    got = pa.paged_attention_arrays(_t(q), _t(kc), _t(vc), _t(tables),
                                    _t(pos0), k_scales=_t(ks),
                                    v_scales=_t(vs)).numpy()
    for b in valid:
        np.testing.assert_allclose(got[b, :qlens[b]], want[b, :qlens[b]],
                                   atol=TOL, rtol=0)
    deq = pa.quantized_gather_kv_arrays(_t(kc), _t(ks), _t(tables))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jpa.quantized_gather_kv_arrays(jnp.asarray(kc), jnp.asarray(ks),
                                       jnp.asarray(tables))))


# ---------------------------------------------------------------------------
# the KV cache and the engine
# ---------------------------------------------------------------------------

NEW = 5
LENS = [3, 5, 7, 3]


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_test_config(stacked_blocks=True, sequence_parallel=False))
    m.eval()
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jax_model)._param_arrays().items()}
    m = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    return m.load_params(params_from_numpy(arrays, device="cpu"))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, (n,)).astype(np.int32) for n in LENS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_bytes_and_default_num_blocks(jax_model, port_model, dtype):
    jdt, tdt = DTYPES[dtype]
    for quant in (None, "int8"):
        assert BlockKVCache.block_bytes(16, 4, 16, tdt, quant) == \
            JaxBlockKVCache.block_bytes(16, 4, 16, jdt, quant)
    fp = LLMEngine(port_model, EngineConfig(device="cpu", dtype=tdt,
                                            max_num_seqs=4))
    q8 = LLMEngine(port_model, EngineConfig(device="cpu", dtype=tdt,
                                            max_num_seqs=4,
                                            kv_cache_dtype="int8"))
    layers = jax_model.cfg.num_hidden_layers
    budget = fp.cache.num_blocks * layers * JaxBlockKVCache.block_bytes(
        16, 4, 16, jdt)
    assert q8.cache.num_blocks == budget // (
        layers * JaxBlockKVCache.block_bytes(16, 4, 16, jdt, "int8"))
    assert q8.cache.pool_bytes <= fp.cache.pool_bytes
    if dtype == "float32":
        jeng = JaxEngine(jax_model, JaxEngineConfig(max_num_seqs=4,
                                                    kv_cache_dtype="int8"))
        assert q8.cache.num_blocks == jeng.cache.num_blocks
        assert q8.cache.pool_bytes == jeng.cache.pool_bytes
    assert q8.cache.k_blocks[0].dtype == torch.int8
    assert q8.cache.k_scales[0].shape == (q8.cache.num_blocks, 4)


def test_kv_cache_dtype_must_be_none_or_int8(port_model):
    for bad in ("fp8", "int4", torch.int8):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            LLMEngine(port_model, EngineConfig(device="cpu",
                                               kv_cache_dtype=bad))
    with pytest.raises(ValueError, match="kv_quant"):
        BlockKVCache(1, 4, 4, 1, 4, device="cpu", kv_quant="fp8")


def test_scales_reset_when_a_block_is_handed_out_again():
    cache = BlockKVCache(2, 4, 4, 2, 4, device="cpu", kv_quant="int8")
    cache.allocate(0, 6)                       # blocks 0, 1
    for s in cache.k_scales + cache.v_scales:
        s.fill_(0.5)
    cache.free(0)
    cache.allocate(1, 3)                       # block 1 again (LIFO)
    cache.grow_to(1, 5)                        # and block 0
    for s in cache.k_scales + cache.v_scales:
        assert s[:2].eq(0).all() and s[2:].eq(0.5).all()


def _both(jax_model, port_model, prompts, **cfg):
    want = JaxEngine(jax_model, JaxEngineConfig(
        kv_cache_dtype="int8", **cfg)).generate(
        prompts, JaxSamplingParams(max_new_tokens=NEW))
    eng = LLMEngine(port_model, EngineConfig(device="cpu",
                                             kv_cache_dtype="int8", **cfg))
    ops.reset_launch_counts()
    got = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
    assert set(ops.launch_counts().values()) == {0}
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.cache.blocks_in_use == 0
    return eng


def test_int8_engine_mixed_and_chunked_identical(jax_model, port_model,
                                                 prompts, monkeypatch):
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    eng = _both(jax_model, port_model, prompts, block_size=16,
                max_num_seqs=8)
    assert eng.step_counts == {"prefill": len(LENS), "chunk": 0,
                               "decode": NEW - 1}
    eng = _both(jax_model, port_model, prompts, block_size=4,
                max_num_seqs=8, max_num_batched_tokens=4)
    assert eng.step_counts["chunk"] == 4 and eng.step_counts["prefill"] == 2


def test_int8_engine_through_preemption_identical(jax_model, port_model,
                                                  monkeypatch):
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    rng = np.random.RandomState(1)
    pair = [rng.randint(0, 128, (n,)).astype(np.int32) for n in (14, 15)]
    swaps = []
    real = BlockKVCache.swap_out

    def spy(self, seq_id):
        saved = real(self, seq_id)
        swaps.append(saved)
        return saved

    monkeypatch.setattr(BlockKVCache, "swap_out", spy)
    eng = _both(jax_model, port_model, pair, block_size=16, num_blocks=3,
                max_num_seqs=2)
    assert eng.num_preemptions >= 1, "pool was sized to force eviction"
    assert swaps and all(set(s) == {"len", "k", "v", "ks", "vs"}
                         for s in swaps)
    assert swaps[0]["ks"][0].dtype == torch.float32
