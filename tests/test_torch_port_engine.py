"""paddle_tpu_torch `LLMEngine` on the CPU against the JAX `LLMEngine`.

Both engines serve the same `gpt_test_config` weights (the JAX model's,
carried across with `convert.params_from_numpy`).  Greedy tokens must be
identical in a mixed batch, under chunked prefill, and through a
preemption; the prefill logits agree to 1e-4 (fp32, different reduction
orders in the two frameworks).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                      SamplingParams)
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


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


def _both(jax_model, port_model, prompts, **cfg):
    want = JaxEngine(jax_model, JaxEngineConfig(**cfg)).generate(
        prompts, JaxSamplingParams(max_new_tokens=NEW))
    eng = LLMEngine(port_model, EngineConfig(device="cpu", **cfg))
    got = eng.generate(prompts, SamplingParams(max_new_tokens=NEW))
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.cache.blocks_in_use == 0
    return eng


def test_greedy_mixed_batch_identical(jax_model, port_model, prompts):
    eng = _both(jax_model, port_model, prompts, block_size=16,
                max_num_seqs=8)
    assert eng.step_counts == {"prefill": len(LENS), "chunk": 0,
                               "decode": NEW - 1}


def test_greedy_chunked_prefill_identical(jax_model, port_model, prompts):
    eng = _both(jax_model, port_model, prompts, block_size=4,
                max_num_seqs=8, max_num_batched_tokens=4)
    # 5 -> 4 + 1 and 7 -> 4 + 3: a prompt that does not fit one step runs
    # every chunk through the ragged (1, C) body
    assert eng.step_counts["chunk"] == 4
    assert eng.step_counts["prefill"] == 2


def test_greedy_through_preemption_identical(jax_model, port_model):
    rng = np.random.RandomState(1)
    pair = [rng.randint(0, 128, (n,)).astype(np.int32) for n in (14, 15)]
    # 14+NEW and 15+NEW tokens need 2 blocks each; 3 cannot hold both
    eng = _both(jax_model, port_model, pair, block_size=16, num_blocks=3,
                max_num_seqs=2)
    assert eng.num_preemptions >= 1, "pool was sized to force eviction"


def test_prefill_logits_close(jax_model, port_model, prompts):
    p = prompts[2]
    jeng = JaxEngine(jax_model, JaxEngineConfig(block_size=16))
    slots = np.arange(len(p), dtype=np.int32)[None]
    want, _ = jeng._get_prefill_exec(len(p))(
        jeng._param_arrays(), jeng._kv_flat(), jnp.asarray(p[None]),
        jnp.asarray(slots))
    eng = LLMEngine(port_model, EngineConfig(device="cpu", block_size=16))
    got = eng._prefill_logits(torch.from_numpy(p[None]),
                              torch.from_numpy(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_seeded_sampling_reproducible(port_model, prompts):
    sp = SamplingParams(max_new_tokens=NEW, do_sample=True, temperature=0.8,
                        top_k=20, top_p=0.9, seed=7)
    runs = [LLMEngine(port_model, EngineConfig(device="cpu")).generate(
        prompts, sp) for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_cuda_engine_raises_without_cuda(port_model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        LLMEngine(port_model, EngineConfig(device="cuda"))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        LLMEngine(port_model)          # device=None means cuda


def test_kv_cache_raises_without_cuda(monkeypatch):
    from paddle_tpu_torch.serving import BlockKVCache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        BlockKVCache(1, 8, 4, 1, 2)    # device=None means cuda
    assert BlockKVCache(1, 8, 4, 1, 2, device="cpu").k_blocks[0].is_cpu


@pytest.mark.parametrize("option", [
    "pp_schedule", "sequence_parallel", "use_flash_attention",
    "context_parallel", "hidden_dropout_prob", "moe_every_n", "recompute"])
def test_config_has_no_unported_options(option):
    # the JAX config's field exists; the port's cannot be set unless the
    # port has the behaviour (dropout and recompute: the training recipe;
    # moe_every_n: the mixture-of-experts blocks)
    assert option in {f.name for f in dataclasses.fields(jax_test_config())}
    if option in ("hidden_dropout_prob", "recompute", "moe_every_n"):
        assert getattr(gpt_test_config(**{option: 1}), option) == 1
        return
    with pytest.raises(TypeError):
        gpt_test_config(**{option: 1})


def test_config_positional_fields_mean_what_they_mean_in_jax():
    # the port's positional fields are JAX's first ten, in JAX's order;
    # the rest are keyword-only (JAX's eleventh positional field,
    # use_flash_attention, is one the port lacks) and keep JAX's
    # relative order
    from paddle_tpu.models import GPTConfig as JaxConfig
    from paddle_tpu_torch.models import GPTConfig
    jax_names = [f.name for f in dataclasses.fields(JaxConfig)]
    fields = dataclasses.fields(GPTConfig)
    positional = [f.name for f in fields if not f.kw_only]
    assert positional == jax_names[:10]
    assert positional[-1] == "layer_norm_epsilon"
    rest = [f.name for f in fields if f.kw_only]
    assert rest == [n for n in jax_names if n in rest]
    values = (99, 32, 3, 2, 64, 16, 0.0, 0.0, 0.03, 1e-6)
    port, jax_cfg = GPTConfig(*values), JaxConfig(*values)
    for name in positional:
        assert getattr(port, name) == getattr(jax_cfg, name), name
    assert JaxConfig(*values, False).use_flash_attention is False
    with pytest.raises(TypeError):
        GPTConfig(*values, True)
