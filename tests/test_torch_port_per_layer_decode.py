"""The per-layer GPT's ``generate`` and the engine's static-buffer decode
step against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages; the
weights go from the JAX model's ``state_dict`` to the port by
`convert.params_from_numpy`.

- greedy ``generate`` of the per-layer test GPT (the default layout in
  both packages: `GPTAttention` / `GPTBlock` / `GPTModel` with caches)
  gives the JAX per-layer ``generate``'s tokens, with the flags off and
  under ``PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1`` (the JAX side in interpret
  mode); under the flags every LayerNorm and MLP of the prefill and of
  each decode step goes through the fused kernels' plain versions;
- a padded ``generate`` of the per-layer layout raises what the JAX one
  raises (the cache mask is wired on the stacked layout only);
- the engine, whose decode steps all run through its one
  ``("ragged", max_num_seqs, 1)`` static-buffer step, gives the JAX
  engine's greedy tokens for a mixed, chunked batch that preempts, with
  fp and int8 pools.

Greedy tokens must be identical.  The test GPT has ``hidden_size=128``
and four heads (head_dim 32), so the JAX attention takes its reference
paths, as in `test_torch_port_ln_train.py`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import graphs
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
B, P, NEW = 8, 6, 7
FLAGS = ("PTPU_PALLAS_LN", "PTPU_PALLAS_FFN")


@pytest.fixture(scope="module")
def models():
    """The JAX per-layer test GPT and the port's, with its weights."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jmodel.eval()
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jmodel.state_dict().items()}
    model = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    model.load_params(params_from_numpy(state, device="cpu"))
    assert not model.cfg.stacked_blocks and not jmodel.cfg.stacked_blocks
    return jmodel, model


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, P)).astype(
        np.int32)


def _set_flags(monkeypatch, on):
    for k in FLAGS:
        if on:
            monkeypatch.setenv(k, "1")
        else:
            monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("flags", [False, True])
def test_per_layer_greedy_generate_matches_jax(models, flags, monkeypatch):
    jmodel, model = models
    _set_flags(monkeypatch, flags)
    ids = _ids(int(flags))
    jmodel._gen_step = None          # its jit cache ignores the env flags
    want = np.asarray(jmodel.generate(paddle.to_tensor(ids),
                                      max_new_tokens=NEW).numpy())
    calls = {"layer_norm": 0, "ffn": 0}
    ln, ffn = PF.fused_layernorm_arrays, fm.fused_ffn_arrays

    def spy_ln(*a, **k):
        calls["layer_norm"] += 1
        return ln(*a, **k)

    def spy_ffn(*a, **k):
        calls["ffn"] += 1
        return ffn(*a, **k)

    monkeypatch.setattr(PF, "fused_layernorm_arrays", spy_ln)
    monkeypatch.setattr(fm, "fused_ffn_arrays", spy_ffn)
    got = model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (B, P + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    layers = model.cfg.num_hidden_layers
    # the prefill and NEW - 1 steps: 48 rows, then 8 rows, each a JAX row
    # block; ln_f's gate decided on all rows
    assert calls == ({"layer_norm": NEW * (2 * layers + 1),
                      "ffn": NEW * layers} if flags
                     else {"layer_norm": 0, "ffn": 0})


def test_per_layer_padded_generate_raises_as_jax(models):
    jmodel, model = models
    ids = _ids(2)
    ids[::2, :2] = 0
    jmodel._gen_step = None
    with pytest.raises(NotImplementedError) as jax_err:
        jmodel.generate(paddle.to_tensor(ids), max_new_tokens=2,
                        pad_token_id=0)
    with pytest.raises(NotImplementedError) as port_err:
        model.generate(torch.from_numpy(ids), max_new_tokens=2,
                       pad_token_id=0)
    assert str(port_err.value) == str(jax_err.value)
    assert "stacked-blocks" in str(port_err.value)


# ---------------------------------------------------------------------------
# the engine's decode step
# ---------------------------------------------------------------------------

ENGINE_NEW = 6


@pytest.fixture(scope="module")
def stacked():
    """The JAX stacked test GPT and the port's, with its weights."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(stacked_blocks=True,
                                    sequence_parallel=False))
    jmodel.eval()
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jmodel)._param_arrays().items()}
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True),
                           device="cpu")
    return jmodel, model.load_params(params_from_numpy(arrays, device="cpu"))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_static_decode_step_matches_jax(stacked, kv, monkeypatch):
    """Four requests of 3-21 tokens, chunks of 8, two rows at a time and a
    pool of 5 blocks of 8, so that a running request is preempted (and
    swapped back) while others decode: every decode step runs through the
    engine's one static-buffer step, and the tokens are JAX's."""
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    jmodel, model = stacked
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (13, 21, 3, 9)]
    cfg = dict(block_size=8, num_blocks=5, max_num_seqs=2,
               max_num_batched_tokens=8, kv_cache_dtype=kv)
    want = JaxEngine(jmodel, JaxEngineConfig(**cfg)).generate(
        prompts, JaxSamplingParams(max_new_tokens=ENGINE_NEW))
    runs = []
    real = graphs.StepGraph.__call__

    def count(self):
        runs.append(self.kind)
        return real(self)

    monkeypatch.setattr(graphs.StepGraph, "__call__", count)
    eng = LLMEngine(model, EngineConfig(device="cpu", **cfg))
    got = eng.generate(prompts, SamplingParams(max_new_tokens=ENGINE_NEW))
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.num_preemptions >= 1, "pool was sized to force eviction"
    assert eng.step_counts["chunk"] >= 2
    assert runs == ["ragged"] * eng.step_counts["decode"]
    assert list(eng._steps) == [("ragged", 2, 1)] and eng.compiles == {}
    assert eng.cache.blocks_in_use == 0
