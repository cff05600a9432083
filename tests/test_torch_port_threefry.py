"""paddle_tpu_torch.core.random (JAX's threefry2x32 in torch) and seeded
sampling, on the CPU against `jax.random` and the JAX package.

Keys, splits, raw bits and uniforms must be bitwise `jax.random`'s (the
partitionable threefry the installed jax runs); gumbel noise within
GUMBEL_ULPS units in the last place of max(|g|, 1) (the two logs are
torch's, not XLA's); categorical draws equal.  Seeded sampling: the
port's dense `generate(seed=...)` and its engine's seeded mixed batch
give the JAX package's tokens.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import random as jrng
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

import paddle_tpu_torch
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import random as R
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


SEEDS = [0, 7, 2 ** 31 + 3, 2 ** 32 + 5, 2 ** 40 + 9, -1, -5, 2 ** 63 - 1,
         -2 ** 63]
SHAPES = [(5,), (3, 7), (1, 50304), (8, 50304)]
GUMBEL_ULPS = 4
NEW = 5
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_jaxs(seed):
    np.testing.assert_array_equal(R.PRNGKey(seed).numpy(),
                                  _np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [2 ** 63, -2 ** 63 - 1, 2 ** 64])
def test_seed_out_of_range_raises_as_in_jax(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        R.PRNGKey(seed)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
def test_splits_are_jaxs(seed):
    key, want = R.PRNGKey(seed), jax.random.PRNGKey(seed)
    for num in (2, 3, 5):
        np.testing.assert_array_equal(R.split(key, num).numpy(),
                                      _np(jax.random.split(want, num)))
    # a batch of keys, as int64 and as the handoff's numpy uint32
    keys = jnp.stack([jax.random.PRNGKey(seed + i) for i in range(4)])
    want = _np(jax.vmap(jax.random.split)(keys))
    np.testing.assert_array_equal(R.split(torch.from_numpy(_np(keys))).numpy(),
                                  want)
    np.testing.assert_array_equal(R.split(np.array(keys)).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
def test_bits_and_uniforms_bitwise(seed, shape):
    key, jkey = R.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(R.random_bits(key, shape).numpy(),
                                  _np(jax.random.bits(jkey, shape)))
    for lo, hi in ((0.0, 1.0), (-2.5, 3.0), (np.finfo(np.float32).tiny, 1.0)):
        got = R.uniform(key, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo,
                                             hi))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_ulps_and_categorical_equal(shape):
    rng = np.random.default_rng(0)
    for seed in (0, 7, 2 ** 31 + 3):
        key, jkey = R.PRNGKey(seed), jax.random.PRNGKey(seed)
        got = R.gumbel(key, shape).numpy()
        want = np.asarray(jax.random.gumbel(jkey, shape))
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert (np.abs(got - want) <= GUMBEL_ULPS * ulp).all()
        logits = (3 * rng.standard_normal(shape)).astype(np.float32)
        np.testing.assert_array_equal(
            R.categorical(key, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(jkey, jnp.asarray(logits))))


def test_batched_keys_draw_as_vmap():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 50304)).astype(np.float32)
    keys = jnp.stack([jax.random.PRNGKey(11 + i) for i in range(4)])
    want = jax.vmap(lambda k, l: jax.random.categorical(k, l[None])[0])(
        keys, jnp.asarray(logits))
    got = R.categorical(torch.from_numpy(_np(keys)), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        R.random_bits(torch.from_numpy(_np(keys)), (3, 11)).numpy(),
        _np(jax.vmap(lambda k: jax.random.bits(k, (3, 11)))(keys)))


def test_global_key_stack_is_jaxs():
    state = jrng.get_state()
    try:
        paddle.seed(5)
        paddle_tpu_torch.seed(5)
        for _ in range(3):
            np.testing.assert_array_equal(R.next_key().numpy(),
                                          _np(jrng.next_key()))
        np.testing.assert_array_equal(R.get_state().numpy(),
                                      _np(jrng.get_state()))
        with R.key_scope(R.PRNGKey(9)), jrng.key_scope(
                jax.random.PRNGKey(9)):
            np.testing.assert_array_equal(R.next_key().numpy(),
                                          _np(jrng.next_key()))
        R.set_state(R.PRNGKey(3))
        assert R.get_state().tolist() == [0, 3]
    finally:
        jrng.set_state(state)
        R.seed(0)


# ---------------------------------------------------------------------------
# seeded sampling against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(stacked_blocks=True,
                                sequence_parallel=False))
    jm.eval()
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jm)._param_arrays().items()}
    pm = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    return jm, pm.load_params(params_from_numpy(arrays, device="cpu"))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 128, (n,)).astype(np.int32)
            for n in (3, 5, 7, 5)]


@pytest.fixture(scope="module")
def jax_seeded(models, prompts):
    """The JAX package's seeded tokens: solo dense generate of the first
    two prompts, a dense batch of two, and the engine's mixed batch."""
    jm, _ = models
    solo = [np.asarray(jm.generate(Tensor(jnp.asarray(p[None])),
                                   max_new_tokens=NEW, seed=7 + i,
                                   **SAMPLE)._data)[0]
            for i, p in enumerate(prompts[:2])]
    pair = np.stack([prompts[1], prompts[3]])
    batch = np.asarray(jm.generate(Tensor(jnp.asarray(pair)),
                                   max_new_tokens=NEW, seed=3,
                                   **SAMPLE)._data)
    sps = [JaxSamplingParams(max_new_tokens=NEW, seed=7 + i, **SAMPLE)
           for i in range(len(prompts))]
    sps[2] = JaxSamplingParams(max_new_tokens=NEW)     # a greedy row
    engine = JaxEngine(jm, JaxEngineConfig(block_size=16)).generate(
        prompts, sps)
    return {"solo": solo, "batch": batch, "engine": engine}


def test_dense_generate_seeded_is_jaxs(models, prompts, jax_seeded):
    _, pm = models
    for i, p in enumerate(prompts[:2]):
        got = pm.generate(torch.from_numpy(p[None]), max_new_tokens=NEW,
                          seed=7 + i, **SAMPLE)
        np.testing.assert_array_equal(got.numpy()[0], jax_seeded["solo"][i])
    pair = torch.from_numpy(np.stack([prompts[1], prompts[3]]))
    got = pm.generate(pair, max_new_tokens=NEW, seed=3, **SAMPLE)
    np.testing.assert_array_equal(got.numpy(), jax_seeded["batch"])


def test_engine_seeded_mixed_batch_is_jaxs(models, prompts, jax_seeded):
    _, pm = models
    sps = [SamplingParams(max_new_tokens=NEW, seed=7 + i, **SAMPLE)
           for i in range(len(prompts))]
    sps[2] = SamplingParams(max_new_tokens=NEW)
    eng = LLMEngine(pm, EngineConfig(block_size=16, device="cpu"))
    got = eng.generate(prompts, sps)
    for i, (g, w) in enumerate(zip(got, jax_seeded["engine"])):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # ... and each seeded row its solo dense generate (JAX's own contract)
    for i in range(2):
        np.testing.assert_array_equal(got[i], jax_seeded["solo"][i])


def test_generate_without_seed_draws_from_the_global_stack(models, prompts):
    """seed=None takes ``next_key()`` once, as JAX's generate does: the
    same root seed gives the same tokens, and the root key moves on."""
    _, pm = models
    ids = torch.from_numpy(prompts[0][None])
    try:
        R.seed(21)
        a = pm.generate(ids, max_new_tokens=NEW, **SAMPLE)
        np.testing.assert_array_equal(R.get_state().numpy(),
                                      R.split(R.PRNGKey(21))[0].numpy())
        R.seed(21)
        b = pm.generate(ids, max_new_tokens=NEW, **SAMPLE)
        sub = R.split(R.PRNGKey(21))[1]
        c = pm.generate(ids, max_new_tokens=NEW, seed=None, **SAMPLE)
        assert a.equal(b) and not a.equal(c)
        d = R.next_key()
        assert not d.equal(sub)
    finally:
        R.seed(0)
