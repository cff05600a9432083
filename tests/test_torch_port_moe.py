"""Mixture-of-experts blocks of the port against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through
`paddle_tpu.parallel.moe` and `paddle_tpu_torch.parallel.moe`; the MoE test
GPT's weights go from the JAX model's ``state_dict`` to the port by
`convert.params_from_numpy`.

- `moe_capacity`, and `_routing`'s dispatch, combine and aux loss for
  seeded logits, a zero gate (every probability 1/E: ties, which both
  packages break toward the lower expert index) and capacity overflow:
  dispatch bitwise, combine and aux within 1e-6;
- `moe_mlp_arrays` in fp32 and bf16;
- the per-layer ``gpt_test_config(moe_every_n=2, moe_num_experts=4)`` GPT
  (block 1 holds the experts): equal ``state_dict`` names, logits and
  each MoE block's ``aux_loss``, two AdamW steps' losses within 1e-5
  relative, greedy ``generate`` tokens equal, and the routing telemetry
  of an eager forward equal;
- the stacked layout with MoE raises the JAX package's error.

Limits.  fp32: the routing's softmax may differ in the last bit between
the two packages (their ``exp``), so combine (the renormalised top-k
probabilities, exact products with 0 and 1 otherwise) and aux within
1e-6; the expert products and the logits differ in summation order only,
1e-5 of the output's scale.  bf16: both sides round the expert input
(exact: one token a slot), the hidden activation, its tanh-GELU, the
expert output and the combined output to bf16, each at most 2^-8 of
its value; where the two sides' fp32 values sit across a rounding
boundary they part by one bf16 step there, which the later products
carry, so the output is held to ``2^-5 (|ref| + mean|ref|)``: four bf16
steps of the element and of the row's scale.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmonitor
from paddle_tpu import parallel as jparallel
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import moe as jmoe

from paddle_tpu_torch import monitor
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.models.gpt import GPTMoEMLP
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import moe
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


MOE = dict(moe_every_n=2, moe_num_experts=4)
B, S, NEW = 4, 12, 6
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_device_mesh():
    jparallel.init_mesh()       # no leaked 'ep' axis: the local branch


@pytest.mark.parametrize("n,e,k,cf", [(40, 4, 2, 1.25), (8, 8, 2, 1.25),
                                      (3, 4, 1, 1.0), (8192, 8, 2, 1.25),
                                      (5, 4, 2, 0.1)])
def test_moe_capacity(n, e, k, cf):
    assert moe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(n, e, k, cf)


def _logits(case, n=40, e=4):
    rng = np.random.RandomState(3)
    if case == "zero_gate":
        return np.zeros((n, e), np.float32)
    x = rng.randn(n, e).astype(np.float32)
    if case == "overflow":
        x[:, 1] += 3.0          # most first choices on expert 1
    return x


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("case", ["seeded", "zero_gate", "overflow"])
def test_routing_matches_jax(case, top_k):
    logits = _logits(case)
    n, e = logits.shape
    cap = moe.moe_capacity(n, e, top_k, 1.25)
    jd, jc, ja = jmoe._routing(logits, e, top_k, cap)
    d, c, a = moe._routing(torch.from_numpy(logits), e, top_k, cap)
    assert d.shape == c.shape == (n, e, cap) and d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), rtol=0, atol=1e-6)
    per_expert = d.sum((0, 2)).tolist()
    if case == "seeded":
        assert sum(per_expert) == n * top_k
    elif case == "overflow":            # dropped at capacity
        assert sum(per_expert) < n * top_k and max(per_expert) == cap
    else:                               # ties: the lowest experts, full
        assert per_expert == [cap] * top_k + [0] * (e - top_k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_arrays_matches_jax(dtype):
    import jax.numpy as jnp
    rng = np.random.RandomState(4)
    e, h, m = 4, 16, 32
    x = rng.randn(2, 10, h).astype(np.float32)
    logits = rng.randn(2, 10, e).astype(np.float32)
    w_in = (rng.randn(e, h, m) * 0.2).astype(np.float32)
    w_out = (rng.randn(e, m, h) * 0.2).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jy, jaux = jmoe.moe_mlp_arrays(*(jnp.asarray(a, jdt) for a in
                                     (x, logits, w_in, w_out)))
    y, aux = moe.moe_mlp_arrays(*(torch.from_numpy(a).to(tdt) for a in
                                  (x, logits, w_in, w_out)))
    assert y.dtype == tdt and y.shape == x.shape
    want = np.asarray(jnp.asarray(jy, jnp.float32))
    got = y.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        limit = 2.0 ** -5 * (np.abs(want) + np.abs(want).mean())
        assert (np.abs(got - want) <= limit).all()
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=0, atol=1e-6)


# -- the MoE test GPT ---------------------------------------------------------

@pytest.fixture(scope="module")
def gpts():
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(sequence_parallel=False, **MOE))
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    pm = GPTForCausalLM(gpt_test_config(**MOE), device="cpu")
    pm.load_params(params_from_numpy(state, device="cpu"))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (B, S)).astype(np.int32)
    labels = rng.randint(0, 128, (B, S)).astype(np.int32)
    return jm, pm, state, ids, labels


def _moe_blocks(model):
    return [i for i, blk in enumerate(model.gpt.h)
            if isinstance(blk.mlp, GPTMoEMLP)]


def test_moe_gpt_state_dict_names(gpts):
    jm, pm, state, _, _ = gpts
    assert set(pm.state_dict()) == set(state)
    assert _moe_blocks(pm) == [1]
    e, h, m = 4, pm.cfg.hidden_size, pm.cfg.intermediate_size
    for name, shape in (("w_in", (e, h, m)), ("w_out", (e, m, h)),
                        ("gate.weight", (h, e)), ("gate.bias", (e,))):
        assert tuple(pm.state_dict()[f"gpt.h_1.mlp.{name}"].shape) == shape
        assert state[f"gpt.h_1.mlp.{name}"].shape == shape


def test_moe_gpt_logits_aux_and_routing_telemetry(gpts):
    jm, pm, _, ids, _ = gpts
    for mon in (jmonitor, monitor):
        mon.enable(True)
        mon.reset()
    try:
        jm.eval()
        want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
        with torch.no_grad():
            got = pm(torch.from_numpy(ids)).numpy()
        snaps = [{k: v for k, v in mon.snapshot().items()
                  if k.startswith("moe/")} for mon in (jmonitor, monitor)]
    finally:
        for mon in (jmonitor, monitor):
            mon.reset()
            mon.refresh()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    jaux = float(jm.gpt.h_1.mlp.aux_loss.numpy())
    np.testing.assert_allclose(pm.gpt.h_1.mlp.aux_loss.item(), jaux,
                               rtol=0, atol=1e-6)
    assert pm.gpt.h_0.mlp.__class__.__name__ == "GPTMLP"
    assert set(snaps[1]) == {"moe/tokens_per_expert", "moe/dropped_tokens",
                             "moe/imbalance"}
    assert snaps[1] == snaps[0]
    assert snaps[1]["moe/tokens_per_expert"]["count"] == 4     # experts


def test_two_adamw_steps_match_jax(gpts):
    jm, _, state, ids, labels = gpts    # the fixture's JAX model, reloaded
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    jm.train()
    pm = GPTForCausalLM(gpt_test_config(**MOE), device="cpu")
    pm.load_params(params_from_numpy(state, device="cpu"))
    jcrit, crit = JaxCriterion(), GPTPretrainingCriterion()
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    opt = AdamW(learning_rate=LR, parameters=pm.parameters())
    for step in range(2):
        jloss = jcrit(jm(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        loss = crit(pm(torch.from_numpy(ids)), torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        want = float(jloss.numpy())
        assert abs(loss.item() - want) <= 1e-5 * abs(want), step
        assert np.isfinite(pm.gpt.h_1.mlp.aux_loss.item())


def test_moe_gpt_greedy_generate_matches_jax(gpts):
    jm, pm, state, ids, _ = gpts
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pm.load_params(params_from_numpy(state, device="cpu"))
    jm._gen_step = None
    want = np.asarray(jm.generate(paddle.to_tensor(ids),
                                  max_new_tokens=NEW).numpy())
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (B, S + NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stacked_moe_raises_as_jax():
    with pytest.raises(ValueError) as jax_err:
        JaxGPT(jax_test_config(sequence_parallel=False, stacked_blocks=True,
                               **MOE))
    with pytest.raises(ValueError) as port_err:
        GPTForCausalLM(gpt_test_config(stacked_blocks=True, **MOE),
                       device="cpu")
    assert str(port_err.value) == str(jax_err.value)
