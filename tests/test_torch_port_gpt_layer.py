"""The port's GPT classes are `nn.Layer`s with the JAX package's layer
methods, held against the JAX package on the CPU.

On the 2-layer test GPT (per-layer, and stacked where the layout allows):
every GPT class is a `Layer`; `parameters()` is a list of the same shapes
in the same order as JAX's; `named_sublayers`, `sublayers`, `full_name`
and `state_dict`'s names are JAX's; `set_state_dict` takes the JAX
model's numpy state and then the logits agree (1e-5); `clear_gradients`
drops every gradient after a backward in both packages; `astype` casts
every parameter in both; and `paddle_tpu_torch.models` exports
`GPTModel`, as `paddle_tpu.models` does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion

import paddle_tpu_torch.models as pmodels
from paddle_tpu_torch.models import gpt as pgpt
from paddle_tpu_torch.nn.layer import Layer

CFG = dict(num_hidden_layers=2)
GPT_CLASSES = ("GPTPretrainingCriterion", "GPTEmbeddings", "GPTAttention",
               "GPTMLP", "GPTMoEMLP", "GPTBlock", "GPTModel",
               "GPTForCausalLM")


def _pair(stacked=False):
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(stacked_blocks=stacked, **CFG))
    pm = pgpt.GPTForCausalLM(pgpt.gpt_test_config(stacked_blocks=stacked,
                                                  **CFG), device="cpu")
    return jm, pm


def _jax_state(jm):
    return {n: np.asarray(t.numpy(), np.float32)
            for n, t in jm.state_dict().items()}


@pytest.mark.parametrize("name", GPT_CLASSES)
def test_gpt_classes_are_layers(name):
    assert issubclass(getattr(pgpt, name), Layer)


def test_models_export_gpt_model():
    assert pmodels.GPTModel is pgpt.GPTModel
    assert "GPTModel" in pmodels.__all__


@pytest.mark.parametrize("stacked", [False, True])
def test_parameters_is_a_list_as_in_jax(stacked):
    jm, pm = _pair(stacked)
    jp, pp = jm.parameters(), pm.parameters()
    assert isinstance(jp, list) and isinstance(pp, list)
    assert len(pp) == len(jp)
    if not stacked:        # the stacked layout names its arrays apart
        assert [tuple(p.shape) for p in pp] == [tuple(p.shape) for p in jp]


def test_sublayers_names_and_state_dict_names_are_jax():
    jm, pm = _pair()
    assert [n for n, _ in pm.named_sublayers()] == \
        [n for n, _ in jm.named_sublayers()]
    assert len(pm.sublayers()) == len(jm.sublayers())
    assert len(pm.sublayers(include_self=True)) == len(pm.sublayers()) + 1
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert pm.full_name().startswith("gptforcausallm_")
    assert jm.full_name().startswith("gptforcausallm_")
    assert isinstance(pm.gpt.h[0].attn, pgpt.GPTAttention)


def test_set_state_dict_takes_the_jax_state():
    """The JAX model's numpy state into the port: nothing missing or
    unexpected, and the logits of both packages agree."""
    jm, pm = _pair()
    missing, unexpected = pm.set_state_dict(_jax_state(jm))
    assert missing == [] and unexpected == []
    ids = np.random.RandomState(0).randint(0, 128, (2, 16)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_clear_gradients_and_astype_as_in_jax():
    """After a backward (the JAX parameters given gradients of the same
    shapes directly: an eager JAX backward compiles each op, ~20 s) both
    packages' `clear_gradients` drop them all; the losses agree."""
    jm, pm = _pair()
    pm.set_state_dict(_jax_state(jm))
    ids = np.random.RandomState(1).randint(0, 128, (2, 8)).astype(np.int32)
    jloss = JaxCriterion()(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    for p in jm.parameters():
        p.grad = paddle.ones_like(p)
    loss = pgpt.GPTPretrainingCriterion()(pm(torch.from_numpy(ids)),
                                          torch.from_numpy(ids))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), atol=1e-5)
    assert all(p.grad is not None for p in jm.parameters())
    assert all(p.grad is not None for p in pm.parameters())
    jm.clear_gradients()
    pm.clear_gradients()
    assert all(p.grad is None for p in jm.parameters())
    assert all(p.grad is None for p in pm.parameters())
    assert jm.astype("bfloat16") is jm
    assert pm.astype("bfloat16") is pm
    assert {str(p.dtype) for p in jm.parameters()} == {"bfloat16"}
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16}
