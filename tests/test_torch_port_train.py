"""paddle_tpu_torch's training path against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

- the plain flash backward against the JAX Pallas backward kernels
  (`_flash_bwd`, run in interpret mode) on the JAX forward's out and lse;
- the `FlashAttention` autograd Function against `jax.grad` of the JAX
  `flash_attention_arrays` (off the TPU that is `mha_reference`);
- `cross_entropy` and `GPTPretrainingCriterion`, loss and logits gradient;
- `AdamW` (and `Adam`) alone, float32 and bfloat16 with float32 masters;
- three whole training steps of the test GPT.

Tolerances: 1e-5 absolute for attention gradients and training losses
(fp32, the frameworks reduce in different orders); 1e-6 for the loss and
its gradient; 1e-6 relative for optimizer moments and masters (the same
fp32 arithmetic on the same values, up to a few ulps).  The weights after
three steps agree to 1e-5 except the key slice of ``qkv_b``: softmax is
blind to the key bias, so its gradient is rounding noise (~1e-9) in both
frameworks, and Adam's normalised step turns noise of either sign into a
step of up to ``lr`` per step; that slice is held to ``2 * lr * steps``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import LLMEngine as JaxEngine

from paddle_tpu_torch import ops, optimizer
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# flash attention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [128, 256])
def test_flash_bwd_reference_matches_jax_pallas_kernels(s, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    b, h, d = 2, 2, 64
    scale = d ** -0.5
    rng = np.random.RandomState(s)
    q, k, v, do = (rng.randn(b, s, h, d).astype(np.float32) * 0.5
                   for _ in range(4))
    qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a))
                       for a in (q, k, v, do))
    # 128-row tiles: at S=256 the causal loop bounds of both kernels run
    of, lse = jpo._flash_fwd(qf, kf, vf, True, scale, block_q=128,
                             block_k=128)
    want = jpo._flash_bwd(qf, kf, vf, of, lse, dof, True, scale,
                          block_q=128, block_k=128)
    out = _np(jpo._unfold_heads(of, b, h))
    got = fa.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(out), _t(_np(lse).reshape(b, h, s)),
        _t(do), scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(jpo._unfold_heads(w, b, h)),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("s", [5, 17, 128])
def test_flash_autograd_matches_jax_grad(s):
    b, h, d = 2, 3, 64
    rng = np.random.RandomState(s + 1)
    q, k, v, g = (rng.randn(b, s, h, d).astype(np.float32)
                  for _ in range(4))

    def loss(q, k, v):
        return jnp.sum(jpo.flash_attention_arrays(q, k, v, is_causal=True)
                       * jnp.asarray(g))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ops.reset_launch_counts()
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention_arrays(qt, kt, vt, is_causal=True)
    assert out.grad_fn is not None and "FlashAttention" in out.grad_fn.name()
    out.backward(_t(g))
    for name, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert set(ops.launch_counts().values()) == {0}


def test_flash_no_grad_path_is_not_recorded():
    q, k, v = (torch.randn(1, 9, 2, 16, requires_grad=True)
               for _ in range(3))
    with torch.no_grad():
        out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    assert out.grad_fn is None
    out2 = fa.flash_attention_arrays(q.detach(), k.detach(), v.detach(),
                                     is_causal=True)
    np.testing.assert_array_equal(out.numpy(), out2.numpy())


def test_bwd_wrappers_on_cpu_compute_the_plain_backward():
    rng = np.random.RandomState(3)
    q, k, v, do = (_t(rng.randn(1, 11, 2, 64).astype(np.float32))
                   for _ in range(4))
    out, lse = fa.flash_attention_arrays(q, k, v, is_causal=True,
                                         return_lse=True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, 0.125)
    delta = fa.attention_delta(out, do)
    ops.reset_launch_counts()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, 0.125)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, 0.125)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, atol=0, rtol=0)
    assert set(ops.launch_counts()) == {
        "flash_fwd_causal", "flash_fwd_causal:mask", "flash_fwd_causal:segs",
        "flash_fwd_causal:noncausal", "flash_fwd_causal:tc",
        "flash_fwd_causal:tc16", "flash_fwd_causal:tc32",
        "flash_bwd_dq_causal", "flash_bwd_dq_causal:mask",
        "flash_bwd_dq_causal:segs", "flash_bwd_dq_causal:noncausal",
        "flash_bwd_dq_causal:tc", "flash_bwd_dq_causal:tc16",
        "flash_bwd_dq_causal:tc32", "flash_bwd_dkv_causal",
        "flash_bwd_dkv_causal:mask", "flash_bwd_dkv_causal:segs",
        "flash_bwd_dkv_causal:noncausal", "flash_bwd_dkv_causal:tc",
        "flash_bwd_dkv_causal:tc16", "flash_bwd_dkv_causal:tc32",
        "ragged_paged_attention", "ragged_paged_attention:int8",
        "ragged_paged_attention:fp16", "ragged_paged_attention:int8:fp16",
        "flash_decode", "flash_decode:fp16", "fused_decode_layer",
        "fused_layernorm", "fused_layernorm_bwd", "fused_ffn",
        "fused_ffn_tc", "fused_ffn_tc32", "fused_ffn_decode",
        "fused_layernorm:fp16", "fused_layernorm_bwd:fp16", "fused_ffn:fp16",
        "fused_ffn_tc:fp16", "fused_ffn_decode:fp16",
        "flash_fwd_causal:d256", "flash_fwd_causal:simt",
        "ragged_paged_attention:d256", "ragged_paged_attention:int8:d256",
        "flash_decode:d256", "fused_decode_layer:d256",
        "flash_bwd_dq_causal:d256", "flash_bwd_dq_causal:simt",
        "flash_bwd_dkv_causal:d256", "flash_bwd_dkv_causal:simt",
        "threefry_bernoulli", "flash_fwd_causal:wide",
        "flash_bwd_dq_causal:wide", "flash_bwd_dkv_causal:wide"}
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _loss_inputs(seed, ignored, masked):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(2, 7, 33) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (2, 7)).astype(np.int32)
    if ignored:
        labels[0, :3] = -100
        labels[1, 5] = -100
    mask = (rng.rand(2, 7) > 0.4).astype(np.float32) if masked else None
    return logits, labels, mask


@pytest.mark.parametrize("ignored", [False, True])
@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_cross_entropy_matches_jax(ignored, reduction):
    logits, labels, _ = _loss_inputs(11, ignored, False)
    want = JF.cross_entropy(paddle.to_tensor(logits),
                            paddle.to_tensor(labels), reduction=reduction)
    got = cross_entropy(_t(logits), _t(labels), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), _np(want.numpy()), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("ignored", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pretraining_criterion_matches_jax(ignored, masked):
    logits, labels, mask = _loss_inputs(12, ignored, masked)
    jl = paddle.to_tensor(logits, stop_gradient=False)
    want = JaxCriterion()(jl, paddle.to_tensor(labels),
                          None if mask is None else paddle.to_tensor(mask))
    want.backward()
    tl = _t(logits).requires_grad_()
    got = GPTPretrainingCriterion()(tl, _t(labels),
                                    None if mask is None else _t(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want.numpy()), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), _np(jl.grad.numpy()),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["AdamW", "Adam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(dtype, family):
    """AdamW's decoupled decay, and Adam's coupled L2 decay (added to the
    gradient by the base class), both with weight_decay 0.1."""
    rng = np.random.RandomState(7)
    shapes = [(5, 3), (4,), (2, 3, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jparams = [jnn.Parameter(jnp.asarray(a, jdt)) for a in init]
    tparams = [torch.nn.Parameter(_t(a).to(tdt)) for a in init]
    jopt = getattr(jax_optimizer, family)(
        learning_rate=1e-2, weight_decay=0.1, parameters=jparams)
    topt = getattr(optimizer, family)(
        learning_rate=1e-2, weight_decay=0.1, parameters=tparams)
    for step_grads in grads:
        for jp, tp, gr in zip(jparams, tparams, step_grads):
            jp.grad = Tensor(jnp.asarray(gr, jdt))
            tp.grad = _t(gr).to(tdt)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
    for jp, tp in zip(jparams, tparams):
        assert tp.grad is None and tp.dtype == tdt
        js, ts = jopt._states[id(jp)], topt._states[id(tp)]
        for slot in ("moment1", "moment2"):
            np.testing.assert_allclose(ts[slot].numpy(), _np(js[slot]),
                                       rtol=1e-6, atol=0, err_msg=slot)
        if dtype == "bfloat16":
            np.testing.assert_allclose(
                topt._master_weights[id(tp)].numpy(),
                _np(jopt._master_weights[id(jp)]), rtol=1e-6, atol=0)
        else:
            assert not topt._master_weights
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   _np(jp._data.astype(jnp.float32)),
                                   rtol=1e-6, atol=0)


def test_adamw_lr_accessors_and_bias_correction():
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = AdamW(learning_rate=0.1, weight_decay=0.0, parameters=[w])
    assert opt.get_lr() == pytest.approx(0.1)
    w.grad = torch.tensor([3.0])
    opt.step()
    # first step: m_hat / sqrt(v_hat) = sign(g)
    assert w.item() == pytest.approx(0.9, abs=1e-6)
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    opt.clear_grad(set_to_zero=True)
    assert w.grad is not None and w.grad.item() == 0.0


# ---------------------------------------------------------------------------
# the slice as a whole: three training steps of the test GPT
# ---------------------------------------------------------------------------

STEPS, LR = 3, 1e-3


def _jax_arrays(model):
    return {n: _np(a) for n, a in JaxEngine(model)._param_arrays().items()}


def test_three_training_steps_match_jax():
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(stacked_blocks=True,
                                    sequence_parallel=False))
    jmodel.train()
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True),
                           device="cpu").load_params(
        params_from_numpy(_jax_arrays(jmodel), device="cpu"))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, 24)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 24)).astype(np.int32)
    labels[1, :4] = -100
    jcrit, crit = JaxCriterion(), GPTPretrainingCriterion()
    jopt = JaxAdamW(learning_rate=LR, parameters=jmodel.parameters())
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    ops.reset_launch_counts()
    for step in range(STEPS):
        jloss = jcrit(jmodel(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        jloss.backward()
        jopt.step()
        jopt.clear_grad()
        loss = crit(model(_t(ids)), _t(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
    assert set(ops.launch_counts().values()) == {0}
    want, got = _jax_arrays(jmodel), params_to_numpy(model)
    assert set(got) == set(want)
    hidden = gpt_test_config().hidden_size
    for name in sorted(want):
        g, w = got[name], want[name]
        assert g.shape == w.shape, name
        if name == "qkv_b":
            kslice = slice(hidden, 2 * hidden)
            np.testing.assert_allclose(g[:, kslice], w[:, kslice],
                                       atol=2 * LR * STEPS, rtol=0)
            g, w = np.delete(g, kslice, 1), np.delete(w, kslice, 1)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)


def test_pretrain_loss_is_the_criterion_of_the_logits():
    model = GPTForCausalLM(gpt_test_config(num_hidden_layers=1,
                                           stacked_blocks=True),
                           device="cpu")
    rng = np.random.RandomState(5)
    ids = _t(rng.randint(0, 128, (2, 9)))
    labels = _t(rng.randint(0, 128, (2, 9)))
    mask = _t((rng.rand(2, 9) > 0.5).astype(np.float32))
    want = GPTPretrainingCriterion()(model(ids), labels, mask)
    got = model.pretrain_loss(ids, labels, loss_mask=mask)
    assert got.item() == want.item()
    assert all(p.requires_grad for p in model.parameters())
