"""paddle_tpu_torch's training of the per-layer GPT under PTPU_PALLAS_LN /
PTPU_PALLAS_FFN against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages.  The
JAX side takes its LN and FFN kernels only in interpret mode off a TPU, so
every test that sets the flags also sets ``PTPU_PALLAS_INTERPRET=1`` (per
test, by ``monkeypatch``).  The test GPT has ``hidden_size=128`` and four
heads (head_dim 32), so JAX attention takes its reference path and no
flash kernel runs in interpret mode.

- the plain LayerNorm backward against the JAX `_ln_vjp_bwd` Pallas
  kernel, at row counts that take each JAX row block (8, 128, 256);
- the LayerNorm and FFN autograd Functions against `jax.grad` of the JAX
  `fused_layernorm_arrays` / `fused_ffn_arrays`;
- the gates `ln_geometry_ok` / `ffn_geometry_ok` against the JAX ones;
- the final LayerNorm of the stacked model under ``PTPU_PALLAS_LN=1`` in
  bf16 (the fault repaired in this slice);
- the per-layer test GPT: ``state_dict`` names (and a short greedy
  ``generate`` with the JAX per-layer tokens), logits with the flags off
  and on, and three AdamW steps under both flags;
- the stacked model under ``PTPU_PALLAS_LN=1``: logits and greedy
  ``generate``.

Tolerances: the LayerNorm backward, float32, 1e-5 of each gradient's sum
over term magnitudes (`tolerance.ln_bwd_limits`; both sides compute in
fp32 and differ in summation order), bfloat16 outputs one bf16 step more.
The FFN gradients 1e-5 absolute plus 1e-5 relative (fp32 sums over 256
intermediate columns or 16 rows in different orders).  Logits 1e-5, and
three training steps 1e-5 in loss and weights, but for the weights whose
JAX gradient falls below ``GRAD_FLOOR`` = 1e-5 at some step (3 % of
them at step 1): the two packages' gradients differ by fp32 noise (~1e-8
in most tensors at step 1, measured), and Adam's
normalised step ``m / sqrt(v)`` turns a relative difference of the
gradient into the same relative difference of a step of up to ``lr``, so
below the floor the steps may differ by more than 1e-5 / 3.  Those
weights (among them the key slice of ``qkv_proj.bias``, whose gradient is
rounding noise in both packages, as in `test_torch_port_train.py`) are
held to ``2 * lr * steps``.  The final LayerNorm in bf16: within one bf16
step of each JAX output.  Greedy tokens identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import LLMEngine as JaxEngine

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.models import gpt as port_gpt
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import tolerance as tol
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import EngineConfig, LLMEngine

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MIXES = [("float32", "float32"), ("bfloat16", "bfloat16"),
         ("bfloat16", "float32")]
FLAGS = ("PTPU_PALLAS_LN", "PTPU_PALLAS_FFN")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _j(a, jdt=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def _assert_close(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _set_flags(monkeypatch, on):
    for name in FLAGS:
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")


def _ln_inputs(n, h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy = rng.randn(n, h).astype(np.float32)
    return x, w, b, dy


# ---------------------------------------------------------------------------
# the LayerNorm backward and the two autograd Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,pdt", MIXES)
@pytest.mark.parametrize("n", [24, 384, 512])      # JAX row block 8, 128, 256
def test_ln_bwd_reference_matches_jax_kernel(n, xdt, pdt, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    (jx, tx), (jp, tp) = DTYPES[xdt], DTYPES[pdt]
    x, w, b, dy = _ln_inputs(n, 256, n)
    ddt = torch.float32 if "float32" in (xdt, pdt) else torch.bfloat16
    jargs = (_j(x, jx), _j(w, jp), _j(b, jp))
    _, mu, rs = jpo._ln_fwd(*jargs, 1e-5)
    want = jpo._ln_vjp_bwd(1e-5, (*jargs, mu, rs), _j(dy, jnp.dtype(
        str(ddt)[6:])))
    args = (_t(x, tx), _t(w, tp), _t(_np(mu)), _t(_np(rs)), _t(dy, ddt))
    got = fm.fused_layernorm_bwd_reference(*args)
    assert [g.dtype for g in got] == [tx, tp, tp]
    want = [_t(_np(a), g.dtype) for a, g in zip(want, got)]
    limits = tol.ln_bwd_limits(got, want, *args)
    for name, g, wv, lim in zip(("dx", "dw", "db"), got, want, limits):
        _assert_close(g, wv, lim, f"{name} n={n} {xdt}/{pdt}")


@pytest.mark.parametrize("xdt,pdt", MIXES)
def test_layernorm_autograd_matches_jax_grad(xdt, pdt, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    (jx, tx), (jp, tp) = DTYPES[xdt], DTYPES[pdt]
    x, w, b, dy = _ln_inputs(16, 128, 3)
    x = x.reshape(2, 8, 128)
    ddt = torch.float32 if "float32" in (xdt, pdt) else torch.bfloat16
    g = _j(dy.reshape(2, 8, 128), jnp.dtype(str(ddt)[6:]))

    def loss(x, w, b):
        y = jpo.fused_layernorm_arrays(x, w, b, eps=1e-5)
        return jnp.sum((y * g).astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(x, jx), _j(w, jp),
                                             _j(b, jp))
    ops.reset_launch_counts()
    ins = [_t(x, tx).requires_grad_(), _t(w, tp).requires_grad_(),
           _t(b, tp).requires_grad_()]
    y = fm.fused_layernorm_arrays(*ins, eps=1e-5)
    assert y.dtype == ddt and y.shape == (2, 8, 128)
    y.backward(_t(dy.reshape(2, 8, 128), ddt))
    got = [t.grad for t in ins]
    want = [_t(_np(a), t.dtype) for a, t in zip(want, ins)]
    _, mu, rs = fm.fused_layernorm_reference(ins[0].detach().reshape(16, 128),
                                             ins[1].detach(), ins[2].detach())
    limits = tol.ln_bwd_limits([got[0].reshape(16, 128), *got[1:]],
                               [want[0].reshape(16, 128), *want[1:]],
                               ins[0].detach().reshape(16, 128),
                               ins[1].detach(), mu, rs,
                               _t(dy, ddt))
    for name, gv, wv, lim in zip(("dx", "dw", "db"), got, want, limits):
        _assert_close(gv.reshape(lim.shape), wv.reshape(lim.shape), lim,
                      name)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
def test_ffn_autograd_matches_jax_grad(act, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 128).astype(np.float32)
    w1 = (rng.randn(128, 256) / 12).astype(np.float32)
    b1 = (0.1 * rng.randn(256)).astype(np.float32)
    w2 = (rng.randn(256, 128) / 16).astype(np.float32)
    dy = rng.randn(2, 8, 128).astype(np.float32)

    def loss(*a):
        return jnp.sum(jpo.fused_ffn_arrays(*a, act=act) * jnp.asarray(dy))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w1, b1, w2)))
    ins = [_t(a).requires_grad_() for a in (x, w1, b1, w2)]
    y = fm.fused_ffn_arrays(*ins, act=act)
    np.testing.assert_allclose(
        y.detach().numpy(),
        _np(jpo.fused_ffn_arrays(*(jnp.asarray(a) for a in (x, w1, b1, w2)),
                                 act=act)), atol=1e-5, rtol=0)
    y.backward(_t(dy))
    for name, t, wv in zip(("dx", "dw1", "db1", "dw2"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), _np(wv), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("rows", [1, 8, 12, 128, 200, 256, 384, 8192])
def test_geometry_gates_match_jax(rows, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    for h in (64, 128, 200, 768):
        assert fm.ln_geometry_ok(rows, h) == jpo.ln_geometry_ok(rows, h)
        for i in (100, 256, 3072):
            for h2 in (h, 128):
                assert fm.ffn_geometry_ok(rows, h, i, h2) == \
                    jpo.ffn_geometry_ok(rows, h, i, h2), (rows, h, i, h2)


def test_maybe_fused_ffn_gate(monkeypatch):
    x = torch.randn(8, 128)
    w1, b1, w2 = torch.randn(128, 256), torch.randn(256), torch.randn(256, 128)
    monkeypatch.delenv("PTPU_PALLAS_FFN", raising=False)
    assert fm.maybe_fused_ffn(x, w1, b1, w2, "gelu") is None
    monkeypatch.setenv("PTPU_PALLAS_FFN", "1")
    torch.testing.assert_close(fm.maybe_fused_ffn(x, w1, b1, w2, "gelu"),
                               fm.fused_ffn_reference(x, w1, b1, w2, "gelu"),
                               atol=0, rtol=0)
    assert fm.maybe_fused_ffn(x, w1, None, w2, "gelu") is None
    assert fm.maybe_fused_ffn(x[:6], w1, b1, w2, "gelu") is None
    assert fm.maybe_fused_ffn(x.bfloat16(), w1, b1, w2, "gelu") is None


# ---------------------------------------------------------------------------
# the repaired final LayerNorm
# ---------------------------------------------------------------------------

def _bf16_steps(got, want):
    """|got - want| in bf16 steps of max(|got|, |want|)."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (tol.BF16_STEP * torch.maximum(g.abs(),
                                                           w.abs()))
            ).nan_to_num(nan=0.0)


def test_final_layer_norm_under_pallas_ln_matches_jax(monkeypatch):
    """The stacked model's ``ln_f`` under ``PTPU_PALLAS_LN=1``: the JAX
    ``F.layer_norm`` takes the kernel, which rounds once; the ungated
    `layer_norm_arrays` (what the port called before) rounds the
    normalised value to bf16 and then scales and shifts in bf16: 550 of
    the 2048 outputs differ, by up to 128 bf16 steps (2^-7 max(|a|,
    |b|)) where the output is near zero.  The gated `layer_norm` the
    model now calls is within one step (it gives JAX's bits)."""
    _set_flags(monkeypatch, True)
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(16, 128).astype(np.float32),
               rng.randn(128).astype(np.float32),
               rng.randn(128).astype(np.float32))
    jargs = [paddle.to_tensor(_j(a, jnp.bfloat16)) for a in (x, w, b)]
    want = _t(_np(JF.layer_norm(jargs[0], 128, jargs[1], jargs[2],
                                1e-5)._data), torch.bfloat16)
    args = [_t(a, torch.bfloat16) for a in (x, w, b)]
    old = PF.layer_norm_arrays(*args, 1e-5)
    assert _bf16_steps(old, want).max().item() > 1      # the fault
    calls = []
    real = port_gpt.layer_norm
    monkeypatch.setattr(port_gpt, "layer_norm",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                           device="cpu", dtype=torch.bfloat16)
    model(torch.zeros(1, 8, dtype=torch.long))
    assert len(calls) == 1                   # the final LN goes through it
    got = PF.layer_norm(*[args[0], 128, *args[1:]], 1e-5)
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got, want).max().item() <= 1


# ---------------------------------------------------------------------------
# the per-layer test GPT
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
STEPS, LR, GRAD_FLOOR = 3, 1e-3, 1e-5


def _jax_state(model):
    return {k: _np(v.numpy()) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_state():
    """A JAX per-layer test GPT and the port's, built from its
    ``state_dict``; each test takes fresh copies of the weights."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    return _jax_state(jmodel)


def _models(state):
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jmodel.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    model = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    model.load_params(params_from_numpy(state, device="cpu"))
    return jmodel, model


def test_per_layer_state_dict_names_match_jax(jax_state):
    assert not gpt_test_config().stacked_blocks
    assert not jax_test_config().stacked_blocks
    model = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    assert set(model.state_dict()) == set(jax_state)
    assert "gpt.h_1.mlp.fc_out.bias" in jax_state
    jmodel, loaded = _models(jax_state)
    for name, a in params_to_numpy(loaded).items():
        np.testing.assert_array_equal(a, jax_state[name], err_msg=name)
    with pytest.raises(ValueError, match="stacked"):
        JaxEngine(JaxGPT(jax_test_config(sequence_parallel=False)))
    with pytest.raises(ValueError, match="stacked"):
        LLMEngine(loaded, EngineConfig(device="cpu"))
    # the per-layer layout generates, with the JAX per-layer tokens
    ids = np.random.RandomState(5).randint(0, 128, (1, 4)).astype(np.int32)
    jmodel.eval()
    want = jmodel.generate(paddle.to_tensor(ids), max_new_tokens=3).numpy()
    got = loaded.generate(torch.from_numpy(ids), max_new_tokens=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Spy:
    """Counts the kernel-path calls of the per-layer model."""

    def __init__(self, monkeypatch):
        self.calls = {"layer_norm": 0, "ffn": 0}
        ln, ffn = PF.fused_layernorm_arrays, fm.fused_ffn_arrays

        def spy_ln(*a, **k):
            self.calls["layer_norm"] += 1
            return ln(*a, **k)

        def spy_ffn(*a, **k):
            self.calls["ffn"] += 1
            return ffn(*a, **k)
        monkeypatch.setattr(PF, "fused_layernorm_arrays", spy_ln)
        monkeypatch.setattr(fm, "fused_ffn_arrays", spy_ffn)


@pytest.mark.parametrize("flags", [False, True])
def test_per_layer_logits_match_jax(jax_state, flags, monkeypatch):
    _set_flags(monkeypatch, flags)
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    jmodel, model = _models(jax_state)
    jmodel.eval()
    ids = np.random.RandomState(1).randint(0, 128, (2, 8)).astype(np.int32)
    jpo.reset_attention_path_counts()
    want = _np(jmodel(paddle.to_tensor(ids)).numpy())
    paths = jpo.attention_path_counts()
    spy = _Spy(monkeypatch)
    got = model(torch.from_numpy(ids))
    layers = model.cfg.num_hidden_layers
    assert paths.get("ln_kernel", 0) == (2 * layers + 1 if flags else 0)
    assert paths.get("ffn_kernel", 0) == (layers if flags else 0)
    assert spy.calls == {"layer_norm": 2 * layers + 1 if flags else 0,
                         "ffn": layers if flags else 0}
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def test_three_training_steps_per_layer_match_jax(jax_state,
                                                  monkeypatch):
    _set_flags(monkeypatch, True)
    jmodel, model = _models(jax_state)
    jmodel.train()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, 8)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 8)).astype(np.int32)
    labels[1, :3] = -100
    jcrit, crit = JaxCriterion(), GPTPretrainingCriterion()
    jopt = JaxAdamW(learning_rate=LR, parameters=jmodel.parameters())
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    spy = _Spy(monkeypatch)
    ops.reset_launch_counts()
    small = {}                  # weights whose gradient fell below the floor
    for step in range(STEPS):
        jloss = jcrit(jmodel(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        jloss.backward()
        for name, p in jmodel.named_parameters():
            below = np.abs(_np(p.grad.numpy())) < GRAD_FLOOR
            small[name] = small.get(name, False) | below
        jopt.step()
        jopt.clear_grad()
        loss = crit(model(torch.from_numpy(ids)), torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
    layers = model.cfg.num_hidden_layers
    assert spy.calls == {"layer_norm": STEPS * (2 * layers + 1),
                         "ffn": STEPS * layers}
    assert set(ops.launch_counts().values()) == {0}
    want, got = _jax_state(jmodel), params_to_numpy(model)
    assert set(got) == set(want)
    hidden = CFG["hidden_size"]
    assert small["gpt.h_0.attn.qkv_proj.bias"][hidden:2 * hidden].all()
    for name in sorted(want):
        g, w, s = got[name], want[name], small[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[s], w[s], atol=2 * LR * STEPS, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g[~s], w[~s], atol=1e-5, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the stacked model under PTPU_PALLAS_LN
# ---------------------------------------------------------------------------

P, NEW = 6, 5


@pytest.mark.parametrize("b", [8, 3])
def test_stacked_model_under_pallas_ln_matches_jax(b, monkeypatch):
    """At B=8 both packages take the LN kernel for ``ln_f`` (48 prompt
    rows, then 8 per step); at B=3 (18 and 3 rows, no row block) both
    fall back, in the forward and in ``generate``."""
    monkeypatch.setenv("PTPU_PALLAS_LN", "1")
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(stacked_blocks=True,
                                    sequence_parallel=False, **CFG))
    jmodel.eval()
    arrays = {n: np.asarray(a)
              for n, a in JaxEngine(jmodel)._param_arrays().items()}
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                           device="cpu")
    model.load_params(params_from_numpy(arrays, device="cpu"))
    ids = np.random.RandomState(b).randint(0, 128, (b, P)).astype(np.int32)
    want = _np(jmodel(paddle.to_tensor(ids)).numpy())
    spy = _Spy(monkeypatch)
    got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    assert spy.calls["layer_norm"] == (1 if b == 8 else 0)
    jmodel._gen_step = None           # its jit cache ignores the env flags
    want = np.asarray(jmodel.generate(paddle.to_tensor(ids),
                                      max_new_tokens=NEW).numpy())
    calls = []
    real = port_gpt.fused_layernorm_arrays
    monkeypatch.setattr(port_gpt, "fused_layernorm_arrays",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    np.testing.assert_array_equal(out.numpy(), want)
    assert len(calls) == (NEW if b == 8 else 0)
