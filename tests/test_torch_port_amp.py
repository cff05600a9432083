"""paddle_tpu_torch.amp against the JAX package's `paddle_tpu.amp`, on the
CPU.

- Three bf16 training steps of the per-layer test GPT with `GradScaler`
  (init 2^15) and the recipe's clipped AdamW, in both packages: O1 under
  ``PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1`` (configuration A's path; the JAX
  kernels in interpret mode) and without them, and O2 after `decorate`.
  Each JAX run is made once per module and shared.  bf16 tolerances:
  losses within 2^-11 relative (an fp32 mean over 64 positions of values
  that each package computes from activations it rounds to bf16 at the
  same points, from fp32 sums in different orders; an activation may land
  on the neighbouring bf16 value, 2^-8 of it, which the mean averages
  down; measured up to 1.2e-4); the unscaled step-1 gradients, per
  tensor, within 2^-5 of the JAX gradient's L2 norm in L2 (measured
  1.3-1.4 %, most of it in the key slice of ``qkv_proj.bias``, whose
  gradient is rounding noise in both packages); weights after three steps
  within 2 lr a step (Adam's normalised step maps bf16 noise in a small
  gradient to a step of up to lr); the loss scale the same.
- The per-op dtypes under O1 and O2, op by op against the JAX ops on the
  same inputs (``lm_head`` stays fp32 under O1).
- An injected inf skips the step and halves the scale after
  ``decr_every_n_nan_or_inf`` bad steps, as in JAX.
- The unscaled gradients of bf16 parameters stay fp32 (torch keeps
  ``.grad`` in bf16; the optimizer reads the fp32 ones), and the step
  they drive matches JAX's within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import pallas_ops as jpo

import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)

CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
STEPS, LR = 3, 1e-3
FLAGS = {"PTPU_PALLAS_LN": "1", "PTPU_PALLAS_FFN": "1",
         "PTPU_PALLAS_INTERPRET": "1"}
RUNS = {"O1_flags": ("O1", True), "O1": ("O1", False), "O2": ("O2", False)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (2, 32)).astype(np.int32),
            rng.randint(0, 128, (2, 32)).astype(np.int32))


def _recipe(mod, params):
    return mod.AdamW(learning_rate=LR, beta2=0.95, weight_decay=0.1,
                     grad_clip=mod.ClipGradByGlobalNorm(1.0),
                     parameters=params)


def _jax_run(level, flags, mp):
    if flags:
        for k, v in FLAGS.items():
            mp.setenv(k, v)
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jmodel.train()
    init = {k: _np(v.numpy()) for k, v in jmodel.state_dict().items()}
    if level == "O2":
        jamp.decorate(models=jmodel, level="O2", dtype="bfloat16")
    opt = _recipe(jopt, jmodel.parameters())
    scaler = jamp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, labels = _batch()
    losses, scales, grads = [], [], None
    for step in range(STEPS):
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            loss = JaxCriterion()(jmodel(paddle.to_tensor(ids)),
                                  paddle.to_tensor(labels))
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        if step == 0:
            grads = {n: _np(p.grad._data)
                     for n, p in jmodel.named_parameters()}
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        scales.append(scaler._scale)
    final = {k: _np(v.numpy()) for k, v in jmodel.state_dict().items()}
    return dict(init=init, final=final, losses=losses, scales=scales,
                grads=grads)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, (level, flags) in RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            out[name] = _jax_run(level, flags, mp)
    return out


@pytest.mark.parametrize("run", sorted(RUNS))
def test_amp_steps_match_jax(run, jax_runs, monkeypatch):
    level, flags = RUNS[run]
    want = jax_runs[run]
    if flags:
        for k, v in FLAGS.items():
            monkeypatch.setenv(k, v)
    model = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    model.load_params(params_from_numpy(want["init"], device="cpu"))
    if level == "O2":
        tamp.decorate(model, level="O2", dtype="bfloat16")
        assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    opt = _recipe(topt, model.named_parameters())
    scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 15)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    losses, scales = [], []
    for step in range(STEPS):
        with tamp.auto_cast(level=level, dtype="bfloat16"):
            loss = GPTPretrainingCriterion()(model(ids), labels)
        assert loss.dtype == torch.float32
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        if step == 0:
            for n, p in model.named_parameters():
                g, w = opt._grad(p), want["grads"][n]
                assert g.dtype == torch.float32, n
                err = np.linalg.norm(g.numpy() - w)
                assert err <= 2.0 ** -5 * np.linalg.norm(w), (n, err)
        scaler.step(opt)
        opt.clear_grad()
        losses.append(loss.item())
        scales.append(scaler._scale)
    assert scales == want["scales"] == [2.0 ** 15] * STEPS
    np.testing.assert_allclose(losses, want["losses"], rtol=2.0 ** -11)
    assert losses[-1] < losses[0]
    got = params_to_numpy(model)
    assert set(got) == set(want["final"])
    for n, w in want["final"].items():
        np.testing.assert_allclose(got[n], w, atol=2 * LR * STEPS, rtol=0,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# per-op dtypes
# ---------------------------------------------------------------------------

def _pair(shape, dtype, seed):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (Tensor(jnp.asarray(a, jnp.dtype(dtype))),
            torch.from_numpy(a).to(getattr(torch, dtype)))


OPS = {
    "linear": (lambda m, x, w, b: (JF if m == "jax" else PF).linear(x, w, b),
               [((4, 8), "float32"), ((8, 6), "float32"), ((6,), "float32")]),
    "linear_bf16_x": (lambda m, x, w: (JF if m == "jax" else PF).linear(x, w),
                      [((4, 8), "bfloat16"), ((8, 6), "float32")]),
    "layer_norm": (lambda m, x, w, b: (JF if m == "jax" else PF).layer_norm(
        x, 8, w, b), [((4, 8), "bfloat16"), ((8,), "float32"),
                      ((8,), "float32")]),
    "softmax": (lambda m, x: (JF if m == "jax" else PF).softmax(x),
                [((4, 8), "bfloat16")]),
    "embedding": (lambda m, w: (JF.embedding(Tensor(jnp.arange(3)), w)
                                if m == "jax" else
                                PF.embedding(torch.arange(3), w)),
                  [((5, 8), "float32")]),
    "flash_attention": (lambda m, q, k, v: (
        jpo.flash_attention(q, k, v, is_causal=True) if m == "jax" else
        PF.flash_attention(q, k, v, is_causal=True)),
        [((1, 16, 2, 64), "float32")] * 3),
}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_dtypes_match_jax(op, level):
    fn, specs = OPS[op]
    pairs = [_pair(s, d, i) for i, (s, d) in enumerate(specs)]
    with jamp.auto_cast(level=level):
        want = str(fn("jax", *[j for j, _ in pairs]).dtype)
    with tamp.auto_cast(level=level):
        got = str(fn("port", *[t for _, t in pairs]).dtype)
    assert got.replace("torch.", "") == want.replace("paddle.", "")


def test_cross_entropy_runs_in_fp32_under_amp():
    j, t = _pair((4, 10), "bfloat16", 3)
    labels = np.array([1, 2, 3, 4], np.int32)
    with jamp.auto_cast():
        want = JF.cross_entropy(j, Tensor(jnp.asarray(labels)))
    with tamp.auto_cast():
        got = PF.cross_entropy(t, torch.from_numpy(labels))
        assert tamp.cast_plan("cross_entropy", [t]) == (torch.float32,)
    assert got.dtype == torch.float32 and "float32" in str(want.dtype)
    np.testing.assert_allclose(got.item(), float(want.numpy()), rtol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_model_dtypes_under_amp(level, stacked):
    """``lm_head`` (neither list) stays fp32 under O1 and is cast under O2;
    the stacked blocks (one op, ``gpt_stacked_blocks``) likewise; the
    loss is fp32 either way, as in JAX."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False,
                                    stacked_blocks=stacked, **CFG))
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=stacked, **CFG),
                           device="cpu")
    ids = np.random.RandomState(1).randint(0, 128, (2, 8)).astype(np.int32)
    seen = []
    orig = tamp.cast_inputs

    def spy(name, *tensors):
        out = orig(name, *tensors)
        seen.append((name, tuple(str(t.dtype) for t in out
                                 if isinstance(t, torch.Tensor))))
        return out
    with jamp.auto_cast(level=level):
        want = jmodel(paddle.to_tensor(ids))
    import paddle_tpu_torch.models.gpt as pg
    with tamp.auto_cast(level=level):
        pg.cast_inputs, saved = spy, pg.cast_inputs
        try:
            got = model(torch.from_numpy(ids))
        finally:
            pg.cast_inputs = saved
    wanted = "bfloat16" if level == "O2" else "float32"
    assert got.dtype == getattr(torch, wanted)
    assert wanted in str(want.dtype)
    names = [n for n, _ in seen]
    assert names[-1] == "lm_head"
    assert set(seen[-1][1]) == {f"torch.{wanted}"}
    if stacked:
        blocks = dict(seen)["gpt_stacked_blocks"]
        assert set(blocks) == {f"torch.{wanted}"} and len(blocks) == 13


def test_cast_plan_matches_jax():
    for level in ("O1", "O2"):
        for name in ("linear", "layer_norm", "lm_head", "embedding",
                     "gpt_stacked_blocks", "softmax", "dropout"):
            for dt in ("float32", "bfloat16"):
                j, t = _pair((2,), dt, 0)
                with jamp.auto_cast(level=level):
                    want = jamp.cast_plan(name, [j._data])
                with tamp.auto_cast(level=level):
                    got = tamp.cast_plan(name, [t])
                want = None if want is None else tuple(
                    None if d is None else str(jnp.dtype(d)) for d in want)
                got = None if got is None else tuple(
                    None if d is None else str(d).replace("torch.", "")
                    for d in got)
                assert got == want, (level, name, dt)
    assert not tamp.is_auto_cast_enabled()
    with tamp.auto_cast(custom_white_list={"dropout"}, dtype="float16"):
        assert tamp.get_amp_dtype() == torch.float16
        assert "dropout" in tamp.WHITE_LIST
    assert "dropout" not in tamp.WHITE_LIST
    assert ptt.amp is tamp and tamp.amp_guard is tamp.auto_cast


# ---------------------------------------------------------------------------
# the scaler
# ---------------------------------------------------------------------------

SHAPES = [(5, 3), (4,)]


def _params(dtype):
    rng = np.random.RandomState(2)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jdt = jnp.dtype(dtype)
    return ([jnn.Parameter(jnp.asarray(a, jdt)) for a in init],
            [torch.nn.Parameter(torch.from_numpy(a).to(getattr(torch, dtype)))
             for a in init])


def test_injected_inf_skips_the_step_and_backs_off():
    jp, tp = _params("float32")
    jo, to = jopt.Adam(parameters=jp), topt.Adam(parameters=tp)
    js = jamp.GradScaler(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=2,
                         incr_every_n_steps=2)
    ts = tamp.GradScaler(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=2,
                         incr_every_n_steps=2)
    rng = np.random.RandomState(3)
    bad_steps = {1, 2, 5}
    trace = {"jax": [], "port": []}
    for step in range(7):
        gs = [rng.randn(*s).astype(np.float32) * 1024 for s in SHAPES]
        if step in bad_steps:
            gs[step % 2].flat[0] = np.inf if step != 5 else np.nan
        for a, b, g in zip(jp, tp, gs):
            a.grad = Tensor(jnp.asarray(g))
            b.grad = torch.from_numpy(g)
        before = [b.detach().clone() for b in tp]
        js.step(jo)
        ts.step(to)
        jo.clear_grad()
        to.clear_grad()
        trace["jax"].append((js._scale, jo._step_count))
        trace["port"].append((ts._scale, to._step_count))
        if step in bad_steps:
            assert all(torch.equal(x, y) for x, y in zip(before, tp))
    assert trace["port"] == trace["jax"]
    # bad steps 1, 2: halved at the second; good 3, 4: doubled; 5 bad
    assert [s for s, _ in trace["port"]] == [1024.0, 1024.0, 512.0, 512.0,
                                             1024.0, 1024.0, 1024.0]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.detach().numpy(), _np(a._data),
                                   rtol=1e-6)
    assert ts.state_dict() == js.state_dict()


def test_unscaled_bf16_grads_stay_fp32():
    jp, tp = _params("bfloat16")
    jo, to = jopt.AdamW(parameters=jp), topt.AdamW(parameters=tp)
    js, ts = jamp.GradScaler(), tamp.GradScaler()
    rng = np.random.RandomState(4)
    gs = [(rng.randn(*s) * 2.0 ** 15).astype(np.float32) for s in SHAPES]
    for a, b, g in zip(jp, tp, gs):
        a.grad = Tensor(jnp.asarray(g, jnp.bfloat16))
        b.grad = torch.from_numpy(g).bfloat16()
    js.unscale_(jo)
    ts.unscale_(to)
    for a, b in zip(jp, tp):
        assert b.grad.dtype == torch.bfloat16       # torch keeps it so
        g = to._grad(b)
        assert g.dtype == torch.float32
        assert "float32" in str(a.grad._data.dtype)
        np.testing.assert_array_equal(g.numpy(), _np(a.grad._data))
        np.testing.assert_array_equal(
            g.numpy(), b.grad.float().numpy() / 2.0 ** 15)
    js.step(jo)
    ts.step(to)
    assert not to._unscaled_grads
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(to._master_weights[id(b)].numpy(),
                                   _np(jo._master_weights[id(a)]),
                                   rtol=1e-6)
        assert b.dtype == torch.bfloat16


def test_scaler_disabled_and_state():
    _, tp = _params("float32")
    to = topt.SGD(parameters=tp)
    ts = tamp.GradScaler(enable=False)
    loss = torch.tensor(2.0)
    assert ts.scale(loss) is loss and not ts.is_enable()
    for p in tp:
        p.grad = torch.ones_like(p)
    ts.step(to)
    assert to._step_count == 1
    s = tamp.GradScaler(init_loss_scaling=8.0)
    s.load_state_dict({"scale": 4.0, "incr_count": 3, "decr_count": 1})
    assert s.get_loss_scaling().item() == 4.0
    assert s.state_dict()["incr_count"] == 3
    s.backoff()
    assert s._scale == 2.0 and s.is_use_dynamic_loss_scaling()
