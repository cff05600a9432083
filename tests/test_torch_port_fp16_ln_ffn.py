"""float16 through paddle_tpu_torch's LayerNorm and fused FFN, on the CPU,
against the JAX package; the fp16 limits of
`paddle_tpu_torch.ops.tolerance` for them, emulated.

The same numpy inputs, made from a seed, go through both packages:

(a) the plain LayerNorm forward and backward (`fused_layernorm_reference`,
    `fused_layernorm_bwd_reference`) against the JAX Pallas kernels
    `_ln_fwd` / `_ln_vjp_bwd` in interpret mode (``PTPU_PALLAS_INTERPRET=1``)
    with fp16 x and w, fp16 x and fp32 w, fp32 x and fp16 w; the plain FFN
    and its autograd backward against `fused_ffn_2d` and its VJP, gelu,
    gelu_tanh and relu.
(b) the per-layer test GPT (2 layers, hidden 256, 8 heads of 32 -- JAX
    attention takes its reference path --, I=512), its weights carried by
    `convert`, cast to fp16 by each package's ``amp.decorate(level="O2")``,
    under ``PTPU_PALLAS_LN=1 PTPU_PALLAS_FFN=1``: the forward (both
    packages through their LN and FFN kernel paths), one pure-fp16
    training step (no ``auto_cast``: the LN backward in fp16) and greedy
    ``generate``, every port token teacher-forced through JAX's dense
    forward; and under ``auto_cast`` O2 which kernel paths each package
    takes (the LayerNorm in fp32 by the black list; the FFN gate sees the
    fp32 LayerNorm output beside the fp16 weights and refuses, in both).
(c) the launchers on fp16: `ffn_design` sends fp16 where bf16 goes (the
    tensor cores from `FFN_TC_MIN_ROWS` rows, the decode design below,
    never the fp32-only split-TF32 design); the five C entries get the
    element type as `_build.dtype_code` codes (the entries faked on the
    CPU) and each fp16 launch counts once more under ``<kernel>:fp16``;
    the gates admit fp16 on the CPU, where nothing launches.
(d) the fp16 limits on emulations of the kernels' arithmetic: the
    LayerNorm forward and backward computed in float64 (another summation
    order) and rounded once, the FFN with h rounded to fp16 from fp32
    values of float64 products; also where the outputs (LayerNorm) or h
    (FFN) are subnormal in fp16, the case of the limits' 2^-24 terms.

The JAX model's step runs once, in a module fixture, for the forward and
the training-step tests.

Tolerances.  LayerNorm forward: `tolerance.ln_limit` (one fp16 step of
the output, 2^-20 of the LN terms for fp32 noise, 2^-24 absolute) for an
fp16 y, 2e-5 absolute for an fp32 y; mu and rstd 1e-5 relative.  Its
backward: `tolerance.ln_bwd_limits` (1e-5 of each output's term
magnitudes, plus one fp16 step and 2^-24 for an fp16 output).  FFN
forward: `tolerance.ffn_limit` (fp16: both sides round h, 2^-10 of |h|
|W2|).  FFN gradients: `FFN_GRAD_STEPS` fp16 steps of the tensor's
largest JAX gradient (each side rounds the fp16 products h W2's
cotangent dh = dy W2^T and the output gradients once, from fp32 sums in
other orders).  Model logits: `LOGIT_STEPS` fp16 steps of max(|logit|,
1) (the packages round the same activations at the same points, from
fp32 sums in other orders, through two layers).  Training step: the loss
2^-10 relative, each gradient `GRAD_STEPS` fp16 steps of the tensor's
largest JAX gradient.  Tokens: each within `LOGIT_NOISE` (four fp16 steps
of max(|logit|, 1)) of JAX's top logit of the port's own prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.ops import pallas_ops as jpo

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import tolerance as tol
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


F16 = torch.float16
TYPES = {"float16": (jnp.float16, torch.float16),
         "float32": (jnp.float32, torch.float32)}
LN_PAIRS = [("float16", "float16"), ("float16", "float32"),
            ("float32", "float16")]
ACTS = ("gelu", "gelu_tanh", "relu")
FFN_GRAD_STEPS = 4
LOGIT_STEPS = 8
GRAD_STEPS = 16
LOGIT_NOISE = 4 * 2.0 ** -10
FLAGS = ("PTPU_PALLAS_LN", "PTPU_PALLAS_FFN")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _j(a, jdt=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(jdt)


def _within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _steps(got, want, steps):
    """Within ``steps`` fp16 steps (2^-10) of the larger of max|want| and
    the floor 2^-14 (fp16's smallest normal)."""
    scale = max(want.float().abs().max().item(), 2.0 ** -14)
    return steps * tol.FP16_STEP * scale


def _ln_inputs(n, h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    dy = rng.randn(n, h).astype(np.float32)
    return x, w, b, dy


# ---------------------------------------------------------------------------
# (a) the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xdt,pdt", LN_PAIRS)
def test_ln_plain_forward_and_backward_match_jax_kernels(xdt, pdt,
                                                         monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    (jx, tx), (jp, tp) = TYPES[xdt], TYPES[pdt]
    x, w, b, dy = _ln_inputs(128, 256, 7)        # the model's rows, width
    jargs = (_j(x, jx), _j(w, jp), _j(b, jp))
    jy, jmu, jrs = jpo._ln_fwd(*jargs, 1e-5)
    args = (_t(x, tx), _t(w, tp), _t(b, tp))
    y, mu, rs = fm.fused_layernorm_reference(*args)
    assert str(y.dtype)[6:] == str(jy.dtype)
    want = _t(_np(jy), y.dtype)
    limit = 2e-5 if y.dtype == torch.float32 else tol.ln_limit(y, want,
                                                               *args)
    _within(y, want, limit, f"y {xdt}/{pdt}")
    _within(mu, _t(_np(jmu)), 1e-5 * _t(_np(jmu)).abs() + 1e-6, "mu")
    _within(rs, _t(_np(jrs)), 1e-5 * _t(_np(jrs)).abs(), "rstd")
    ddt = torch.promote_types(tx, tp)
    jdy = _j(dy, jnp.dtype(str(ddt)[6:]))
    jgrads = jpo._ln_vjp_bwd(1e-5, (*jargs, jmu, jrs), jdy)
    bargs = (args[0], args[1], _t(_np(jmu)), _t(_np(jrs)), _t(dy, ddt))
    got = fm.fused_layernorm_bwd_reference(*bargs)
    assert [g.dtype for g in got] == [tx, tp, tp]
    want = [_t(_np(a), g.dtype) for a, g in zip(jgrads, got)]
    for name, g, wv, lim in zip(("dx", "dw", "db"), got, want,
                                tol.ln_bwd_limits(got, want, *bargs)):
        _within(g, wv, lim, f"{name} {xdt}/{pdt}")


def _ffn_inputs(seed, n=128, h=256, i=512, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, h).astype(np.float32) * scale,
            (rng.randn(h, i) / np.sqrt(h)).astype(np.float32),
            (0.1 * rng.randn(i)).astype(np.float32),
            (rng.randn(i, h) / np.sqrt(i)).astype(np.float32),
            rng.randn(n, h).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
def test_ffn_plain_and_autograd_match_jax_kernel_fp16(act, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    *arrays, dy = _ffn_inputs(3)
    jargs = [_j(a, jnp.float16) for a in arrays]
    jy, vjp = jax.vjp(lambda *a: jpo.fused_ffn_2d(*a, act), *jargs)
    jgrads = vjp(_j(dy, jnp.float16))
    ins = [_t(a, F16).requires_grad_() for a in arrays]
    y = fm.fused_ffn_arrays(*ins, act=act)
    assert y.dtype == F16
    _within(y.detach(), _t(_np(jy), F16),
            tol.ffn_limit(*[t.detach() for t in ins], act), f"y {act}")
    y.backward(_t(dy, F16))
    for name, t, g in zip(("dx", "dw1", "db1", "dw2"), ins, jgrads):
        want = _t(_np(g), F16)
        assert t.grad.dtype == F16
        _within(t.grad, want, _steps(t.grad, want, FFN_GRAD_STEPS),
                f"{name} {act}")


# ---------------------------------------------------------------------------
# (b) the per-layer fp16 test GPT under both flags
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=256, num_attention_heads=8, intermediate_size=512,
           num_hidden_layers=2, max_position_embeddings=64, vocab_size=256)
LR = 1e-3


def _set_flags(monkeypatch, on):
    for name in FLAGS:
        if on:
            monkeypatch.setenv(name, "1")
        else:
            monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def fp32_state():
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    return {k: _np(v.numpy()) for k, v in jmodel.state_dict().items()}


def _models(state):
    """The JAX and the port's per-layer test GPT from ``state``, each cast
    to fp16 by its package's O2 `decorate`."""
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    pm = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    pm.load_params(params_from_numpy(state, device="cpu"))
    jamp.decorate(models=jm, level="O2", dtype="float16")
    tamp.decorate(pm, level="O2", dtype="float16")
    assert all(p.dtype == F16 for p in pm.parameters())
    return jm, pm


class _Spy:
    """The dtypes of x and w of each kernel-path call of the port."""

    def __init__(self, monkeypatch):
        self.calls = {"layer_norm": [], "ffn": []}
        ln, ffn = PF.fused_layernorm_arrays, fm.fused_ffn_arrays

        def spy_ln(x, w, *a, **k):
            self.calls["layer_norm"].append((x.dtype, w.dtype))
            return ln(x, w, *a, **k)

        def spy_ffn(x, w1, *a, **k):
            self.calls["ffn"].append((x.dtype, w1.dtype))
            return ffn(x, w1, *a, **k)
        monkeypatch.setattr(PF, "fused_layernorm_arrays", spy_ln)
        monkeypatch.setattr(fm, "fused_ffn_arrays", spy_ffn)


def _batch(seed, b=8, s=16):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32),
            rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_step(fp32_state):
    """The JAX fp16 model's logits, loss and gradients of one pure-fp16
    step under both flags (its LN and FFN kernels in interpret mode, the
    LN backward in fp16), with the kernel paths it took."""
    mp = pytest.MonkeyPatch()
    for name in (*FLAGS, "PTPU_PALLAS_INTERPRET", "PTPU_ATTN_DEBUG"):
        mp.setenv(name, "1")
    try:
        jm, _ = _models(fp32_state)
        jm.train()                   # the test GPT has no dropout
        ids, labels = _batch(2)
        jpo.reset_attention_path_counts()
        logits = jm(paddle.to_tensor(ids))
        paths = jpo.attention_path_counts()
        loss = JaxCriterion()(logits, paddle.to_tensor(labels))
        loss.backward()
        grads = {n: _t(_np(p.grad.numpy())) for n, p in jm.named_parameters()}
    finally:
        mp.undo()
    return dict(ids=ids, labels=labels, logits=_t(_np(logits.numpy())),
                paths=paths, loss=float(loss.numpy()), grads=grads)


def test_per_layer_fp16_forward_under_flags_matches_jax(fp32_state, jax_step,
                                                        monkeypatch):
    _set_flags(monkeypatch, True)
    _, pm = _models(fp32_state)
    spy = _Spy(monkeypatch)
    ops.reset_launch_counts()
    got = pm(torch.from_numpy(jax_step["ids"])).detach()
    layers = CFG["num_hidden_layers"]
    assert jax_step["paths"].get("ln_kernel") == 2 * layers + 1
    assert jax_step["paths"].get("ffn_kernel") == layers
    assert spy.calls == {"layer_norm": [(F16, F16)] * (2 * layers + 1),
                         "ffn": [(F16, F16)] * layers}
    assert set(ops.launch_counts().values()) == {0}
    want = jax_step["logits"]
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    _within(got, want, LOGIT_STEPS * tol.FP16_STEP * scale, "logits")


def test_per_layer_pure_fp16_step_under_flags_matches_jax(fp32_state,
                                                          jax_step,
                                                          monkeypatch):
    """One step without ``auto_cast``: the fp16 LayerNorm backward in both
    packages (JAX's kernel in interpret mode, the port's plain version),
    the loss and every parameter's gradient."""
    _set_flags(monkeypatch, True)
    _, pm = _models(fp32_state)
    spy = _Spy(monkeypatch)
    loss = GPTPretrainingCriterion()(pm(torch.from_numpy(jax_step["ids"])),
                                     torch.from_numpy(jax_step["labels"]))
    loss.backward()
    layers = CFG["num_hidden_layers"]
    assert spy.calls["layer_norm"] == [(F16, F16)] * (2 * layers + 1)
    assert len(spy.calls["ffn"]) == layers
    np.testing.assert_allclose(loss.item(), jax_step["loss"],
                               rtol=2.0 ** -10)
    grads = dict(pm.named_parameters())
    assert set(grads) == set(jax_step["grads"])
    for name, want in jax_step["grads"].items():
        g = grads[name].grad
        assert g.dtype == F16, name
        _within(g, want, _steps(g, want, GRAD_STEPS), name)


def _margin(tok, logits):
    """The least m with ``tok`` the argmax of logits moved by at most m
    max(|logit|, 1) each (``tok``'s up, the others down)."""
    scale = np.maximum(np.abs(logits), 1.0)
    best = np.delete(np.arange(len(logits)), tok)
    need = (logits[best] - logits[tok]) / (scale[best] + scale[tok])
    return max(0.0, float(need.max()))


def test_per_layer_fp16_generate_under_flags_matches_jax(fp32_state,
                                                         monkeypatch):
    """Greedy ``generate`` under both flags, B=8 (the LN and FFN kernel
    paths at the prefill and at each decode step): every port token
    within `LOGIT_NOISE` of the top of JAX's fp16 logits of the port's
    own prefix (one dense JAX forward, teacher-forced)."""
    _set_flags(monkeypatch, True)
    jm, pm = _models(fp32_state)
    jm.eval()
    ids, _ = _batch(3, s=11)
    spy = _Spy(monkeypatch)
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=6).numpy()
    layers = CFG["num_hidden_layers"]
    # the prefill's 88 rows and each step's 8 (a row block of 8)
    assert spy.calls["layer_norm"] == [(F16, F16)] * (2 * layers + 1) * 6
    assert spy.calls["ffn"] == [(F16, F16)] * layers * 6
    assert got.shape == (8, 17)
    logits = _np(jm(paddle.to_tensor(got[:, :-1].astype(np.int32)))
                 .numpy())                      # teacher-forced, every row
    for r, row in enumerate(got):
        for t in range(11, 17):
            m = _margin(int(row[t]), logits[r, t - 1])
            assert m <= LOGIT_NOISE, (r, t, m)


def test_o2_auto_cast_kernel_paths_match_jax(fp32_state, monkeypatch):
    """Under ``auto_cast(level="O2", dtype="float16")`` of the O2-cast
    model: the LayerNorm kernel in fp32 (its black list) in both packages,
    and the FFN kernel in neither (the gate sees the fp32 LayerNorm output
    beside the fp16 weights: JAX counts ``ffn_fallback:dtype_mix``), so an
    fp16 O2 step under the flags runs no FFN kernel, as in JAX (O1 casts
    the FFN's inputs to fp16 as the op ``linear``: its kernel runs in
    fp16).  Logits within `LOGIT_STEPS` fp16 steps."""
    _set_flags(monkeypatch, True)
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    jm, pm = _models(fp32_state)
    jm.eval()
    ids, _ = _batch(4)
    jpo.reset_attention_path_counts()
    with jamp.auto_cast(level="O2", dtype="float16"):
        want = _t(_np(jm(paddle.to_tensor(ids)).numpy()))
    paths = jpo.attention_path_counts()
    spy = _Spy(monkeypatch)
    with tamp.auto_cast(level="O2", dtype="float16"):
        got = pm(torch.from_numpy(ids)).detach().float()
    layers = CFG["num_hidden_layers"]
    f32 = torch.float32
    assert paths.get("ln_kernel") == 2 * layers + 1
    assert spy.calls["layer_norm"] == [(f32, f32)] * (2 * layers + 1)
    assert paths.get("ffn_kernel", 0) == 0
    assert paths.get("ffn_fallback:dtype_mix") == layers
    assert spy.calls["ffn"] == []
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    _within(got, want, LOGIT_STEPS * tol.FP16_STEP * scale, "logits")


# ---------------------------------------------------------------------------
# (c) the launchers on fp16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 16, 23, 24, 64, 65, 1024, 8192])
def test_ffn_design_routes_fp16_as_bf16(n):
    for h, i in ((768, 3072), (256, 512), (768, 3008)):
        got = fm.ffn_design(n, h, i, F16)
        assert got == fm.ffn_design(n, h, i, torch.bfloat16)
        assert got != "tc32"
        assert got == ("cuda_core" if i % 128 else
                       "tc" if n >= fm.FFN_TC_MIN_ROWS else "decode")


class _FakeEntry:
    """Stands in for a C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Stream:
    cuda_stream = 0


@pytest.fixture
def fake_entries(monkeypatch):
    """Every LN / FFN launcher's C entry faked, a stream and 132 SMs, so
    that the launch paths run on CPU tensors up to the entry."""
    entries = {}
    for launcher in (fm.ln_fwd, fm.ln_bwd, fm.ffn_fwd, fm.ffn_tc,
                     fm.ffn_decode, fm.ffn_tc32):
        entries[launcher.KERNEL] = fake = _FakeEntry()
        monkeypatch.setattr(launcher, "fn", lambda nargs, f=fake: f)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(_build, "sms", lambda device: fm.H100_SMS)
    ops.reset_launch_counts()
    return entries


@pytest.mark.parametrize("xdt,pdt", [(F16, F16), (F16, torch.float32),
                                     (torch.float32, F16),
                                     (torch.bfloat16, F16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_layernorm_entries_get_type_codes(fake_entries, xdt, pdt):
    x, w, b, dy = (_t(a) for a in _ln_inputs(8, 256, 0))
    x, w, b = x.to(xdt), w.to(pdt), b.to(pdt)
    codes = (_build.dtype_code(xdt), _build.dtype_code(pdt))
    y, mu, rs = fm._ln_launch(x, w, b, 1e-5)
    assert y.dtype == torch.promote_types(xdt, pdt)
    assert fake_entries[fm.ln_fwd.KERNEL].calls[0][8:10] == codes
    fm._ln_bwd_launch(x, w, mu, rs, dy.to(y.dtype), None)
    assert fake_entries[fm.ln_bwd.KERNEL].calls[0][18:20] == codes
    half = int(F16 in (xdt, pdt))
    counts = ops.launch_counts()
    assert (counts[fm.ln_fwd.KERNEL], counts[fm.ln_bwd.KERNEL]) == (1, 1)
    assert (counts[fm.ln_fwd16.KERNEL], counts[fm.ln_bwd16.KERNEL]) == (
        half, half)


@pytest.mark.parametrize("n,i,design", [(32, 512, "tc"), (8, 512, "decode"),
                                        (8, 400, "cuda_core")])
@pytest.mark.parametrize("dtype", [F16, torch.bfloat16])
def test_ffn_entries_get_type_codes(fake_entries, n, i, design, dtype):
    *arrays, _ = _ffn_inputs(5, n=n, h=256, i=i)
    args = [_t(a, dtype) for a in arrays]
    assert fm.ffn_design(n, 256, i, dtype) == design
    y = fm._ffn_launch(*args, "gelu_tanh")
    assert y.dtype == dtype and y.shape == (n, 256)
    entry = {"tc": fm.ffn_tc, "decode": fm.ffn_decode,
             "cuda_core": fm.ffn_fwd}[design]
    (call,) = fake_entries[entry.KERNEL].calls
    assert call[-2] == _build.dtype_code(dtype)       # before the stream
    assert not fake_entries[fm.ffn_tc32.KERNEL].calls
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = {entry.KERNEL: 1}
    if dtype == F16:
        want[entry.KERNEL + ":fp16"] = 1
    assert counts == want


def test_fp16_gates_admit_fp16_and_count_nothing_on_the_cpu(monkeypatch):
    _set_flags(monkeypatch, True)
    x = torch.randn(8, 256).half()
    w, b = torch.ones(256).half(), torch.zeros(256).half()
    assert PF.fused_ln_applies(8, 256, w, b)
    ops.reset_launch_counts()
    y = PF.layer_norm(x, 256, w, b)
    assert y.dtype == F16
    torch.testing.assert_close(y, fm.fused_layernorm_reference(x, w, b)[0],
                               atol=0, rtol=0)
    w1, b1, w2 = (torch.randn(*s).half() for s in ((256, 512), (512,),
                                                   (512, 256)))
    out = fm.maybe_fused_ffn(x, w1, b1, w2, "gelu_tanh")
    assert out is not None and out.dtype == F16
    torch.testing.assert_close(out, fm.fused_ffn_reference(
        x, w1, b1, w2, "gelu_tanh"), atol=0, rtol=0)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# (d) the fp16 limits on emulations
# ---------------------------------------------------------------------------

def _ln64(x, w, b, eps=1e-5):
    x64 = x.double()
    mu = x64.mean(-1, keepdim=True)
    xc = x64 - mu
    rs = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rs * w.double() + b.double(), mu, rs


@pytest.mark.parametrize("tiny", [False, True])
def test_emulated_fp16_layernorm_within_the_limits(tiny):
    """The forward and backward in float64 (the kernels' fp32 sums in
    another order, and more exactly), rounded to fp32 and then once to
    fp16, against the plain versions.  ``tiny``: w and b about 2^-18
    (y subnormal in fp16) and dy about 2^-20 (dx, dw, db subnormal or
    tiny): the limits' 2^-24 terms."""
    x, w, b, dy = (_t(a) for a in _ln_inputs(64, 512, 9))
    if tiny:
        w, b, dy = w * 2.0 ** -18, b * 2.0 ** -18, dy * 2.0 ** -20
    x, w, b, dy = x.half(), w.half(), b.half(), dy.half()
    y64, mu64, rs64 = _ln64(x, w, b)
    got = y64.float().half()
    want, mu, rs = fm.fused_layernorm_reference(x, w, b)
    if tiny:
        assert (want.float().abs() < 2.0 ** -14).float().mean() > 0.9
    _within(got, want, tol.ln_limit(got, want, x, w, b), "LN forward")
    xhat = (x.double() - mu64) * rs64
    g = dy.double() * w.double()
    dx = rs64 * (g - g.mean(-1, keepdim=True)
                 - xhat * (g * xhat).mean(-1, keepdim=True))
    got = [dx.float().half(), (dy.double() * xhat).sum(0).float().half(),
           dy.double().sum(0).float().half()]
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    if tiny:
        assert (want[0].float().abs() < 2.0 ** -14).float().mean() > 0.9
    for name, gv, wv, lim in zip(("dx", "dw", "db"), got, want,
                                 tol.ln_bwd_limits(got, want, x, w, mu, rs,
                                                   dy)):
        _within(gv, wv, lim, f"LN backward {name}")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("tiny", [False, True])
def test_emulated_fp16_ffn_within_the_limit(act, tiny):
    """The tensor-core design's arithmetic: both products in float64
    (exact fp16 products summed in another order), b1 and the activation
    on the fp32 value, h rounded to fp16, y rounded once.  ``tiny``: x
    scaled by 2^-14 and b1 by 2^-16, so most of h is subnormal in fp16."""
    x, w1, b1, w2, _ = (_t(a) for a in _ffn_inputs(11, n=64, h=256, i=512))
    if tiny:
        x, b1 = x * 2.0 ** -14, b1 * 2.0 ** -16
    x, w1, b1, w2 = x.half(), w1.half(), b1.half(), w2.half()
    u = (x.double() @ w1.double()).float() + b1.float()
    h = fm._act(u, act).half()
    if tiny:                         # most nonzero h subnormal
        nz = h[h != 0].float().abs()
        assert (nz < 2.0 ** -14).float().mean() > 0.5
    got = (h.double() @ w2.double()).float().half()
    want = fm.fused_ffn_reference(x, w1, b1, w2, act)
    _within(got, want, tol.ffn_limit(x, w1, b1, w2, act), f"FFN {act}")


def test_fp16_ln_and_ffn_limit_terms():
    """`ln_limit`'s terms in fp16: one fp16 step of the larger output,
    2^-20 of the LN terms, 2^-24 absolute; `ln_bwd_limits` likewise with
    1e-5 of the term magnitudes; `ffn_limit` at least one fp16 step of
    the output and 2^-10 of |h| |W2|."""
    x = torch.tensor([[1.0, -1.0, 3.0, -3.0]]).half()
    w = torch.ones(4).half()
    b = torch.zeros(4).half()
    y = fm.fused_layernorm_reference(x, w, b)[0]
    lim = tol.ln_limit(y, y, x, w, b)
    want = (tol.FP16_STEP * y.float().abs()
            + tol.LN_COEF * tol.ln_magnitude(x, w, b) + 2.0 ** -24)
    torch.testing.assert_close(lim, want, rtol=1e-6, atol=0)
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    dy = torch.ones(1, 4).half()
    got = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    mags = tol.ln_bwd_magnitudes(x, w, mu, rs, dy)
    for g, lim, mag in zip(got, tol.ln_bwd_limits(got, got, x, w, mu, rs,
                                                  dy), mags):
        torch.testing.assert_close(
            lim, tol.FP16_STEP * g.float().abs() + tol.LN_BWD_COEF * mag
            + 2.0 ** -24, rtol=1e-6, atol=0)
    x, w1, b1, w2, _ = (_t(a, F16) for a in _ffn_inputs(1, n=8, h=128,
                                                         i=256))
    y = fm.fused_ffn_reference(x, w1, b1, w2, "relu")
    h = fm._act(x.float() @ w1.float() + b1.float(), "relu").half().float()
    lim = tol.ffn_limit(x, w1, b1, w2, "relu")
    floor = (tol.FP16_STEP * (h @ w2.float()).abs()
             + tol.FP16_FFN_COEF * (h.abs() @ w2.float().abs()))
    assert bool((lim >= floor).all())
    assert bool((lim >= tol.FP16_STEP * 0.99 * y.float().abs()).all())
