"""Weight-only low-bit inference of the port against the JAX package, on
the CPU.

The same numpy inputs, made from a seed, go through `paddle_tpu.lowbit`
and `paddle_tpu_torch.lowbit`; the test GPT's weights go from the JAX
model's ``state_dict`` to the port by `convert.params_from_numpy`.

- quantization, int4 packing and unpacking at 4 and 8 bits, per tensor
  and per channel, odd rows and an all-zero tensor: codes and scales
  bitwise equal (the weight scale is a true division on both sides);
- `quantized_matmul_arrays` in fp32 and bf16, `WeightOnlyLinear.from_linear`
  with and without ``scale=``: within the limits below;
- `quantize_for_inference` on the per-layer test GPT at int8 and int4:
  8 layers swapped in each package, equal ``state_dict`` names and
  dtypes, codes and scales bitwise, a forward's logits within the limit,
  greedy ``generate`` tokens equal, the ``lowbit/*`` counters equal; the
  stacked layout swaps nothing in either; a quantized JAX ``state_dict``
  loads into the port through `convert` and through the two packages'
  ``save`` / ``load``; under ``PTPU_PALLAS_FFN=1`` a quantized model never
  reaches the fused FFN.

Limits (`paddle_tpu_torch.ops.lowbit`'s docstring).  Both sides form every
product term ``x_k q_k`` exactly in fp32 and differ in the order of the
sum over K terms: ``|out - ref| <= K 2^-24 scale sum_k |x_k q_k|`` in
fp32; bf16 adds one bf16 step of the output on each side, ``2^-7 |ref|``.
The GPT's logits run two layers of fp32 arithmetic in different orders
(cuBLAS-free CPU kernels on both sides): 1e-4 absolute on logits of unit
scale, the limit of the port's other per-layer parity tests.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import lowbit as jlowbit
from paddle_tpu import monitor as jmonitor
from paddle_tpu import nn as jnn
from paddle_tpu import parallel as jparallel
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config

from paddle_tpu_torch import load, monitor, save
from paddle_tpu_torch import lowbit
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.lowbit import WeightOnlyLinear, quantize_for_inference
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.ops import fused_mlp as fm
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


DTYPES = ("int8", "int4")
B, P, NEW = 4, 6, 8
LOGIT_ATOL = 1e-4


def _matmul_limit(x, q, scale, bf16):
    """Per-element limit of the quantized product (module docstring): x
    [n, K] and the codes q [K, N] as fp32 numpy, scale [N]."""
    k = x.shape[-1]
    mag = np.abs(x) @ np.abs(q.astype(np.float32)) * np.abs(scale)
    return k * 2.0 ** -24 * mag, (2.0 ** -7 if bf16 else 0.0)


def _check_product(got, want, x, q, scale, bf16):
    noise, step = _matmul_limit(x, q, scale, bf16)
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= noise + step * np.abs(want)).all(), err.max()


# -- quantize, pack, unpack ---------------------------------------------------

CASES = {"random": (64, 16), "odd_rows": (7, 5), "zeros": (8, 3)}


def _case(name):
    rng = np.random.RandomState(sorted(CASES).index(name))
    shape = CASES[name]
    if name == "zeros":
        return np.zeros(shape, np.float32)
    return (rng.randn(*shape) * rng.uniform(0.01, 3.0, shape[1])).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_pack_unpack_bitwise(bits, axis, case):
    w = _case(case)
    jq, js = jlowbit.quantize_absmax_arrays(w, bits=bits, axis=axis)
    q, s = lowbit.quantize_absmax_arrays(torch.from_numpy(w), bits=bits,
                                         axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.shape == np.asarray(js).shape
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(
        lowbit.dequantize_arrays(q, s, axis=None if axis is None else 1)
        .numpy(), np.asarray(jlowbit.dequantize_arrays(
            jq, js, axis=None if axis is None else 1)))
    if bits == 4:
        packed = lowbit.pack_int4_arrays(q)
        jpacked = jlowbit.pack_int4_arrays(jq)
        assert packed.dtype == torch.uint8
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        back = lowbit.unpack_int4_arrays(packed, w.shape[0])
        np.testing.assert_array_equal(back.numpy(), q.numpy())
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jlowbit.unpack_int4_arrays(
                jpacked, w.shape[0])))
    if case == "zeros":
        assert not q.any() and not s.any()


# -- the product and the layer ------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_within_limits(dtype, bits):
    import jax.numpy as jnp
    rng = np.random.RandomState(bits)
    x = rng.randn(5, 33).astype(np.float32)        # odd K: an int4 pad row
    w = rng.randn(33, 17).astype(np.float32)
    jq, js = jlowbit.quantize_absmax_arrays(w, bits=bits, axis=0)
    q = torch.from_numpy(np.array(jq))
    packed_j = jlowbit.pack_int4_arrays(jq) if bits == 4 else jq
    packed = (lowbit.pack_int4_arrays(q) if bits == 4 else q)
    bf16 = dtype == "bfloat16"
    xj = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jlowbit.quantized_matmul_arrays(xj, packed_j, js, bits=bits,
                                           in_features=33)
    got = lowbit.quantized_matmul_arrays(xt, packed,
                                         torch.from_numpy(np.array(js)),
                                         bits=bits, in_features=33)
    assert got.dtype == xt.dtype and got.shape == (5, 17)
    _check_product(got, np.asarray(want, np.float32), xt.float().numpy(),
                   np.asarray(jq), np.asarray(js), bf16)


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("weight_dtype", DTYPES)
def test_weight_only_linear_from_linear(weight_dtype, with_scale):
    paddle.seed(0)
    jlin = jnn.Linear(33, 17)
    w = np.array(jlin.weight.numpy(), np.float32)
    b = np.random.RandomState(5).randn(17).astype(np.float32)
    jlin.bias.set_value(b)
    lin = Linear(33, 17, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))
    qmax = lowbit.qmax_for_bits(8 if weight_dtype == "int8" else 4)
    # a calibrated scale: 10 % above the abs-max one, so codes shrink
    scale = (np.abs(w).max(0) / qmax * 1.1).astype(np.float32) \
        if with_scale else None
    jw = jlowbit.WeightOnlyLinear.from_linear(jlin, weight_dtype,
                                              scale=scale)
    pw = WeightOnlyLinear.from_linear(lin, weight_dtype, scale=scale)
    for name in ("qweight", "scale"):
        want = np.asarray(getattr(jw, name).numpy())
        got = getattr(pw, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert pw.packed_bytes == jw.packed_bytes
    assert pw.dense_bytes == jw.dense_bytes == 33 * 17 * 4
    x = np.random.RandomState(6).randn(4, 33).astype(np.float32)
    want = np.asarray(jw(paddle.to_tensor(x)).numpy()) - b
    got = pw(torch.from_numpy(x)).detach() - torch.from_numpy(b)
    codes = (lowbit.unpack_int4_arrays(pw.qweight, 33)
             if weight_dtype == "int4" else pw.qweight).numpy()
    _check_product(got, want, x, codes, pw.scale.numpy(), False)


# -- the per-layer test GPT ---------------------------------------------------

def _counters(snap):
    """The ``lowbit/*`` series of a snapshot that hold a value: a reset
    registry keeps the series of earlier tests, at zero."""
    out = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            v = {label: x for label, x in v.items() if x}
        if k.startswith("lowbit/") and v:
            out[k] = v
    return out


@pytest.fixture
def monitors():
    """Both monitors on, with empty registries; restored after."""
    for m in (jmonitor, monitor):
        m.enable(True)
        m.reset()
    yield
    for m in (jmonitor, monitor):
        m.reset()
        m.refresh()


@pytest.fixture(scope="module")
def gpts():
    """The JAX per-layer test GPT and the port's with its weights, and
    both quantized at int8 and int4 with the counters of the quantizing
    and of one eager forward."""
    jparallel.init_mesh()       # a leaked mp > 1 mesh vetoes the swap
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(sequence_parallel=False))
    jm.eval()
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jm.state_dict().items()}
    pm = GPTForCausalLM(gpt_test_config(), device="cpu")
    pm.load_params(params_from_numpy(state, device="cpu"))
    ids = np.random.RandomState(0).randint(0, 128, (B, P)).astype(np.int32)
    out = {"jax": jm, "port": pm, "ids": ids, "q": {}}
    for dt in DTYPES:
        rec = {}
        for name, m, qfi in (("jax", jm, jlowbit.quantize_for_inference),
                             ("port", pm, quantize_for_inference)):
            mon = jmonitor if name == "jax" else monitor
            mon.enable(True)
            mon.reset()
            q = qfi(m, dt)
            after_q = _counters(mon.snapshot())
            mon.reset()
            if name == "jax":
                logits = np.asarray(q(paddle.to_tensor(ids)).numpy())
            else:
                with torch.no_grad():
                    logits = q(torch.from_numpy(ids)).numpy()
            after_fwd = _counters(mon.snapshot())
            mon.reset()
            mon.refresh()
            rec[name] = dict(model=q, quantize=after_q, forward=after_fwd,
                             logits=logits)
        out["q"][dt] = rec
    return out


def _swapped(model):
    return sorted(n for n, m in model.named_modules()
                  if isinstance(m, WeightOnlyLinear))


@pytest.mark.parametrize("weight_dtype", DTYPES)
def test_gpt_swap_and_state_dict(gpts, weight_dtype):
    rec = gpts["q"][weight_dtype]
    jq, pq = rec["jax"]["model"], rec["port"]["model"]
    swapped = _swapped(pq)
    assert len(swapped) == 8
    assert len([1 for s in jq.sublayers()
                if isinstance(s, jlowbit.WeightOnlyLinear)]) == 8
    # the original is untouched
    assert not _swapped(gpts["port"])
    jstate = {k: np.asarray(v.numpy()) for k, v in jq.state_dict().items()}
    pstate = params_to_numpy(pq)
    assert set(pstate) == set(jstate)
    assert set(pq.state_dict()) == set(jstate)
    for name, want in jstate.items():
        got = pstate[name]
        assert got.dtype == want.dtype, name
        if name.endswith((".qweight", ".scale")):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("weight_dtype", DTYPES)
def test_gpt_logits_and_counters(gpts, weight_dtype):
    rec = gpts["q"][weight_dtype]
    want, got = rec["jax"]["logits"], rec["port"]["logits"]
    assert got.shape == want.shape == (B, P, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
    for when in ("quantize", "forward"):
        assert rec["port"][when] == rec["jax"][when], when
    assert rec["port"]["quantize"]["lowbit/weight_layers"] == 8
    assert rec["port"]["forward"]["lowbit/dequant_calls"]["site=matmul"] \
        == 8


@pytest.mark.parametrize("weight_dtype", DTYPES)
def test_gpt_greedy_generate_matches_jax(gpts, weight_dtype, monitors):
    rec = gpts["q"][weight_dtype]
    jq, pq = rec["jax"]["model"], rec["port"]["model"]
    ids = gpts["ids"]
    want = np.asarray(jq.generate(paddle.to_tensor(ids),
                                  max_new_tokens=NEW).numpy())
    got = pq.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert got.dtype == torch.int32 and got.shape == (B, P + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    # the port counts no product inside generate (one traced program)
    calls = monitor.snapshot().get("lowbit/dequant_calls", {})
    assert not calls.get("site=matmul")


def test_stacked_layout_swaps_nothing(monitors):
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(sequence_parallel=False,
                                stacked_blocks=True))
    pm = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    jq = jlowbit.quantize_for_inference(jm, "int8")
    pq = quantize_for_inference(pm, "int8")
    assert not [s for s in jq.sublayers()
                if isinstance(s, jlowbit.WeightOnlyLinear)]
    assert not _swapped(pq)
    assert _counters(monitor.snapshot()) == _counters(jmonitor.snapshot())
    assert monitor.snapshot()["lowbit/weight_layers"] == 0


@pytest.mark.parametrize("weight_dtype", DTYPES)
def test_quantized_jax_state_dict_loads_into_the_port(gpts, weight_dtype,
                                                      tmp_path):
    rec = gpts["q"][weight_dtype]
    jq = rec["jax"]["model"]
    jstate = {k: np.asarray(v.numpy()) for k, v in jq.state_dict().items()}
    # through convert, into a freshly quantized port model
    fresh = quantize_for_inference(
        GPTForCausalLM(gpt_test_config(), device="cpu",
                       generator=torch.Generator().manual_seed(7)),
        weight_dtype)
    fresh.load_params(params_from_numpy(jstate, device="cpu"))
    for name, t in fresh.param_arrays().items():
        np.testing.assert_array_equal(
            (t.detach() if t.dtype in (torch.int8, torch.uint8)
             else t.detach()).numpy(), jstate[name], err_msg=name)
    with torch.no_grad():
        logits = fresh(torch.from_numpy(gpts["ids"])).numpy()
    np.testing.assert_array_equal(logits, rec["port"]["logits"])
    # JAX save -> port load -> the port model, and back
    jpath, ppath = str(tmp_path / "jax.pdparams"), str(tmp_path / "port")
    paddle.save(jq.state_dict(), jpath)
    loaded = load(jpath)
    assert {k: v.dtype for k, v in loaded.items()} == {
        k: v.dtype for k, v in fresh.state_dict().items()}
    fresh.load_params(loaded)
    save(fresh.state_dict(), ppath)
    back = paddle.load(ppath)
    assert set(back) == set(jstate)
    for name, want in jstate.items():
        got = np.asarray(back[name].numpy() if hasattr(back[name], "numpy")
                         else back[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    jq2 = jlowbit.quantize_for_inference(gpts["jax"], weight_dtype)
    jq2.set_state_dict(back)
    np.testing.assert_array_equal(
        np.asarray(jq2(paddle.to_tensor(gpts["ids"])).numpy()),
        rec["jax"]["logits"])


def test_quantized_model_never_calls_the_fused_ffn(monkeypatch):
    cfg = gpt_test_config(hidden_size=128, intermediate_size=256)
    model = GPTForCausalLM(cfg, device="cpu")
    calls = []
    ffn = fm.fused_ffn_arrays

    def spy(*a, **k):
        calls.append(a[0].shape)
        return ffn(*a, **k)

    monkeypatch.setattr(fm, "fused_ffn_arrays", spy)
    monkeypatch.setenv("PTPU_PALLAS_FFN", "1")
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, 128, (2, 8)))
    with torch.no_grad():
        model(ids)
    assert len(calls) == cfg.num_hidden_layers     # the float model does
    calls.clear()
    for dt in DTYPES:
        q = quantize_for_inference(model, dt)
        with torch.no_grad():
            q(ids)
        q.generate(ids, max_new_tokens=3)
    assert calls == []


def test_copy_of_a_generating_model_starts_without_its_steps():
    model = GPTForCausalLM(gpt_test_config(), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 128, (2, 5)))
    want = model.generate(ids, max_new_tokens=4)
    steps = dict(model._decode_steps)
    assert len(steps) == 1
    q = quantize_for_inference(model, "int8")
    assert q._decode_steps == {} and q.compiles == {}
    assert model._decode_steps == steps
    q.generate(ids, max_new_tokens=4)
    torch.testing.assert_close(model.generate(ids, max_new_tokens=4), want,
                               rtol=0, atol=0)
    assert model._decode_steps == steps
    # new codes at a new address make a new step
    (key, step), = q._decode_steps.items()
    layer = q.gpt.h_0.attn.qkv_proj
    layer.qweight = layer.qweight.clone()
    assert q._decode_step(2, 9, False) is not step
