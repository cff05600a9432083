"""The port's conv path (`paddle_tpu_torch.nn.functional` conv / pool /
batch_norm, `nn.conv`, `nn.pooling`, `nn.norm`'s BatchNorms) against the
JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages; each
case also takes the gradients of a random cotangent back through both
(x, and the conv weight or BN's weight and bias):

- conv 1-D, 2-D and 3-D: strides, dilation, groups, every Paddle padding
  form (an int, one int a dimension, the flat ``[lo0, hi0, lo1, hi1]``,
  pairs, ``"SAME"`` at stride 2 with an odd total, ``"VALID"``), bias,
  channel-last; the transposes with groups, ``output_padding``,
  asymmetric pairs and a padding past the kernel, and their refusal of a
  string padding;
- max and avg pooling: ceil windows that start inside the right padding
  (torch drops them, Paddle keeps them), exclusive and inclusive
  divisors (the clipped divisor of an inclusive ceil window), ``"SAME"``,
  unequal pairs, ``divisor_override``, channel-last, ``return_mask``;
  adaptive avg over uneven bins (1-D to 3-D), adaptive max with its mask;
  the gradient of x for a max, an avg and an adaptive pool;
- BatchNorm: training and eval, the running statistics after three
  calls (Paddle's momentum and biased variance), ``use_global_stats``,
  channel-last, 1-D ([N, C] and [N, L, C]) and 3-D, and bf16 x with
  bf16 buffers and weights;
- the layers: JAX's positional signatures, weights from the same seed,
  ``state_dict`` names and buffers, forward after carrying the weights;
- AMP: the ops' dtypes under O1 and O2 as JAX's.

Limits.  fp32 outputs and gradients within 1e-5 of max(1, max|JAX|)
(both sum in fp32, in different orders); masks, shapes and dtypes equal.
JAX compiles each op at its first shape, so the file runs ~45 s serial.
bf16 BatchNorm: the output within one bf16 step (2^-8 relative) plus
2^-8 of |weight| + |bias| (JAX rounds the normalised value to bf16, then
the product and the sum; fp32 statistics that differ in their last bits
may round apart once, each rounding at most half a step); the bf16
running statistics within one bf16 step of JAX's.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp

import paddle_tpu_torch
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import amp as pamp

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's ops here are small; one intra-op thread a worker keeps
    torch's thread pool from contending with JAX's and with the other
    workers' under ``-n``.  The count is put back after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy()).astype(np.float32)


def _close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grads(jfn, pfn, arrays, seed=9):
    """``jfn`` / ``pfn`` over the same numpy ``arrays`` (those not None
    differentiable), then a seeded cotangent back through each: (JAX out,
    port out, JAX grads, port grads)."""
    jin = [None if a is None else paddle.to_tensor(a, stop_gradient=False)
           for a in arrays]
    pin = [None if a is None else torch.tensor(a, requires_grad=True)
           for a in arrays]
    jo, po = jfn(*jin), pfn(*pin)
    g = _x(*jo.shape, seed=seed)
    (jo * paddle.to_tensor(g)).sum().backward()
    (po * torch.from_numpy(g)).sum().backward()
    return (jo, po, [t.grad for t in jin if t is not None],
            [t.grad for t in pin if t is not None])


def _check(jfn, pfn, arrays, what, grads=True):
    """Outputs equal, and with ``grads`` the gradients of every input."""
    if not grads:
        _close(pfn(*map(torch.from_numpy, arrays)),
               jfn(*map(paddle.to_tensor, arrays)), what=what)
        return
    jo, po, jg, pg = _grads(jfn, pfn, arrays)
    _close(po, jo, what=what)
    for i, (a, b) in enumerate(zip(pg, jg)):
        _close(a, b, what=f"{what} grad {i}")


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

# (name, nd, x shape, w shape, bias, kwargs)
CONV_CASES = [
    ("1d_s2_p1", 1, (2, 4, 13), (6, 4, 3), True,
     dict(stride=2, padding=1)),
    ("1d_same_s2_nlc", 1, (2, 12, 4), (6, 2, 4), False,
     dict(stride=2, padding="SAME", groups=2, data_format="NLC")),
    ("2d_int", 2, (2, 4, 9, 11), (6, 4, 3, 3), True, dict(padding=1)),
    ("2d_per_dim_s2", 2, (2, 4, 9, 11), (6, 4, 3, 3), False,
     dict(stride=2, padding=[1, 2])),
    ("2d_flat_groups", 2, (2, 4, 9, 11), (6, 2, 3, 3), True,
     dict(stride=2, padding=[0, 1, 2, 1], groups=2)),
    ("2d_pairs_dil", 2, (2, 4, 9, 11), (6, 4, 3, 3), False,
     dict(padding=[[1, 0], [0, 2]], dilation=2)),
    ("2d_same_s2_odd", 2, (2, 4, 9, 10), (6, 4, 4, 3), True,
     dict(stride=2, padding="SAME")),
    ("2d_same_dil", 2, (2, 4, 9, 10), (6, 4, 3, 3), False,
     dict(padding="same", dilation=2)),
    ("2d_valid_s3", 2, (2, 4, 9, 11), (6, 4, 2, 3), False,
     dict(stride=3, padding="VALID")),
    ("2d_nhwc_same_s2", 2, (2, 9, 10, 4), (8, 2, 3, 3), True,
     dict(stride=2, padding="SAME", groups=2, data_format="NHWC")),
    ("2d_nhwc_depthwise", 2, (2, 7, 7, 4), (4, 1, 3, 3), False,
     dict(padding=1, groups=4, data_format="NHWC")),
    ("3d_s121", 3, (1, 2, 5, 6, 7), (4, 2, 3, 3, 3), True,
     dict(stride=(1, 2, 1), padding=1)),
    ("3d_ndhwc_same", 3, (1, 5, 6, 7, 2), (4, 2, 3, 2, 3), False,
     dict(stride=2, padding="SAME", data_format="NDHWC")),
]


@pytest.mark.parametrize("name,nd,xs,ws,bias,kw", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_conv_matches_jax(name, nd, xs, ws, bias, kw):
    x, w = _x(*xs), _x(*ws, seed=1) * 0.3
    b = _x(ws[0], seed=2) if bias else None
    jfn = getattr(JF, f"conv{nd}d")
    pfn = getattr(PF, f"conv{nd}d")
    _check(lambda x, w, b: jfn(x, w, b, **kw),
           lambda x, w, b: pfn(x, w, b, **kw), [x, w, b], name)


# (name, nd, x shape, w shape [in, out/groups, *k], kwargs)
CONVT_CASES = [
    ("1d_s3_op1", 1, (2, 4, 7), (4, 3, 4),
     dict(stride=3, padding=2, output_padding=1)),
    ("2d_groups_op1", 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=1, output_padding=1, groups=2)),
    ("2d_pairs", 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=[[1, 0], [0, 2]])),
    ("2d_pairs_op_past_kernel", 2, (2, 4, 5, 6), (4, 3, 3, 3),
     dict(stride=2, padding=[[2, 0], [3, 3]], output_padding=1)),
    ("2d_dil_nhwc", 2, (2, 5, 6, 4), (4, 2, 3, 3),
     dict(stride=2, padding=1, dilation=2, groups=2, data_format="NHWC")),
    ("3d_s2", 3, (1, 2, 3, 4, 3), (2, 3, 2, 3, 2),
     dict(stride=2, padding=0)),
]


@pytest.mark.parametrize("name,nd,xs,ws,kw", CONVT_CASES,
                         ids=[c[0] for c in CONVT_CASES])
def test_conv_transpose_matches_jax(name, nd, xs, ws, kw):
    x, w = _x(*xs), _x(*ws, seed=1) * 0.3
    groups = kw.get("groups", 1)
    b = _x(ws[1] * groups, seed=2)
    jfn = getattr(JF, f"conv{nd}d_transpose")
    pfn = getattr(PF, f"conv{nd}d_transpose")
    _check(lambda x, w, b: jfn(x, w, b, **kw),
           lambda x, w, b: pfn(x, w, b, **kw), [x, w, b], name)


def test_conv_transpose_refuses_string_padding_as_jax():
    x, w = _x(1, 2, 4, 4), _x(2, 2, 3, 3)
    for pad in ("SAME", "VALID"):
        with pytest.raises(ValueError, match="String padding"):
            JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w),
                                stride=2, padding=pad)
        with pytest.raises(ValueError, match="String padding"):
            PF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                stride=2, padding=pad)


def test_conv_float_input_takes_the_weights_dtype():
    """A float32 input meeting bf16 weights is cast to bf16, as JAX
    casts it (`functional/__init__.py:302-305`); the bias adds in the
    promoted dtype, as JAX's."""
    x, w, b = _x(2, 3, 6, 6), _x(4, 3, 3, 3, seed=1), _x(4, seed=2)
    jw = paddle.to_tensor(w).astype("bfloat16")
    pw = torch.from_numpy(w).bfloat16()
    for jb, pb in ((None, None), (paddle.to_tensor(b), torch.from_numpy(b))):
        jo = JF.conv2d(paddle.to_tensor(x), jw, jb, padding=1)
        po = PF.conv2d(torch.from_numpy(x), pw, pb, padding=1)
        assert str(po.dtype).split(".")[-1] == str(jo.dtype).split(".")[-1]
        _close(po, jo, rel=2.0 ** -7)


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

# (name, function, x shape, args, kwargs)
POOL_CASES = [
    ("max2d_resnet", "max_pool2d", (2, 3, 9, 8), (3, 2, 1), {}),
    ("max2d_ceil_in_pad", "max_pool2d", (2, 3, 5, 7), (2, 2, 1),
     dict(ceil_mode=True)),
    ("max2d_same", "max_pool2d", (2, 3, 9, 8), (3, 2, "SAME"), {}),
    ("max2d_pairs", "max_pool2d", (2, 3, 9, 8), (3, 2, [[2, 0], [1, 2]]),
     {}),
    ("max2d_nhwc_ceil", "max_pool2d", (2, 7, 6, 3), (3, 2, 1),
     dict(ceil_mode=True, data_format="NHWC")),
    ("max1d_ceil", "max_pool1d", (2, 3, 11), (3, 2, 1),
     dict(ceil_mode=True)),
    ("max3d", "max_pool3d", (1, 2, 5, 6, 7), (2, 2, 1), {}),
    ("avg2d_exclusive", "avg_pool2d", (2, 3, 9, 8), (3, 2, 1), {}),
    ("avg2d_inclusive", "avg_pool2d", (2, 3, 9, 8), (3, 2, 1),
     dict(exclusive=False)),
    ("avg2d_ceil_exclusive", "avg_pool2d", (2, 3, 5, 7), (2, 2, 1),
     dict(ceil_mode=True)),
    ("avg2d_ceil_inclusive", "avg_pool2d", (2, 3, 5, 7), (3, 2, 1),
     dict(ceil_mode=True, exclusive=False)),
    ("avg2d_same", "avg_pool2d", (2, 3, 9, 8), (3, 2, "SAME"), {}),
    ("avg2d_divisor", "avg_pool2d", (2, 3, 5, 7), (2, 2, 1),
     dict(ceil_mode=True, divisor_override=3)),
    ("avg2d_nhwc_pairs", "avg_pool2d", (2, 9, 8, 3),
     (3, 2, [[2, 0], [1, 2]]), dict(data_format="NHWC")),
    ("avg1d_nlc_ceil", "avg_pool1d", (2, 11, 3), (3, 2, 1),
     dict(ceil_mode=True, exclusive=False, data_format="NLC")),
    ("avg3d_ceil", "avg_pool3d", (1, 2, 5, 6, 7), (2, 2, 1),
     dict(ceil_mode=True)),
    ("adaptive_avg1d", "adaptive_avg_pool1d", (2, 3, 11), (4,), {}),
    ("adaptive_avg2d_uneven", "adaptive_avg_pool2d", (2, 3, 7, 10),
     ((3, 4),), {}),
    ("adaptive_avg2d_nhwc_1x1", "adaptive_avg_pool2d", (2, 7, 7, 5),
     ((1, 1),), dict(data_format="NHWC")),
    ("adaptive_avg3d", "adaptive_avg_pool3d", (1, 2, 5, 7, 6), (3,), {}),
    ("adaptive_max2d_uneven", "adaptive_max_pool2d", (2, 3, 7, 10),
     ((3, 4),), {}),
]


# the cases whose gradient of x is held too (torch's pool backward; the
# others differ only in the forward's windows)
POOL_GRADS = ("max2d_resnet", "avg2d_ceil_inclusive", "adaptive_avg2d_nhwc_1x1")


@pytest.mark.parametrize("name,fn,xs,args,kw", POOL_CASES,
                         ids=[c[0] for c in POOL_CASES])
def test_pool_matches_jax(name, fn, xs, args, kw):
    x = _x(*xs)
    jfn, pfn = getattr(JF, fn), getattr(PF, fn)
    _check(lambda x: jfn(x, *args, **kw), lambda x: pfn(x, *args, **kw),
           [x], name, grads=name in POOL_GRADS)


def test_ceil_window_inside_the_padding_is_kept():
    """At H=5, k=2, s=2, pad 1 the ceil grid has a window starting at row
    5, wholly in the right padding: Paddle (and the port) keep it, torch's
    own ``ceil_mode`` drops it."""
    x = torch.from_numpy(_x(1, 1, 5, 5))
    out = PF.max_pool2d(x, 2, 2, 1, ceil_mode=True)
    assert out.shape[-2:] == (4, 4)
    assert torch.nn.functional.max_pool2d(
        x, 2, 2, 1, ceil_mode=True).shape[-2:] == (3, 3)


@pytest.mark.parametrize("kw", [dict(padding=1), dict(padding=1,
                                                      ceil_mode=True),
                                dict(padding="SAME", data_format="NHWC")],
                         ids=["p1", "p1_ceil", "same_nhwc"])
def test_max_pool2d_mask_matches_jax(kw):
    df = kw.get("data_format", "NCHW")
    x = _x(2, 3, 7, 9) if df == "NCHW" else _x(2, 7, 9, 3)
    x[0, 0] = 0.0                                  # ties: the first wins
    jo, jm = JF.max_pool2d(paddle.to_tensor(x), 3, 2, return_mask=True, **kw)
    po, pm = PF.max_pool2d(torch.from_numpy(x), 3, 2, return_mask=True, **kw)
    _close(po, jo)
    assert pm.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm.numpy()))


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_adaptive_max_pool2d_mask_matches_jax(df):
    x = _x(2, 3, 7, 10) if df == "NCHW" else _x(2, 7, 10, 3)
    jo, jm = JF.adaptive_max_pool2d(paddle.to_tensor(x), (3, 4),
                                    return_mask=True, data_format=df)
    po, pm = PF.adaptive_max_pool2d(torch.from_numpy(x), (3, 4),
                                    return_mask=True, data_format=df)
    _close(po, jo)
    assert pm.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm.numpy()))


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def _bn_args(c, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(c).astype(np.float32) * 0.1,
            (1.0 + rng.rand(c)).astype(np.float32),
            (1.0 + 0.5 * rng.randn(c)).astype(np.float32),
            (0.5 * rng.randn(c)).astype(np.float32))


# (name, x shape, data_format, training, use_global_stats)
BN_CASES = [
    ("train_nchw", (4, 3, 5, 6), "NCHW", True, None),
    ("train_nhwc", (4, 5, 6, 3), "NHWC", True, None),
    ("train_nlc", (4, 7, 3), "NLC", True, None),
    ("train_ndhwc", (2, 3, 4, 5, 3), "NDHWC", True, None),
    ("eval_nchw", (4, 3, 5, 6), "NCHW", False, None),
    ("global_stats_in_training", (4, 3, 5, 6), "NCHW", True, True),
]


@pytest.mark.parametrize("name,xs,df,training,ugs", BN_CASES,
                         ids=[c[0] for c in BN_CASES])
def test_batch_norm_matches_jax(name, xs, df, training, ugs):
    """Output and the gradients of x, weight and bias; then the running
    statistics after three calls on fresh inputs."""
    c = xs[-1] if df in ("NHWC", "NLC", "NDHWC") else xs[1]
    mean, var, w, b = _bn_args(c)
    jm, jv = paddle.to_tensor(mean), paddle.to_tensor(var)
    pm, pv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    kw = dict(training=training, data_format=df, use_global_stats=ugs)
    _check(lambda x, w, b: JF.batch_norm(x, jm, jv, w, b, **kw),
           lambda x, w, b: PF.batch_norm(x, pm, pv, w, b, **kw),
           [2.0 * _x(*xs) + 0.5, w, b], name)
    for i in range(2):
        x = 3.0 * _x(*xs, seed=10 + i) - 1.0
        JF.batch_norm(paddle.to_tensor(x), jm, jv, paddle.to_tensor(w),
                      paddle.to_tensor(b), **kw)
        PF.batch_norm(torch.from_numpy(x), pm, pv, torch.from_numpy(w),
                      torch.from_numpy(b), **kw)
    _close(pm, jm, what="running mean")
    _close(pv, jv, what="running variance")
    if training and not ugs:
        # Paddle's update: m * running + (1 - m) * biased batch variance
        assert not np.allclose(_np(pv), var)


def test_batch_norm_running_variance_is_biased_with_paddle_momentum():
    """One training call from running (0, 1): mean 0.1 * batch mean,
    variance 0.9 + 0.1 * the biased batch variance (torch's
    ``F.batch_norm`` would give 0.9 + 0.1 * n / (n - 1) of it)."""
    x = _x(2, 2, 1, 1)
    pm, pv = torch.zeros(2), torch.ones(2)
    PF.batch_norm(torch.from_numpy(x), pm, pv, training=True)
    xs = x.reshape(2, 2)
    np.testing.assert_allclose(pm.numpy(), 0.1 * xs.mean(0), rtol=1e-6)
    np.testing.assert_allclose(pv.numpy(), 0.9 + 0.1 * xs.var(0),
                               rtol=1e-6)


def test_batch_norm_bf16_with_bf16_buffers_matches_jax():
    """bf16 x, weight, bias and buffers (a model after ``bfloat16()``):
    fp32 statistics, the normalised value rounded to bf16, then the
    product and the sum in bf16, the update in fp32 cast back to bf16."""
    xs = (4, 3, 5, 6)
    mean, var, w, b = _bn_args(3)
    x = 2.0 * _x(*xs) + 0.5
    bf = jnp.bfloat16
    j = [paddle.to_tensor(a.astype(bf)) for a in (x, mean, var, w, b)]
    p = [torch.from_numpy(a).bfloat16() for a in (x, mean, var, w, b)]
    for training in (True, False):
        jo = JF.batch_norm(j[0], j[1], j[2], j[3], j[4], training=training)
        po = PF.batch_norm(p[0], p[1], p[2], p[3], p[4], training=training)
        assert po.dtype == torch.bfloat16 and str(jo.dtype) == "bfloat16"
        got, want = _np(po), _np(jo)
        lim = 2.0 ** -8 * (np.abs(want) + (np.abs(w) + np.abs(b))
                           .reshape(1, 3, 1, 1))
        assert (np.abs(got - want) <= lim).all(), training
    for pt, jt in ((p[1], j[1]), (p[2], j[2])):
        assert pt.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(pt), _np(jt), rtol=2.0 ** -8, atol=0)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _carry(jl, pl):
    sd = {k: _np(v) for k, v in jl.state_dict().items()}
    assert list(pl.state_dict()) == list(sd)
    missing, unexpected = pl.set_state_dict(sd)
    assert missing == [] and unexpected == []


# (class name, positional args, keyword args, x shape): the functional
# cases' configurations, whose ops JAX has compiled already
LAYER_CASES = [
    ("Conv1D", (4, 6, 3, 2, 1), {}, (2, 4, 13)),
    ("Conv2D", (4, 6, 3, 2, [0, 1, 2, 1], 1, 2), {}, (2, 4, 9, 11)),
    ("Conv2D", (4, 4, 3, 1, 1, 1, 4),
     dict(bias_attr=False, data_format="NHWC"), (2, 7, 7, 4)),
    ("Conv3D", (2, 4, 3, (1, 2, 1), 1), {}, (1, 2, 5, 6, 7)),
    ("Conv1DTranspose", (4, 3, 4, 3, 2, 1), {}, (2, 4, 7)),
    ("Conv2DTranspose", (4, 6, 3, 2, 1, 1, 1, 2), {}, (2, 4, 5, 6)),
    ("Conv3DTranspose", (2, 3, (2, 3, 2), 2), {}, (1, 2, 3, 4, 3)),
]


@pytest.mark.parametrize("cls,args,kw,xs", LAYER_CASES,
                         ids=[f"{c[0]}_{i}" for i, c in
                              enumerate(LAYER_CASES)])
def test_conv_layers_match_jax(cls, args, kw, xs):
    """Weights from one seed (XavierNormal with the conv fans: normals
    within a few fp32 ulps), the same names, then the forward with the
    JAX layer's weights."""
    paddle.seed(5)
    paddle_tpu_torch.seed(5)
    jl = getattr(jnn, cls)(*args, **kw)
    pl = getattr(pnn, cls)(*args, device="cpu", **kw)
    for (jn, jp), (pn, pp) in zip(jl.named_parameters(),
                                  pl.named_parameters()):
        assert jn == pn and tuple(jp.shape) == tuple(pp.shape)
        np.testing.assert_allclose(_np(pp), _np(jp), rtol=1e-5, atol=1e-6)
    _carry(jl, pl)
    x = _x(*xs)
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)))


def test_pool_layers_match_jax():
    x = _x(2, 3, 9, 8)
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    for cls, args, kw, a in (
            ("MaxPool2D", (3, 2, 1), {}, x),
            ("MaxPool2D", (3, 2, 1, True), dict(data_format="NHWC"), xh),
            ("AvgPool2D", (2, 2, 1, True), dict(exclusive=False), x),
            ("MaxPool1D", (3, 2, 1), {}, x[:, :, 0]),
            ("AvgPool1D", (3, 2), {}, x[:, :, 0]),
            ("MaxPool3D", (2,), {}, x[None]),
            ("AvgPool3D", (2, 1, 1), {}, x[None]),
            ("AdaptiveAvgPool1D", (4,), {}, x[:, :, 0]),
            ("AdaptiveAvgPool2D", ((1, 1),), dict(data_format="NHWC"), xh),
            ("AdaptiveAvgPool3D", (2,), {}, x[None]),
            ("AdaptiveMaxPool2D", ((3, 4),), {}, x)):
        a = np.ascontiguousarray(a)
        got = getattr(pnn, cls)(*args, **kw)(torch.from_numpy(a))
        want = getattr(jnn, cls)(*args, **kw)(paddle.to_tensor(a))
        _close(got, want, what=cls)


@pytest.mark.parametrize("cls,xs,df", [("BatchNorm2D", (4, 3, 5, 6), "NCHW"),
                                       ("BatchNorm", (4, 5, 6, 3), "NHWC"),
                                       ("BatchNorm1D", (8, 3), "NCL"),
                                       ("BatchNorm3D", (2, 3, 4, 5, 3),
                                        "NDHWC")])
def test_batch_norm_layers_match_jax(cls, xs, df):
    """Names and buffers (``_mean``, ``_variance``) as JAX's; two training
    calls, then eval, after carrying weight, bias and buffers."""
    jl = getattr(jnn, cls)(3, 0.8, 1e-4, data_format=df)
    pl = getattr(pnn, cls)(3, 0.8, 1e-4, data_format=df, device="cpu")
    assert list(pl.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    mean, var, w, b = _bn_args(3)
    sd = {"weight": w, "bias": b, "_mean": mean, "_variance": var}
    jl.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
    pl.set_state_dict(sd)
    for i in range(2):
        x = _x(*xs, seed=i)
        _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)))
    jl.eval()
    pl.eval()
    x = _x(*xs, seed=7)
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)))
    for k, v in jl.state_dict().items():
        _close(pl.state_dict()[k], v, what=k)


def test_layer_signatures_follow_jax():
    """Every positional parameter of the JAX layer, in its order, with its
    default; the port's ``device`` / ``dtype`` / ``generator`` come after,
    keyword-only."""
    for cls in (pnn.conv.__all__ + pnn.pooling.__all__
                + ["BatchNorm", "BatchNorm1D", "BatchNorm2D",
                   "BatchNorm3D"]):
        jp = list(inspect.signature(getattr(jnn, cls)).parameters.values())
        pp = list(inspect.signature(getattr(pnn, cls)).parameters.values())
        assert [(p.name, p.default) for p in pp[:len(jp)]] == \
            [(p.name, p.default) for p in jp], cls
        assert all(p.kind == p.KEYWORD_ONLY for p in pp[len(jp):]), cls


# ---------------------------------------------------------------------------
# AMP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_casts_the_conv_path_as_jax(level):
    """Under ``auto_cast`` conv runs in bf16 (white list; O2 too), the
    pools in bf16 only under O2, batch_norm in fp32 (black list)."""
    x = _x(2, 3, 8, 8)
    w = _x(4, 3, 3, 3, seed=1)
    mean, var, g, b = _bn_args(4)

    def chain(F, t, level):
        with t.amp.auto_cast(level=level):
            y = F.conv2d(t.x(x), t.x(w), padding=1)
            z = F.max_pool2d(y, 2)
            n = F.batch_norm(z, t.x(mean), t.x(var), t.x(g), t.x(b))
            a = F.adaptive_avg_pool2d(n, 1)
        return [str(v.dtype).split(".")[-1] for v in (y, z, n, a)], a

    class J:
        amp, x = jamp, staticmethod(paddle.to_tensor)

    class P:
        amp, x = pamp, staticmethod(torch.from_numpy)

    jd, ja = chain(JF, J, level)
    pd, pa = chain(PF, P, level)
    assert pd == jd
    _close(pa, ja, rel=2.0 ** -7)
