"""Two edges of the conv path, paddle_tpu_torch against the JAX package on
the CPU, each functional called in both packages with the same numpy
input.

(a) Padding given as a list of (low, high) pairs whose length is not the
    number of spatial dims (Paddle's form with the N and C pairs, or too
    few): each conv and pool functional raises the exception class JAX
    raises there (a conv TypeError, a pool ValueError; 2 nd pairs, which
    JAX reads as 2 nd ints, the other), and a transposed conv takes the
    first nd of more pairs, as JAX's does, with the same output.
(b) A window larger than its padded input: JAX's empty output (a 0 in
    the spatial shape) where torch would raise, and with ``ceil_mode`` the
    one window JAX keeps, of JAX's values (1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn.functional as PF

# (functional kind, spatial dims, pairs)
PAIR_CASES = [(kind, nd, n) for nd in (1, 2, 3)
              for kind in ("conv", "conv_transpose", "max_pool", "avg_pool")
              for n in sorted({1, nd - 1, nd + 1, nd + 2, 2 * nd} - {0, nd})]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker (as `tests/test_torch_port_conv.py`);
    the count is put back after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _call(pkg, kind, nd, x, **kw):
    """``kind`` of ``pkg`` (JF or PF) on numpy ``x`` [1, 2, *spatial]: a
    conv by a 3-tap [3, 2, ...] weight (a transpose by [2, 3, ...]), a
    pool of window 2.  Returns the output as numpy."""
    rng = np.random.RandomState(nd)
    if kind in ("conv", "conv_transpose"):
        shape = (3, 2) if kind == "conv" else (2, 3)
        w = rng.rand(*shape, *([kw.pop("k", 3)] * nd)).astype(np.float32)
        name = f"conv{nd}d" + ("_transpose" if kind != "conv" else "")
        args = (w,)
    else:
        name, args = f"{kind}{nd}d", (kw.pop("k", 2),)
    fn = getattr(pkg, name)
    if pkg is JF:
        args = tuple(paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
                     for a in args)
        out = fn(paddle.to_tensor(x), *args, **kw)
        return np.asarray(out.numpy(), np.float32)
    args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args)
    return fn(torch.from_numpy(x), *args, **kw).numpy()


def _raised(pkg, *args, **kw):
    try:
        return _call(pkg, *args, **kw)
    except Exception as e:        # the class is what both packages compare
        return type(e)


@pytest.mark.parametrize("kind,nd,n", PAIR_CASES)
def test_padding_pairs_of_another_length(kind, nd, n):
    x = np.random.RandomState(0).rand(1, 2, *([8] * nd)).astype(np.float32)
    pads = [[0, 0]] * (n - nd) + [[1, 2]] * nd if n > nd else [[1, 2]] * n
    want = _raised(JF, kind, nd, x, padding=pads)
    got = _raised(PF, kind, nd, x, padding=pads)
    if isinstance(want, type):
        assert got is want, (got, want)
        assert kind == "conv_transpose" or want in (TypeError, ValueError)
    else:
        assert kind == "conv_transpose" and n > nd
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# (kind, spatial dims, input size, window, keywords)
EMPTY_CASES = [(kind, nd, 4, 5, {}) for nd in (1, 2, 3)
               for kind in ("conv", "max_pool", "avg_pool")] + [
    ("conv", 1, 7, 3, {"dilation": 5}),
    ("conv", 2, 4, 6, {"stride": 2}),
    ("conv", 1, 2, 5, {"data_format": "NLC"}),
    ("max_pool", 2, 4, 7, {"padding": 1}),
    ("avg_pool", 2, 4, 7, {"padding": 1}),
    ("max_pool", 2, 4, 5, {"ceil_mode": True}),
    ("avg_pool", 2, 4, 5, {"ceil_mode": True}),
    ("avg_pool", 1, 4, 5, {"ceil_mode": True, "exclusive": False}),
]


@pytest.mark.parametrize("kind,nd,size,k,kw", EMPTY_CASES)
def test_window_larger_than_padded_input(kind, nd, size, k, kw):
    shape = (1, 2, *([size] * nd))
    if kw.get("data_format") == "NLC":
        shape = (1, size, 2)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = _call(JF, kind, nd, x, k=k, **kw)
    got = _call(PF, kind, nd, x, k=k, **kw)
    assert got.shape == want.shape
    if not kw.get("ceil_mode"):
        assert 0 in got.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_max_pool2d_mask_and_gradient_of_an_empty_output():
    """``return_mask`` gives an empty int32 mask beside the empty output,
    and an empty output is in the autograd graph (zero gradients)."""
    x = torch.rand(1, 2, 4, 4, requires_grad=True)
    out, mask = PF.max_pool2d(x, 5, return_mask=True)
    assert out.shape == mask.shape == (1, 2, 0, 0)
    assert mask.dtype == torch.int32
    w = torch.rand(3, 2, 5, 5, requires_grad=True)
    y = PF.conv2d(x, w)
    (y.sum() + out.sum()).backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    assert torch.equal(w.grad, torch.zeros_like(w))
