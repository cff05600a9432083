"""paddle_tpu_torch's ``nn.functional.cross_entropy`` in the JAX
package's argument order, and the trailing ``name`` of the port's
functional ops and ``nn.Dropout``, against the JAX package on the CPU.

Every call gives both packages the same positional (or keyword)
arguments on the same numpy inputs, made from a seed:

- the four calls ROADMAP's Queue 3 records: ``(x, y, None, 3)``
  (``ignore_index`` by position), ``(x, y, w)`` (class weights),
  ``reduction="sum"``, and the ``input=`` / ``label=`` keywords;
- each branch: soft labels with and without softmax, ``axis`` other
  than the last (hard and soft labels), ``label_smoothing`` with and
  without softmax, class weights with ``ignore_index`` under every
  reduction, labels shaped ``[N, 1]``, bf16 logits;
- ``name`` in JAX's place on ``linear``, ``softmax``, ``layer_norm``,
  ``embedding`` (after ``sparse``), ``dropout`` and ``nn.Dropout``.

Tolerance 1e-6 absolute plus 1e-6 relative: both sides compute in fp32,
in different orders of summation.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.nn import Dropout
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


RNG = np.random.RandomState(7)
X = RNG.randn(6, 5).astype(np.float32)
Y = RNG.randint(0, 5, (6,)).astype(np.int64)
Y[2] = 3
W = RNG.rand(5).astype(np.float32) + 0.5
SOFT = RNG.rand(6, 5).astype(np.float32)
SOFT /= SOFT.sum(-1, keepdims=True)
PROBS = np.exp(X) / np.exp(X).sum(-1, keepdims=True)


def _j(a):
    return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a


def _t(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _both(fn_j, fn_t, *args, **kw):
    want = fn_j(*(_j(a) for a in args), **{k: _j(v) for k, v in kw.items()})
    got = fn_t(*(_t(a) for a in args), **{k: _t(v) for k, v in kw.items()})
    return np.asarray(want.numpy(), np.float32), \
        got.detach().float().numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


CASES = {
    "ignore_index by position": ((X, Y, None, 3), {}),
    "class weights": ((X, Y, W), {}),
    "sum": ((X, Y), {"reduction": "sum"}),
    "keywords": ((), {"input": X, "label": Y}),
    "none": ((X, Y), {"reduction": "none"}),
    "labels [N, 1]": ((X, Y[:, None]), {}),
    "weights and ignore_index, mean": ((X, Y, W, 3), {}),
    "weights and ignore_index, sum": ((X, Y, W, 3, "sum"), {}),
    "weights and ignore_index, none": ((X, Y, W, 3, "none"), {}),
    "soft labels": ((X, SOFT), {"soft_label": True}),
    "soft labels, sum": ((X, SOFT, None, -100, "sum", True), {}),
    "soft labels without softmax": ((PROBS, SOFT, None, -100, "none", True,
                                     -1, False), {}),
    "axis 0": ((X.T.copy(), Y[None, :].copy()), {"axis": 0}),
    "soft labels, axis 0": ((X.T.copy(), SOFT.T.copy()),
                            {"soft_label": True, "axis": 0}),
    "label smoothing": ((X, Y), {"label_smoothing": 0.1}),
    "label smoothing, weights": ((X, Y, W), {"label_smoothing": 0.2,
                                             "ignore_index": 3}),
    "without softmax": ((PROBS, Y), {"use_softmax": False}),
    "without softmax, label smoothing": ((PROBS, Y, None, -100, "none",
                                          False, -1, False, 0.1), {}),
    "name": ((X, Y, None, -100, "mean", False, -1, True, 0.0, "ce"), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_entropy_matches_jax(case):
    args, kw = CASES[case]
    want, got = _both(JF.cross_entropy, PF.cross_entropy, *args, **kw)
    assert got.shape == want.shape
    _close(got, want)


def test_bf16_logits_match_jax():
    xb = torch.from_numpy(X).bfloat16()
    xj = paddle.to_tensor(X).astype("bfloat16")
    for args in ((Y,), (Y, W, 3, "sum")):
        want = JF.cross_entropy(xj, *(_j(a) for a in args))
        got = PF.cross_entropy(xb, *(_t(a) for a in args))
        assert got.dtype == torch.float32
        _close(got.numpy(), np.asarray(want.numpy(), np.float32))


def test_the_port_no_longer_refuses_jax_calls():
    """ROADMAP's Queue 3: each of these raised in the port before."""
    x, y = torch.from_numpy(X), torch.from_numpy(Y)
    assert torch.isfinite(PF.cross_entropy(x, y, None, 3))
    assert torch.isfinite(PF.cross_entropy(x, y, torch.from_numpy(W)))
    assert torch.isfinite(PF.cross_entropy(x, y, reduction="sum"))
    assert torch.isfinite(PF.cross_entropy(input=x, label=y))


H = RNG.randn(3, 4, 8).astype(np.float32)
LW = RNG.rand(8).astype(np.float32)
LB = RNG.randn(8).astype(np.float32)
IDS = RNG.randint(0, 10, (3, 4)).astype(np.int64)
EMB = RNG.randn(10, 8).astype(np.float32)
LIN = RNG.randn(8, 6).astype(np.float32)

NAMED = {
    "linear": ("linear", (H, LIN, LB[:6], "fc")),
    "softmax": ("softmax", (H, -1, None, "sm")),
    "softmax axis 1": ("softmax", (H, 1, None, "sm")),
    "layer_norm": ("layer_norm", (H, 8, LW, LB, 1e-5, "ln")),
    "embedding": ("embedding", (IDS, EMB, None, False, "emb")),
    "embedding padding_idx": ("embedding", (IDS, EMB, 2, False, "emb")),
    "dropout, p 0": ("dropout", (H, 0.0, None, True, "upscale_in_train",
                                 "drop")),
    "dropout, inference": ("dropout", (H, 0.3, None, False,
                                       "downscale_in_infer", "drop")),
    "dropout, upscale, inference": ("dropout", (H, 0.3, None, False,
                                                "upscale_in_train", "drop")),
}


@pytest.mark.parametrize("case", sorted(NAMED))
def test_trailing_name_matches_jax(case):
    fn, args = NAMED[case]
    want, got = _both(getattr(JF, fn), getattr(PF, fn), *args)
    _close(got, want)


def test_dropout_layer_takes_name_in_jax_position():
    for mode in ("upscale_in_train", "downscale_in_infer"):
        jl = jnn.Dropout(0.25, None, mode, "drop")
        tl = Dropout(0.25, None, mode, "drop")
        jl.eval()
        tl.eval()
        want = jl(paddle.to_tensor(H)).numpy()
        _close(tl(torch.from_numpy(H)).numpy(), np.asarray(want))
    # the generator is keyword-only: a fourth positional is the name
    g = torch.Generator().manual_seed(0)
    a = Dropout(0.5, None, "upscale_in_train", "drop", generator=g)
    kept = a(torch.ones(64, 64))
    assert 0.3 < (kept > 0).float().mean() < 0.7
    with pytest.raises(TypeError):
        PF.dropout(torch.ones(2), 0.5, None, True, "upscale_in_train",
                   None, g)
