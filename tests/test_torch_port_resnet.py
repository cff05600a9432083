"""The port's vision models (`paddle_tpu_torch.vision.models`) and datasets
against the JAX package's, on the CPU: the conv path as a whole.

- ResNet-18 (10 classes) is built in the JAX package, its weights drawn
  by numpy from a seed (He-normal convs and linear, BatchNorm weights
  near 1; JAX's own initializer draws cost ~15 s of eager compiles here
  and are held in `test_torch_port_conv.py`); its ``state_dict()``
  (parameters and the BatchNorms' ``_mean`` / ``_variance``) goes to the
  port as numpy (`convert.params_from_numpy`, `Layer.set_state_dict`),
  into an NCHW and an NHWC model alike (the weights are [out, in, kh, kw]
  in both).  Two training steps of cross entropy with ``Momentum(0.01,
  0.9)`` at B=2, 64 x 64 (at 32 x 32 the last BatchNorms see two values a
  channel and one step at lr 0.1 sends the loss to thousands): the
  losses, every step-1 gradient, the running statistics and the weights
  after the steps, then an eval-mode forward on the trained weights and
  buffers, in both layouts.  The JAX run is one module fixture (NCHW;
  JAX's weights and arithmetic are the same in either layout).
- the ResNeXt bottleneck (``groups=32, base_width=4``, stride 2 with its
  downsample): one Momentum step, output, the gradients of x and of every
  weight, the running statistics.
- LeNet through ``Model.fit`` on the synthetic ``MNIST(size=64)``: the
  images and labels bitwise JAX's, then two epochs of Momentum steps with
  ``shuffle=False``, the loss of every step as JAX's, and falling.

Limits.  Forward values (the step-1 loss, the eval logits, the block's
output) within 1e-5 relative or of max(1, max|JAX|).  A ReLU whose input
lies within fp32 rounding of 0 (of some 4e5 in a ResNet-18 step, one
now and then) may take the other branch in another summation order (the
NHWC model met one on JAX's own initial weights): the gradient of that
element moves by O(1), and of every tensor before it by ~1e-3 of its
norm.  So each step-1 gradient holds
``|g - g_jax|_2 <= 5e-3 |g_jax|_2`` (a wrong conv, pool or BatchNorm moves
a whole tensor by O(1)), and what the first update carries (the step-2
loss, the weights and running statistics after two steps) within 1e-3
relative or of max(1, max|JAX|).  The block's gradients within 1e-4 of
their max|g|, its state after the step and LeNet's losses within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import models as jvm

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import models as pvm
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)

B, HW, LR, STEPS, REL = 2, 64, 0.01, 2, 1e-5
GRAD_REL, GRAD_L2, CARRIED = 1e-4, 5e-3, 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, np.ndarray):
        return t
    return np.asarray(t.numpy()).astype(np.float32)


def _close(got, want, rel=REL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    tol = rel * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randn(B, 3, HW, HW).astype(np.float32),
            rng.randint(0, 10, (B,)).astype(np.int64))


def _weights(model):
    """numpy weights for ``model``'s ``state_dict`` from one seed: convs and
    linears He-normal, BatchNorm weights 1 + N(0, 0.1^2), biases
    N(0, 0.1^2), running mean 0 and variance 1."""
    rng = np.random.RandomState(3)
    out = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("_variance"):
            out[k] = np.ones(shape, np.float32)
        elif k.endswith("_mean"):
            out[k] = np.zeros(shape, np.float32)
        elif len(shape) > 1:
            fan_in = np.prod(shape[1:]) if len(shape) == 4 else shape[0]
            out[k] = (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
        else:
            base = 1.0 if k.endswith("weight") else 0.0
            out[k] = (base + 0.1 * rng.randn(*shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's ResNet-18: initial state, two Momentum steps (losses, step-1
    gradients), the state after them, then eval logits on it."""
    jinit.set_global_initializer(jinit.Constant(0.0), jinit.Constant(0.0))
    try:
        jm = jvm.resnet18(num_classes=10)
    finally:
        jinit.set_global_initializer(None, None)
    init = _weights(jm)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    x, labels = (paddle.to_tensor(a) for a in _batch())
    opt = jopt.Momentum(learning_rate=LR, momentum=0.9,
                        parameters=jm.parameters())
    jm.train()
    losses, grads = [], {}
    for i in range(STEPS):
        loss = JF.cross_entropy(jm(x), labels)
        loss.backward()
        if i == 0:
            grads = {n: _np(p.grad) for n, p in jm.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    final = {k: _np(v) for k, v in jm.state_dict().items()}
    jm.eval()
    return dict(init=init, losses=losses, grads=grads, final=final,
                eval_logits=_np(jm(x)))


def _port(state, df):
    pm = pvm.resnet18(num_classes=10, data_format=df, device="cpu")
    missing, unexpected = pm.set_state_dict(params_from_numpy(state,
                                                              device="cpu"))
    assert missing == [] and unexpected == []
    return pm


def _images(x, df):
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 3, 1) if df == "NHWC" else x))


def test_state_dict_names_in_jax_order(jax_run):
    """Parameters, then the BatchNorms' buffers, under JAX's names and in
    its order, in both layouts."""
    names = list(jax_run["init"])
    assert "layer1.0.bn1._variance" in names
    assert "layer2.0.downsample.0.weight" in names
    for df in ("NCHW", "NHWC"):
        assert list(_port(jax_run["init"], df).state_dict()) == names


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_resnet18_two_momentum_steps_match_jax(jax_run, df):
    pm = _port(jax_run["init"], df)
    x, labels = _batch()
    x, labels = _images(x, df), torch.from_numpy(labels)
    opt = popt.Momentum(learning_rate=LR, momentum=0.9,
                        parameters=pm.parameters())
    pm.train()
    losses = []
    for i in range(STEPS):
        loss = PF.cross_entropy(pm(x), labels)
        loss.backward()
        if i == 0:
            for n, p in pm.named_parameters():
                want = jax_run["grads"][n]
                err = np.linalg.norm(_np(p.grad) - want)
                assert err <= GRAD_L2 * np.linalg.norm(want), (n, err)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses[0], jax_run["losses"][0], rtol=REL)
    np.testing.assert_allclose(losses[1], jax_run["losses"][1],
                               rtol=CARRIED)
    assert losses[1] < losses[0]
    for k, v in pm.state_dict().items():
        _close(v, jax_run["final"][k], rel=CARRIED, what=k)
    assert not np.allclose(jax_run["final"]["bn1._variance"], 1.0)
    pe = _port(jax_run["final"], df)
    pe.eval()
    _close(pe(x), jax_run["eval_logits"], what="eval logits")


def test_resnext_bottleneck_block_one_step_matches_jax():
    """``BottleneckBlock(256, 64, stride=2, downsample, groups=32,
    base_width=4)``: width 128, a grouped 3 x 3 conv of 32 groups."""
    paddle.seed(1)
    jblk = jvm.BottleneckBlock(
        256, 64, stride=2, downsample=jnn.Sequential(
            jnn.Conv2D(256, 256, 1, stride=2, bias_attr=False),
            jnn.BatchNorm2D(256)), groups=32, base_width=4)
    pblk = pvm.BottleneckBlock(
        256, 64, stride=2, downsample=pnn.Sequential(
            pnn.Conv2D(256, 256, 1, stride=2, bias_attr=False,
                       device="cpu"),
            pnn.BatchNorm2D(256, device="cpu")), groups=32, base_width=4,
        device="cpu")
    assert tuple(pblk.conv2.weight.shape) == (128, 4, 3, 3)
    sd = {k: _np(v) for k, v in jblk.state_dict().items()}
    assert list(pblk.state_dict()) == list(sd)
    pblk.set_state_dict(sd)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 256, 8, 8).astype(np.float32)
    g = rng.randn(2, 256, 4, 4).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    px = torch.tensor(x, requires_grad=True)
    jopt_ = jopt.Momentum(learning_rate=LR, parameters=jblk.parameters())
    popt_ = popt.Momentum(learning_rate=LR, parameters=pblk.parameters())
    jo, po = jblk(jx), pblk(px)
    (jo * paddle.to_tensor(g)).sum().backward()
    (po * torch.from_numpy(g)).sum().backward()
    _close(po, jo, what="output")
    _close(px.grad, jx.grad, what="grad x")
    for (n, jp), (_, pp) in zip(jblk.named_parameters(),
                                pblk.named_parameters()):
        want = _np(jp.grad)
        np.testing.assert_allclose(_np(pp.grad), want, rtol=0,
                                   atol=GRAD_REL * float(np.abs(want).max()),
                                   err_msg=n)
    jopt_.step()
    popt_.step()
    for k, v in jblk.state_dict().items():
        _close(pblk.state_dict()[k], v, what=k)


class _Losses:
    """A callback of either package that keeps each step's loss."""

    @staticmethod
    def make(cb):
        class Rec(cb.Callback):
            def __init__(self):
                super().__init__()
                self.losses = []

            def on_train_batch_end(self, step, logs=None):
                loss = logs["loss"]
                self.losses.append(float(np.ravel(loss)[0]))
        return Rec()


def test_lenet_fit_on_synthetic_mnist_matches_jax():
    """Rung 1 of the ladder: the synthetic MNIST bitwise JAX's, LeNet's
    weights carried, two epochs of ``fit`` (4 batches of 16 an epoch)."""
    jdata, pdata = jds.MNIST(mode="train", size=64), pds.MNIST(size=64)
    assert pdata.synthetic and jdata.synthetic and len(pdata) == 64
    np.testing.assert_array_equal(pdata.images, jdata.images)
    np.testing.assert_array_equal(pdata.labels, jdata.labels)
    for i in (0, 63):
        for a, b in zip(pdata[i], jdata[i]):
            np.testing.assert_array_equal(a, b)
    paddle.seed(0)
    jnet = jvm.LeNet()
    pnet = pvm.LeNet(device="cpu")
    pnet.set_state_dict({k: _np(v) for k, v in jnet.state_dict().items()})
    runs = {}
    for name, hapi, net, data, opt, nn, cb in (
            ("jax", paddle, jnet, jdata, jopt, jnn, jcb),
            ("port", pt, pnet, pdata, popt, pnn, pcb)):
        model = hapi.Model(net)
        model.prepare(opt.Momentum(learning_rate=LR, momentum=0.9,
                                   parameters=net.parameters()),
                      nn.CrossEntropyLoss())
        rec = _Losses.make(cb)
        model.fit(data, batch_size=16, epochs=2, shuffle=False, verbose=0,
                  callbacks=[rec])
        runs[name] = rec.losses
    assert len(runs["port"]) == 8
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=REL)
    assert np.mean(runs["port"][4:]) < np.mean(runs["port"][:4])
