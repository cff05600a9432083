"""The conv path on the card: cuDNN's convolutions at float32 under
torch's default flags, channel-last without copies, and the small ResNet
on the card against the CPU.

Needs a CUDA device; every test skips where torch.cuda.is_available() is
False.  Imports no JAX, so on a machine without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_resnet_card.py

- a float32 conv (forward, and the gradients of x and of the weight)
  with torch's default ``torch.backends.cudnn.allow_tf32 = True``: within
  float32 limits of the same conv in float64 on the card, as the TF32-off
  conv is, while cuDNN's own TF32 conv misses them (the test can see the
  fault); the flag is back to True after each call;
- an NHWC conv and BatchNorm, forward and backward, make no layout copy
  of the activation (``aten::clone`` / ``contiguous`` of its shape in
  either order of axes, under torch.profiler), and give NHWC-contiguous
  outputs;
- BatchNorm in bf16 with bf16 buffers on the card within one bf16 step
  (plus 2^-8 of |w| + |b|) of the CPU's;
- ResNet-18 (10 classes, B=2, 64 x 64) in both layouts, two
  ``Momentum(0.01, 0.9)`` steps on the card and on the CPU from the same
  weights: the step-1 loss within 1e-5 relative, each step-1 gradient
  within 5e-3 of its norm (a ReLU input within rounding of 0 may take the
  other branch: `tests/test_torch_port_resnet.py`), the running
  statistics after step 1 within 1e-5 and after step 2 within 1e-3.
"""
import pytest
import torch

import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.vision import models as pvm


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the conv path on the card)")


@pytest.fixture
def default_cudnn_flags(needs_cuda):
    """torch's default cuDNN flags for the test (TF32 on), restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = prev


def _rel(a, b):
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_fp32_conv_is_fp32_under_default_flags(default_cudnn_flags, df):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 256, 14, 14, generator=g, dtype=torch.float64)
    w = torch.randn(256, 256, 3, 3, generator=g, dtype=torch.float64) / 48
    dy = torch.randn(8, 256, 14, 14, generator=g, dtype=torch.float64)
    if df == "NHWC":
        x, dy = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)

    def run(fn, dtype):
        xx = x.to("cuda", dtype).contiguous().requires_grad_()
        ww = w.to("cuda", dtype).requires_grad_()
        y = fn(xx, ww)
        (y * dy.to("cuda", dtype)).sum().backward()
        return y, xx.grad, ww.grad

    port = lambda a, b: PF.conv2d(a, b, padding=1, data_format=df)  # noqa
    ref = run(port, torch.float64)
    got = run(port, torch.float32)
    assert torch.backends.cudnn.allow_tf32
    for a, b, what in zip(got, ref, ("y", "dx", "dw")):
        assert _rel(a, b) <= 1e-5, (what, _rel(a, b))

    def cudnn_tf32(a, b):
        a = a.movedim(-1, 1) if df == "NHWC" else a
        y = torch.nn.functional.conv2d(a, b, padding=1)
        return y.movedim(1, -1) if df == "NHWC" else y

    tf32 = run(cudnn_tf32, torch.float32)
    assert max(_rel(a, b) for a, b in zip(tf32, ref)) > 1e-4


def _activation_copies(fn, shape):
    """Layout copies (``aten::clone``, ``aten::contiguous``: not a dtype
    cast, which BatchNorm's float32 statistics make) of a tensor of
    ``shape`` while ``fn`` runs, by torch.profiler's input shapes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        fn()
        torch.cuda.synchronize()
    hits = []
    for ev in p.key_averages(group_by_input_shape=True):
        if ev.key in ("aten::clone", "aten::contiguous"):
            if any(list(s) == list(shape) for s in ev.input_shapes):
                hits.append((ev.key, ev.input_shapes, ev.count))
    return hits


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_conv_and_batch_norm_copy_no_activation(needs_cuda, dtype):
    x = torch.randn(8, 28, 28, 64, device="cuda", dtype=dtype,
                    requires_grad=True)
    w = (torch.randn(64, 64, 3, 3, device="cuda") / 24).to(dtype)
    w.requires_grad_()
    bw = torch.ones(64, device="cuda", dtype=dtype, requires_grad=True)
    bb = torch.zeros(64, device="cuda", dtype=dtype, requires_grad=True)
    rm = torch.zeros(64, device="cuda", dtype=dtype)
    rv = torch.ones(64, device="cuda", dtype=dtype)

    def step():
        y = PF.conv2d(x, w, padding=1, data_format="NHWC")
        z = PF.batch_norm(y, rm, rv, bw, bb, training=True,
                          data_format="NHWC")
        assert y.is_contiguous() and z.is_contiguous()
        z.float().sum().backward()

    step()                                  # cuDNN's first-call setup
    assert _activation_copies(step, (8, 28, 28, 64)) == []
    assert _activation_copies(step, (8, 64, 28, 28)) == []


@pytest.mark.cuda
def test_batch_norm_bf16_card_against_cpu(needs_cuda):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(16, 32, 14, 14, generator=g) * 2 + 0.5
    w = 1 + 0.1 * torch.randn(32, generator=g)
    b = 0.1 * torch.randn(32, generator=g)
    outs, stats = {}, {}
    for dev in ("cuda", "cpu"):
        rm = torch.zeros(32, dtype=torch.bfloat16, device=dev)
        rv = torch.ones(32, dtype=torch.bfloat16, device=dev)
        args = [t.to(dev, torch.bfloat16) for t in (x, w, b)]
        outs[dev] = PF.batch_norm(args[0], rm, rv, args[1], args[2],
                                  training=True).float().cpu()
        stats[dev] = (rm.float().cpu(), rv.float().cpu())
    lim = 2.0 ** -8 * (outs["cpu"].abs()
                       + (w.abs() + b.abs()).reshape(1, -1, 1, 1))
    assert ((outs["cuda"] - outs["cpu"]).abs() <= lim).all()
    for a, c in zip(stats["cuda"], stats["cpu"]):
        assert ((a - c).abs() <= 2.0 ** -8 * c.abs()).all()


def _resnet_steps(sd, df, dev, x, labels):
    model = pvm.resnet18(num_classes=10, data_format=df, device=dev)
    model.set_state_dict(sd)
    model.train()
    opt = popt.Momentum(learning_rate=0.01, momentum=0.9,
                        parameters=model.parameters())
    xx = (x.permute(0, 2, 3, 1).contiguous() if df == "NHWC" else x).to(dev)
    losses, grads, stats = [], {}, []
    for i in range(2):
        loss = PF.cross_entropy(model(xx), labels.to(dev))
        loss.backward()
        if i == 0:
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        stats.append({k: v.cpu().clone() for k, v in
                      model.state_dict().items() if k.endswith(
                          ("_mean", "_variance"))})
    return losses, grads, stats


@pytest.mark.cuda
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_small_resnet_card_against_cpu(default_cudnn_flags, df):
    paddle_tpu_torch.seed(0)
    sd = pvm.resnet18(num_classes=10, device="cpu").state_dict()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 64, 64, generator=g)
    labels = torch.randint(0, 10, (2,), generator=g)
    card = _resnet_steps(sd, df, "cuda", x, labels)
    cpu = _resnet_steps(sd, df, "cpu", x, labels)
    assert abs(card[0][0] - cpu[0][0]) <= 1e-5 * abs(cpu[0][0])
    assert abs(card[0][1] - cpu[0][1]) <= 1e-3 * abs(cpu[0][1])
    for n, gc in cpu[1].items():
        err = (card[1][n] - gc).norm().item()
        assert err <= 5e-3 * gc.norm().item(), (n, err)
    for step, rel in ((0, 1e-5), (1, 1e-3)):
        for k, v in cpu[2][step].items():
            err = (card[2][step][k] - v).abs().max().item()
            assert err <= rel * max(1.0, v.abs().max().item()), (step, k)
