"""BERT's attention path on the card: the flash kernels with a key-padding
mask, against their plain versions.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_bert_card.py

- the non-causal flash forward, dQ and dK/dV with BERT's [B, 1, 1, S]
  padding mask (bool or additive) read as a stride-0 view over the
  queries (`normalize_mask`: nothing copied), at S = 128 and 512, in
  float32, bfloat16 and float16, against the plain versions; each launch
  counted under the kernel's ``:mask`` variant;
- `nn.functional.scaled_dot_product_attention` under autograd with that
  mask: one launch of each kernel, gradients as the plain backward's;
- the head-dim gate: head_dim 32 takes `mha_reference` with no launch,
  head_dim 384 one launch of the forward kernel at that head dim
  (``flash_fwd_causal:wide``), within the bf16 limit of the plain version;
- dropout's keep masks: the threefry kernel (``csrc/threefry_bernoulli.cu``)
  bitwise equal to the plain `core.random.bernoulli` (JAX's keys) on the
  card and on the CPU;
- a 2-layer BERT at hidden 128 with the padding mask, its float32 logits
  on the card within 1e-4 of the CPU's.

Limits (`paddle_tpu_torch.ops.tolerance`): float32 forward ``FP32_FWD``,
backward ``1e-4 max|ref|``; bfloat16 / float16 the per-element limits of
the flash kernels.
"""
import pytest
import torch

import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import ops
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import threefry
from paddle_tpu_torch.ops import tolerance as tol

TYPES = (torch.float32, torch.bfloat16, torch.float16)
BWD_REL_FP32 = 1e-4


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (BERT's masked flash kernels vs "
                    "plain)")


def _within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def key_mask(b, s, kind, seed=0):
    """BERT's padding mask [B, 1, 1, S]: row i keeps its first len_i keys,
    lengths drawn in 16 .. S from ``seed``; bool (True keeps) or additive
    (0 / -1e4)."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(16, s + 1, (b,), generator=g)
    lens[0] = s
    keep = torch.arange(s)[None, :] < lens[:, None]
    m = keep[:, None, None, :]
    if kind == "additive":
        m = torch.where(m, 0.0, -1e4)
    return m.cuda()


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("kind", ["bool", "additive"])
@pytest.mark.parametrize("b,s", [(8, 128), (2, 512)])
def test_key_mask_forward_and_backward_match_plain(dtype, kind, b, s):
    h, d = 12, 64
    q, k, v, do = _qkv(b, s, h, d, dtype, s)
    mask = key_mask(b, s, kind, seed=s)
    m4 = fa.normalize_mask(mask, b, h, s, s)
    assert m4.stride()[1:3] == (0, 0)
    scale = d ** -0.5
    ops.reset_launch_counts()
    out, lse, pair = fa._launch(q, k, v, scale, False, m4)
    want = fa.mha_reference(q, k, v, m4, False, scale)
    limit = tol.FP32_FWD if dtype == torch.float32 else \
        tol.flash_fwd_limit(out, want, q, k, v, False, m4)
    _within(out, want, limit, f"forward {kind} B={b} S={s} {dtype}")
    rm, ls = fa.softmax_stats(q, k, scale, False, m4)
    _within(pair[0], rm, 1e-5, "row max")
    _within(pair[1], ls, 1e-5, "log l")
    row_max, stat = pair
    delta = fa.attention_delta(out, do)
    br = dict(causal=False, mask=m4)
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, row_max=row_max,
                         **br)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                              row_max=row_max, **br)
    counts = ops.launch_counts()
    wants = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=False, mask=m4,
        row_max=row_max)
    if dtype == torch.float32:
        limits = [BWD_REL_FP32 * w.abs().max().item() for w in wants]
    else:
        limits = tol.flash_bwd_limits((dq, dk, dv), wants, q, k, v, out,
                                      stat, do, scale, row_max=row_max,
                                      **br)
    torch.cuda.synchronize()
    for which, got, w, lim in zip(("dq", "dk", "dv"), (dq, dk, dv), wants,
                                  limits):
        _within(got, w, lim, f"backward {which} {kind} S={s} {dtype}")
    assert counts[fa.masked.KERNEL] == 1
    for kern in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert counts[kern.variants["mask"].KERNEL] == 1
        assert counts[kern.KERNEL] == 0


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sdpa_key_mask_autograd_launches_the_kernels(dtype):
    b, s, h, d = 4, 128, 12, 64
    q, k, v, do = _qkv(b, s, h, d, dtype, 3)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    mask = key_mask(b, s, "bool", seed=3)
    ops.reset_launch_counts()
    out = PF.scaled_dot_product_attention(q, k, v, mask)
    dq, dk, dv = torch.autograd.grad(out, [q, k, v], do)
    counts = ops.launch_counts()
    assert counts[fa.masked.KERNEL] == 1
    assert counts[fa.flash_bwd_dq.variants["mask"].KERNEL] == 1
    assert counts[fa.flash_bwd_dkv.variants["mask"].KERNEL] == 1
    m4 = fa.normalize_mask(mask, b, h, s, s)
    _, lse, pair = fa._forward(q.detach(), k.detach(), v.detach(),
                               d ** -0.5, False, m4, None, None)
    wants = fa.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), out.detach(), pair[1], do,
        d ** -0.5, is_causal=False, mask=m4, row_max=pair[0])
    for got, w in zip((dq, dk, dv), wants):
        if dtype == torch.float32:
            lim = BWD_REL_FP32 * w.abs().max().item()
        else:
            lim = 2 ** -6 * (w.float().abs() + w.float().abs().mean())
        _within(got, w, lim, f"sdpa gradient {dtype}")


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_head_dim_gate(monkeypatch):
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    fa.reset_attention_path_counts()
    q, k, v, _ = _qkv(2, 64, 4, 32, torch.float32, 5)
    ops.reset_launch_counts()
    out = PF.scaled_dot_product_attention(q, k, v)
    assert not any(ops.launch_counts().values())
    assert fa.attention_path_counts() == {"attn_fallback:head_dim": 1}
    _within(out, fa.mha_reference(q, k, v), 1e-6, "head_dim 32")
    q, k, v, _ = _qkv(1, 64, 1, 384, torch.bfloat16, 6)
    ops.reset_launch_counts()
    out = PF.scaled_dot_product_attention(q, k, v)
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    assert counts == {"flash_fwd_causal:noncausal": 1,
                      "flash_fwd_causal:wide": 1}, counts
    want = fa.mha_reference(q, k, v).to(q.dtype)
    _within(out, want, tol.flash_fwd_limit(out, want, q, k, v, False),
            "head_dim 384")


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_keep_masks_equal_on_card_and_cpu():
    """The threefry kernel's masks bitwise the plain version's, on the card
    and on the CPU; one launch a mask."""
    key = prandom.split(prandom.PRNGKey(17))[1]
    shapes = ((8, 128, 768), (32, 128, 12, 64), (3, 1, 5), (1,), (257, 3))
    ops.reset_launch_counts()
    for i, shape in enumerate(shapes):
        keep = (0.9, 0.5, 0.1, 0.9, 0.75)[i]
        got = threefry.bernoulli(key, keep, shape, "cuda")
        assert got.dtype == torch.bool and got.shape == shape
        assert torch.equal(got, prandom.bernoulli(key.cuda(), keep, shape))
        assert torch.equal(got.cpu(), threefry.bernoulli(key, keep, shape,
                                                         "cpu"))
    assert ops.launch_counts()[threefry.KERNEL] == len(shapes)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_small_bert_card_against_cpu():
    from paddle_tpu_torch.models import (BertForSequenceClassification,
                                         bert_base_config)
    cfg = bert_base_config(hidden_size=128, num_hidden_layers=2,
                           num_attention_heads=2, intermediate_size=256,
                           vocab_size=512)
    paddle_tpu_torch.seed(0)
    card = BertForSequenceClassification(cfg, device="cuda")
    cpu = BertForSequenceClassification(cfg, device="cpu")
    cpu.set_state_dict(card.state_dict())
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 512, (4, 128), generator=g)
    mask = key_mask(4, 128, "bool", seed=1)
    for m in (card, cpu):
        m.train()
    logits = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        paddle_tpu_torch.seed(3)
        logits.append(model(ids.to(dev), attention_mask=mask.to(dev)))
    torch.cuda.synchronize()
    _within(logits[0].cpu(), logits[1], 1e-4, "2-layer BERT logits")
