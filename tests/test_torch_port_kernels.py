"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_kernels.py

Tolerances against the plain version on the same inputs
(`paddle_tpu_torch.ops.tolerance` derives the bf16 ones):

- forward kernels, float32: max absolute error 2e-5 (both accumulate in
  fp32 and differ only in summation order); bfloat16: per element
  2^-7 max(|out|, |ref|) + 2^-8 P|V|.
- backward kernels, float32: max absolute error 1e-4 max|ref| per
  gradient (fp32 sums over up to S keys, in different orders); bfloat16:
  per element 2^-7 max(|out|, |ref|) + 2^-7 times the gradient's sum of
  magnitudes (P^T|dO|, scale W^T|Q|, scale W|K|, with W = P (|dO|.|V|^T
  + |dO|.|out|) bounding ds = P (dP - delta) and its fp32 noise).
- pool writes: bitwise.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol

from _torch_port_util import MIXES, mix

TOL_FP32 = 2e-5
BWD_REL_FP32 = 1e-4


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain)")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fwd_ok(out, want, mag):
    """Max error, and whether every element is within the limit of its
    dtype (module docstring); ``mag`` is P|V|, used in bf16 only."""
    limit = (TOL_FP32 if out.dtype == torch.float32
             else tol.bf16_limit(out, want, mag, tol.FWD_COEF))
    err, _, ok = tol.compare(out, want, limit)
    return err, ok


def _fused_qkv(b, s, h, d, dtype, seed):
    """q, k, v as slices of one fused [B, S, 3, H, D] projection, as the
    GPT block passes them."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3, h, d, generator=g).to("cuda",
                                                      dtype).unbind(2)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(7, 64), (200, 64), (130, 128)])
def test_flash_kernel_matches_plain(s, d, dtype):
    q, k, v = _fused_qkv(2, s, 3, d, dtype, s + d)
    out, lse = fa.flash_attention_arrays(q, k, v, return_lse=True)
    want, want_lse = fa.mha_reference(q, k, v, is_causal=True,
                                      return_lse=True)
    torch.cuda.synchronize()
    err, ok = _fwd_ok(out, want, tol.flash_fwd_magnitude(q, k, v))
    assert ok, err
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(7, 64), (200, 64), (130, 128)])
def test_flash_bwd_kernels_match_plain(s, d, dtype):
    q, k, v = _fused_qkv(2, s, 3, d, dtype, 10 * s + d)
    scale = d ** -0.5
    out, lse = fa.flash_attention_arrays(q, k, v, return_lse=True)
    g = torch.Generator().manual_seed(s)
    # a strided dO: the [B, S, H, D] view of a [B, S, 2, H, D] tensor
    do = torch.randn(2, s, 2, 3, d, generator=g).to("cuda", dtype)[:, :, 1]
    delta = fa.attention_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    mags = tol.flash_bwd_magnitudes(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    for name, got, ref, mag in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                   mags):
        assert got.shape == ref.shape and got.dtype == dtype
        limit = (BWD_REL_FP32 * ref.abs().max().item()
                 if dtype == torch.float32
                 else tol.bf16_limit(got, ref, mag, tol.BWD_COEF))
        err, ratio, ok = tol.compare(got, ref, limit)
        assert ok, (name, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_flash_autograd_launches_both_bwd_kernels():
    q, k, v = (t.detach().requires_grad_()
               for t in _fused_qkv(1, 65, 2, 64, torch.float32, 3))
    fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0
    out = fa.flash_attention_arrays(q, k, v)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == 1 and fa.flash_bwd_dkv.launches == 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mix_name", MIXES)
def test_ragged_kernel_matches_plain(mix_name, dtype):
    q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = mix(mix_name)
    nb, bs, H, _ = geo
    d = 64
    rng = np.random.RandomState(2)
    b, c, _, _ = q.shape
    q, kn, vn = _t(rng.randn(b, c, 3, H, d).astype(np.float32)).unbind(2)
    kb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    vb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    dev = [x.to("cuda", dtype) for x in (q, kn, vn, kb, vb)]
    idx = [_t(a).cuda() for a in (tables, pos0, lens, slots)]
    ref = [x.clone() for x in dev[3:]]
    out, k2, v2 = rpa.ragged_paged_attention_arrays(*dev, *idx)
    want, k2r, v2r = rpa.ragged_paged_attention_reference(
        *dev[:3], *ref, *idx)
    # P|V|: the plain version on the widened inputs with |V| pools
    mag, _, _ = rpa.ragged_paged_attention_reference(
        dev[0].float(), dev[1].float(), dev[2].float().abs(),
        ref[0].float(), ref[1].float().abs(), *idx)
    torch.cuda.synchronize()
    assert torch.equal(k2, k2r) and torch.equal(v2, v2r)
    for b in valid:
        n = qlens[b]
        err, ok = _fwd_ok(out[b, :n], want[b, :n], mag[b, :n])
        assert ok, (mix_name, b, err)
