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
- LayerNorm backward: each of dx, dw, db within 1e-5 of its sum over
  term magnitudes, plus one bf16 step for a bf16 output
  (`tolerance.ln_bwd_limits`); a second launch bitwise equal.
- decode, fused decode layer, LayerNorm, FFN, float32: max absolute error
  2e-5 (FFN: 1e-5 max|ref|, sums over the intermediate); LayerNorm
  statistics 1e-5 relative.  bfloat16: one bf16 step of each output plus
  the rounding of what each side rounds (`tolerance` docstring): p for
  decode (2^-7 P|V|); xn, p and the attention output through the weights
  for the fused layer, and xn's effect on the written rows; for LayerNorm
  the fp32 noise of its terms where they cancel; h for the FFN (2^-7 |h| |W2|).  The fused layer leaves
  every ring row but row t bitwise unchanged.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import fused_mlp as fm
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


def _randn(shape, seed, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_max,h,d,length",
                         [(2, 256, 3, 64, 200), (3, 384, 2, 128, 300)])
def test_flash_decode_kernel_matches_plain(b, s_max, h, d, length, dtype):
    # q: the [B, 1, H, D] slice of a fused [B, 1, 3, H, D] projection
    q = _randn((b, 1, 3, h, d), length, dtype)[:, :, 0]
    kc = _randn((b, s_max, h * d), length + 1, dtype)
    vc = _randn((b, s_max, h * d), length + 2, dtype)
    fd.launches = 0
    out = fd.flash_decode_arrays(q, kc, vc, length)
    want = fd.flash_decode_reference(q, kc, vc, length)
    torch.cuda.synchronize()
    assert fd.launches == 1 and out.dtype == dtype
    limit = TOL_FP32 if dtype == torch.float32 else tol.decode_limit(
        out, want, q, kc, vc, length, d ** -0.5)
    err, ratio, ok = tol.compare(out, want, limit)
    assert ok, (err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,d,s_max,t,masked",
                         [(2, 2, 64, 256, 37, True),
                          (3, 2, 128, 384, 300, False)])
def test_fused_decode_layer_kernel_matches_plain(b, h, d, s_max, t, masked,
                                                 dtype):
    hd = h * d
    x = _randn((b, hd), t, dtype)
    ln_w = 1 + _randn((hd,), t + 1, dtype, 0.1)
    ln_b = _randn((hd,), t + 2, dtype, 0.1)
    wqkv = _randn((hd, 3 * hd), t + 3, dtype, hd ** -0.5)
    bqkv = _randn((3 * hd,), t + 4, dtype, 0.1)
    wo = _randn((hd, hd), t + 5, dtype, hd ** -0.5)
    bo = _randn((hd,), t + 6, dtype, 0.1)
    kc = _randn((b, s_max, hd), t + 7, dtype)
    vc = _randn((b, s_max, hd), t + 8, dtype)
    mask = None
    if masked:
        g = torch.Generator().manual_seed(t)
        mask = torch.where(torch.rand(b, s_max, generator=g) < 0.3, -1e30,
                           0.0).cuda()
    kr, vr = kc.clone(), vc.clone()
    args = (x, ln_w, ln_b, wqkv, bqkv, wo, bo)
    fdl.launches = 0
    y, _, _ = fdl.fused_decode_layer_arrays(*args, kc, vc, t, h,
                                            cache_mask=mask)
    plain = fdl.fused_decode_plain(*args, kr, vr, t, h, cache_mask=mask)
    yr, _, _ = fdl.fused_decode_layer_reference(*args, kr, vr, t, h,
                                                cache_mask=mask)
    torch.cuda.synchronize()
    assert fdl.launches == 1 and y.dtype == dtype
    for c, r in ((kc, kr), (vc, vr)):
        assert torch.equal(c[:, :t], r[:, :t])
        assert torch.equal(c[:, t + 1:], r[:, t + 1:])
    if dtype == torch.float32:
        limits = dict(y=TOL_FP32, k=TOL_FP32, v=TOL_FP32)
    else:
        limits = tol.fused_decode_limits(plain, args, kr, vr, t, h,
                                         d ** -0.5)
    for name, got, ref in (("y", y, yr), ("k", kc[:, t], kr[:, t]),
                           ("v", vc[:, t], vr[:, t])):
        err, ratio, ok = tol.compare(got, ref, limits[name])
        assert ok, (name, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,hidden", [(8, 768), (100, 1000)])
def test_layernorm_kernel_matches_plain(n, hidden, xdt, pdt):
    x = _randn((n, hidden), n, xdt, 2.0) + 0.5
    w = 1 + _randn((hidden,), n + 1, pdt, 0.1)
    b = _randn((hidden,), n + 2, pdt, 0.1)
    fm.ln_fwd.launches = 0
    y, mu, rs = fm.fused_layernorm_arrays(x, w, b, return_stats=True)
    yr, mur, rsr = fm.fused_layernorm_reference(x, w, b)
    torch.cuda.synchronize()
    assert fm.ln_fwd.launches == 1 and y.dtype == yr.dtype
    torch.testing.assert_close(mu, mur, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rs, rsr, rtol=1e-5, atol=0)
    limit = TOL_FP32 if y.dtype == torch.float32 else tol.bf16_limit(
        y, yr, tol.ln_magnitude(x, w, b), tol.LN_COEF)
    err, ratio, ok = tol.compare(y, yr, limit)
    assert ok, (err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,hidden,inter,act", [(8, 768, 3072, "gelu_tanh"),
                                                (40, 128, 256, "gelu"),
                                                (512, 256, 512, "relu")])
def test_ffn_kernel_matches_plain(n, hidden, inter, act, dtype):
    x = _randn((n, hidden), n, dtype)
    w1 = _randn((hidden, inter), n + 1, dtype, hidden ** -0.5)
    b1 = _randn((inter,), n + 2, dtype, 0.1)
    w2 = _randn((inter, hidden), n + 3, dtype, inter ** -0.5)
    fm.ffn_fwd.launches = 0
    y = fm.fused_ffn_arrays(x, w1, b1, w2, act)
    y2 = fm.fused_ffn_arrays(x, w1, b1, w2, act)   # tickets were reset
    yr = fm.fused_ffn_reference(x, w1, b1, w2, act)
    torch.cuda.synchronize()
    assert fm.ffn_fwd.launches == 2 and torch.equal(y, y2)
    limit = (1e-5 * yr.float().abs().max().item() if dtype == torch.float32
             else tol.ffn_limit(x, w1, b1, w2, act))
    err, ratio, ok = tol.compare(y, yr, limit)
    assert ok, (err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,hidden", [(8, 768), (200, 768), (8192, 768),
                                      (100, 1000), (300, 4096), (64, 1002)])
def test_layernorm_bwd_kernel_matches_plain(n, hidden, xdt, pdt):
    x = _randn((n, hidden), n, xdt, 2.0) + 0.5
    w = 1 + _randn((hidden,), n + 1, pdt, 0.1)
    b = _randn((hidden,), n + 2, pdt, 0.1)
    # a strided dy: the [n, H] view of an [n, 2, H] tensor
    dy = _randn((n, 2, hidden), n + 3, torch.promote_types(xdt, pdt))[:, 1]
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    fm.ln_bwd.launches = 0
    got = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    again = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    assert fm.ln_bwd.launches == 2
    assert [g.dtype for g in got] == [xdt, pdt, pdt]
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # no atomics
    limits = tol.ln_bwd_limits(got, want, x, w, mu, rs, dy)
    for name, g, r, lim in zip(("dx", "dw", "db"), got, want, limits):
        err, ratio, ok = tol.compare(g, r, lim)
        assert ok, (name, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_layernorm_and_ffn_autograd_match_cpu():
    """fp32 gradients of LN -> FFN through the two autograd Functions on
    the card (forward kernels, the LN backward kernel, the FFN's
    recompute in cuBLAS) against the same on the CPU (plain versions),
    each within 1e-4 max|ref|: the card's forward outputs differ from the
    plain ones by up to 2e-5 (LN) and 1e-5 max|ref| (FFN), and every
    gradient is a sum of products of them, in fp32 on both sides."""
    n, hidden, inter = 256, 768, 3072
    ins = [_randn((n, hidden), 1, torch.float32),
           1 + _randn((hidden,), 2, torch.float32, 0.1),
           _randn((hidden,), 3, torch.float32, 0.1),
           _randn((hidden, inter), 4, torch.float32, hidden ** -0.5),
           _randn((inter,), 5, torch.float32, 0.1),
           _randn((inter, hidden), 6, torch.float32, inter ** -0.5)]
    dy = _randn((n, hidden), 7, torch.float32)
    grads = {}
    for dev in ("cuda", "cpu"):
        x, lw, lb, w1, b1, w2 = (t.detach().to(dev).requires_grad_()
                                 for t in ins)
        fm.ln_fwd.launches = fm.ln_bwd.launches = fm.ffn_fwd.launches = 0
        h = fm.fused_layernorm_arrays(x, lw, lb)
        fm.fused_ffn_arrays(h, w1, b1, w2, "gelu_tanh").backward(dy.to(dev))
        launched = (fm.ln_fwd.launches, fm.ln_bwd.launches,
                    fm.ffn_fwd.launches)
        assert launched == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        grads[dev] = [t.grad.cpu() for t in (x, lw, lb, w1, b1, w2)]
    for name, g, r in zip(("dx", "dlw", "dlb", "dw1", "db1", "dw2"),
                          grads["cuda"], grads["cpu"]):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item(), \
            name
