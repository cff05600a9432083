"""The port's attention kernels at head_dim 256 against their plain
versions, on the card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_head256_card.py

At D = 256: the flash forward in every branch (causal, an additive mask,
kv_lens, segment ids, non-causal) in bfloat16, float16 (the tensor-core
kernel, its P V an m64n256k16 product) and float32 (the CUDA-core
kernel); the flash dQ and dK/dV kernels in every branch in the same
three types (bf16 / fp16: dQ with 32-key tiles, dK/dV two warpgroups a
block; fp32: the CUDA-core kernels), q, k and v slices of one fused qkv
tensor, and through autograd; the ragged kernel on fp32, bf16 and fp16 pools and on int8
pools with q of each type, flash decode in the three types and the fused
decode layer in fp32 and bf16.  Limits (`paddle_tpu_torch.ops.tolerance`):
float32 ``FP32_FWD`` (2e-5 absolute; the module docstring derives it at
D = 256; the backward ``1e-4 max|ref|``, derived there too), bf16 / fp16
the per-element limits of each kernel kind.  Pool
writes, int8 codes and scales, and the fused layer's untouched ring rows
bitwise.  Each launch at 256 counts once more under its ``:d256``
counter, a float32 flash forward, dQ or dK/dV under the ``:simt`` of its
name (not ``:tc32``); other head sizes stay refused by these sources' C
entries and by the flash wrappers where they are no multiple of 128
(384 goes to the kernels of ``flash_wide_*.cu``), and flash decode takes
them on its plain path.
"""
import ctypes

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol

D = 256
TYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (head_dim 256 kernel vs plain)")


def _within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


# (name, causal, mask, kv_lens, segments)
BRANCHES = [("causal", True, False, False, False),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("segs", True, False, False, True),
            ("noncausal", False, False, False, False),
            ("mask_kv_lens_noncausal", False, True, True, False)]


def _branch(name, b, s):
    _, causal, m, l, sg = next(c for c in BRANCHES if c[0] == name)
    g = torch.Generator().manual_seed(s)
    mask = lens = segs = None
    if m:
        pads = torch.arange(b) * 37
        row = torch.where(torch.arange(s)[None] < pads[:, None], -1e30, 0.0)
        mask = row[:, None, None, :].expand(b, 1, s, s).cuda()
    if l:
        lens = torch.tensor([s - 29 * i for i in range(b)],
                            dtype=torch.int32).cuda()
    if sg:
        cuts = torch.randint(0, 6, (b, s), generator=g)
        segs = torch.cumsum((cuts == 0).int(), 1).int().cuda()
    return causal, mask, lens, segs


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
@pytest.mark.parametrize("s", [130, 1000])
def test_flash_forward_d256_matches_plain(dtype, name, s):
    b, h = 2, 3
    g = torch.Generator().manual_seed(s)
    q, k, v = torch.randn(b, s, 3, h, D, generator=g).to(
        "cuda", dtype).unbind(2)
    causal, mask, lens, segs = _branch(name, b, s)
    scale = D ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    ops.reset_launch_counts()
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    want, want_lse = fa.mha_reference(q, k, v, m4, causal, scale, lens,
                                      segs, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    limit = tol.FP32_FWD if dtype == torch.float32 else \
        tol.flash_fwd_limit(out, want, q, k, v, causal, m4, lens, segs)
    _within(out, want, limit, f"forward {name} S={s} {dtype}")
    if pair is None:
        _within(lse, want_lse, 1e-5, f"lse {name}")
    else:
        rm, ls = fa.softmax_stats(q, k, scale, causal, m4, lens, segs)
        _within(pair[0], rm, 1e-5, f"row max {name}")
        _within(pair[1], ls, 1e-5, f"log l {name}")
    counts = ops.launch_counts()
    assert counts[fa.d256.KERNEL] == 1
    f32 = dtype == torch.float32
    assert counts[fa.simt.KERNEL] == int(f32)
    assert counts[fa.tc32.KERNEL] == 0
    assert counts[fa.tc.KERNEL] == int(dtype == torch.bfloat16)
    assert counts[fa.tc16.KERNEL] == int(dtype == torch.float16)


BWD_REL_FP32 = 1e-4     # fp32 backward: of max|ref| (tolerance docstring)


def _bwd_limits(got, want, q, k, v, out, stat, do, scale, **br):
    if q.dtype == torch.float32:
        return [BWD_REL_FP32 * w.abs().max().item() for w in want]
    return tol.flash_bwd_limits(got, want, q, k, v, out, stat, do, scale,
                                **br)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
@pytest.mark.parametrize("s", [130, 1000])
def test_flash_backward_d256_matches_plain(dtype, name, s):
    """dQ and dK/dV at D = 256 from the kernel forward's statistics, q, k
    and v slices of one fused [B, S, 3, H, D] tensor and a strided dO,
    against the plain backward; one launch of each, counted under its
    branch, ``:d256`` and its type (``:simt`` in fp32)."""
    b, h = 2, 3
    g = torch.Generator().manual_seed(s + 1)
    q, k, v = torch.randn(b, s, 3, h, D, generator=g).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(b, s, 2, h, D, generator=g).to("cuda", dtype)[:, :, 1]
    causal, mask, lens, segs = _branch(name, b, s)
    scale = D ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    br = dict(causal=causal, mask=m4, lens=lens, segs=segs)
    ops.reset_launch_counts()
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, row_max=row_max,
                         **br)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                              row_max=row_max, **br)
    counts = ops.launch_counts()
    want = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=segs, row_max=row_max)
    limits = _bwd_limits((dq, dk, dv), want, q, k, v, out, stat, do, scale,
                         row_max=row_max, **br)
    torch.cuda.synchronize()
    for which, got, w, lim in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                  limits):
        assert got.shape == w.shape and got.dtype == dtype
        assert w.abs().max().item() > 0, f"{which}: a reference of zeros"
        _within(got, w, lim, f"backward {which} {name} S={s} {dtype}")
    variant = fa.variant_name(causal, m4, lens, segs)
    f32 = dtype == torch.float32
    for kern in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert counts[kern.KERNEL if variant is None
                      else kern.variants[variant].KERNEL] == 1
        assert counts[kern.d256.KERNEL] == 1
        assert counts[kern.simt.KERNEL] == int(f32)
        assert counts[kern.tc32.KERNEL] == 0
        assert counts[kern.tc.KERNEL] == int(dtype == torch.bfloat16)
        assert counts[kern.tc16.KERNEL] == int(dtype == torch.float16)
    assert counts[fa.d256.KERNEL] == 0


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", ["causal", "kv_lens", "segs"])
def test_flash_autograd_d256_launches_both_backward_kernels(dtype, name):
    """`flash_attention_arrays` at D = 256 under autograd: the forward and
    both backward kernels launch once each, and the gradients agree with
    the plain backward fed the kernel forward's out and statistics."""
    b, h, s = 2, 2, 200
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, s, h, D, generator=g).to("cuda", dtype)
               .requires_grad_() for _ in range(3))
    do = torch.randn(b, s, h, D, generator=g).to("cuda", dtype)
    causal, _, lens, segs = _branch(name, b, s)
    ops.reset_launch_counts()
    out = fa.flash_attention_arrays(q, k, v, is_causal=causal, kv_lens=lens,
                                    segment_ids=segs)
    out.backward(do)
    counts = ops.launch_counts()
    for kern in (fa, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert counts[kern.d256.KERNEL] == 1
    scale = D ** -0.5
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o2, lse, pair = fa._launch(qd, kd, vd, scale, causal, None, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    want = fa.flash_attention_bwd_reference(
        qd, kd, vd, o2, stat, do, scale, is_causal=causal, kv_lens=lens,
        segment_ids=segs, row_max=row_max)
    limits = _bwd_limits((q.grad, k.grad, v.grad), want, qd, kd, vd, o2,
                         stat, do, scale, causal=causal, lens=lens,
                         segs=segs, row_max=row_max)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o2)
    for which, t, w, lim in zip(("dq", "dk", "dv"), (q, k, v), want,
                                limits):
        _within(t.grad, w, lim, f"autograd {which} {name} {dtype}")


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("d", [32, 96, 192, 384])
def test_other_head_dims_stay_refused(d):
    """The C entries of these sources return cudaErrorInvalidValue (1) for
    every head size but 64, 128, 256 (the flash forward and backward,
    decode and the fused layer); the flash wrappers raise ValueError for
    a head size that is no multiple of 128 and send 384 to the kernels of
    ``flash_wide_*.cu``; flash decode's check raises, and its wrapper
    takes the plain version there by shape, with no launch."""
    q, k, v = (torch.zeros(1, 16, 2, d, device="cuda") for _ in range(3))
    stats = torch.zeros(1, 2, 16, device="cuda")
    ops.reset_launch_counts()
    if d % 128:
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_arrays(q, k, v, is_causal=True)
        for kern in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            with pytest.raises(ValueError, match="head_dim"):
                kern(q, k, v, q, stats, stats, 0.125)
    else:
        fa.flash_attention_arrays(q, k, v, is_causal=True)
        for kern in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            kern(q, k, v, q, stats, stats, 0.125)
        torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    assert counts == ({} if d % 128 else {
        fa.KERNEL: 1, fa.wide.KERNEL: 1, fa.flash_bwd_dq.KERNEL: 1,
        fa.flash_bwd_dq.wide.KERNEL: 1, fa.flash_bwd_dkv.KERNEL: 1,
        fa.flash_bwd_dkv.wide.KERNEL: 1}), counts
    kc = torch.zeros(1, 32, 2 * d, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fd._check(q[:, :1], kc, kc, 4)
    ops.reset_launch_counts()
    got = fd.flash_decode_arrays(q[:, :1], kc, kc, 4)
    assert got.shape == (1, 1, 2, d)
    assert set(ops.launch_counts().values()) == {0}
    out, lse = torch.empty_like(q), torch.empty(1, 2, 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = fa._bind(_build.load(fa.SOURCE).flash_fwd, 10, 7, 11)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), 0, 0, 0, 0, 0, 1, 2, 16, 16, d, 0, 1,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), 0, 0, 0, 0, 0, 0.125, stream)
    assert err == 1
    for entry, n_out in (("flash_bwd_dq", 1), ("flash_bwd_dkv", 2)):
        fn = fa._bind(getattr(_build.load(fa.BWD_SOURCE), entry),
                      10 + n_out, 7, 13)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
                 lse.data_ptr(), lse.data_ptr(), 0, 0, 0, 0,
                 *[out.data_ptr()] * n_out, 1, 2, 16, 16, d, 0, 1,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), q.stride(0), q.stride(1),
                 0, 0, 0, 0, 0, 0.125, stream)
        assert err == 1, entry
    err = fd._lib().flash_decode(
        q.data_ptr(), kc.data_ptr(), kc.data_ptr(), out.data_ptr(), 0,
        _build.tickets(q.device, 2).data_ptr(), 0, 1, 2, d, 32, 4, 0, 0,
        ctypes.c_float(0.125), stream)
    assert err == 1
    assert fdl._lib().fused_decode_layer_blocks(8, 2, d, 1) == -1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("length", [1, 129, 1000, 1024])
def test_decode_d256_matches_plain(dtype, length):
    h = 4
    g = torch.Generator().manual_seed(length)
    q = torch.randn(4, 1, 3, h, D, generator=g).to("cuda", dtype)[:, :, 0]
    kc, vc = (torch.randn(4, 1024, h * D, generator=g).to("cuda", dtype)
              for _ in range(2))
    ops.reset_launch_counts()
    out = fd.flash_decode_arrays(q, kc, vc, length)
    again = fd.flash_decode_arrays(
        q, kc, vc, torch.tensor([length], dtype=torch.int32, device="cuda"))
    want = fd.flash_decode_reference(q, kc, vc, length)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    limit = tol.FP32_FWD if dtype == torch.float32 else tol.decode_limit(
        out, want, q, kc, vc, length, D ** -0.5)
    _within(out, want, limit, f"decode {length} {dtype}")
    counts = ops.launch_counts()
    assert counts[fd.d256.KERNEL] == counts[fd.KERNEL] == 2


def _ragged(rows, c, nb, bs, h, dtype, seed):
    """Kernel inputs of rows (kv_len after the write, queries) on a pool
    of nb blocks; tables from a permutation, 2048 keys wide."""
    g = torch.Generator().manual_seed(seed)
    b, maxb = len(rows), 2048 // bs
    tables = torch.full((b, maxb), nb, dtype=torch.int32)
    pos0 = torch.zeros(b, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    slots = torch.full((b, c), nb * bs, dtype=torch.int32)
    free = torch.randperm(nb, generator=g).tolist()
    for r, (kv, nq) in enumerate(rows):
        nblk = -(-kv // bs)
        tables[r, :nblk] = torch.tensor([free.pop() for _ in range(nblk)])
        pos0[r], lens[r] = kv - nq, kv
        for j in range(nq):
            p = kv - nq + j
            slots[r, j] = tables[r, p // bs] * bs + p % bs
    q, kn, vn = (torch.randn(b, c, h, D, generator=g).to("cuda", dtype)
                 for _ in range(3))
    return q, kn, vn, [t.cuda() for t in (tables, pos0, lens, slots)]


# (kv_len after the write, valid queries); a row's queries past its valid
# ones are padding, whose output is unspecified
ROWS = {1: [(1500, 1), (1024, 1), (129, 1), (7, 1)],
        5: [(1024, 5), (513, 3), (64, 5), (7, 2)]}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("c", [1, 5])
def test_ragged_d256_fp_pools_match_plain(dtype, c):
    nb, bs, h = 512, 16, 2
    q, kn, vn, idx = _ragged(ROWS[c], c, nb, bs, h, dtype, c)
    g = torch.Generator().manual_seed(9)
    kb, vb = (torch.randn(nb, bs, h, D, generator=g).to("cuda", dtype)
              for _ in range(2))
    kr, vr = kb.clone(), vb.clone()
    ops.reset_launch_counts()
    out, _, _ = rpa.ragged_paged_attention_arrays(q, kn, vn, kb, vb, *idx)
    want, _, _ = rpa.ragged_paged_attention_reference(q, kn, vn, kr, vr,
                                                      *idx)
    torch.cuda.synchronize()
    assert torch.equal(kb, kr) and torch.equal(vb, vr)
    if dtype == torch.float32:
        limit = torch.full_like(out, tol.FP32_FWD, dtype=torch.float32)
    else:
        mag = rpa.ragged_paged_attention_reference(
            q.float(), kn.float(), vn.float().abs(), kr.float(),
            vr.float().abs(), *idx)[0]
        sub = None
        if dtype == torch.float16:
            mean = rpa.ragged_paged_attention_reference(
                torch.zeros_like(q, dtype=torch.float32), kn.float(),
                vn.float().abs(), kr.float(), vr.float().abs(), *idx)[0]
            keys = idx[1][:, None] + 1 + torch.arange(c, device="cuda")
            sub = mean * keys[:, :, None, None]
        limit = tol.half_limit(out, want, mag, "fwd", sub)
    for r, (_, n) in enumerate(ROWS[c]):     # past n: padded queries
        _within(out[r, :n], want[r, :n], limit[r, :n],
                f"ragged {dtype} pools C={c} row {r}")
    counts = ops.launch_counts()
    assert counts[rpa.d256.KERNEL] == counts[rpa.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("c", [1, 5])
def test_ragged_d256_int8_pools_match_plain(dtype, c):
    """Codes and scales bitwise (the int8 write's row pass at D = 256: 16
    lanes a row, two rows a pass), the scales grown, out within the
    limit (neither side rounds p)."""
    nb, bs, h = 512, 16, 2
    q, kn, vn, idx = _ragged(ROWS[c], c, nb, bs, h, dtype, 10 + c)
    g = torch.Generator().manual_seed(c)
    kc, vc = (torch.randint(-127, 128, (nb, bs, h, D), generator=g,
                            dtype=torch.int8).cuda() for _ in range(2))
    ks, vs = ((torch.rand(nb, h, generator=g) * 0.005).cuda()
              for _ in range(2))
    ref = [t.clone() for t in (kc, vc, ks, vs)]
    before = ks.clone()
    ops.reset_launch_counts()
    out, *got = rpa.ragged_paged_attention_arrays(q, kn, vn, kc, vc, *idx,
                                                  ks, vs)
    want, *wref = rpa.ragged_paged_attention_reference(q, kn, vn, *ref[:2],
                                                       *idx, *ref[2:])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, wref))
    assert not torch.equal(ks, before)          # the new rows grew scales
    if dtype == torch.float32:
        limit = torch.full_like(out, tol.FP32_FWD, dtype=torch.float32)
    else:
        mag = rpa.folded_quant_attention(q.float(), ref[0], ref[1].abs(),
                                         ref[2], ref[3], idx[0], idx[1],
                                         D ** -0.5)
        limit = tol.half_limit(out, want, mag, "decode")
    for r, (_, n) in enumerate(ROWS[c]):     # past n: padded queries
        _within(out[r, :n], want[r, :n], limit[r, :n],
                f"ragged int8 pools {dtype} q C={c} row {r}")
    counts = ops.launch_counts()
    assert counts[rpa.int8_d256.KERNEL] == counts[rpa.int8.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,masked", [(1, False), (129, True),
                                      (1000, False), (1023, True)])
def test_fused_layer_d256_matches_plain(dtype, t, masked):
    """y and the written K / V rows within their limits, every other ring
    row bitwise unchanged; hidden 512, two heads of 256."""
    b, h, s_max = 8, 2, 1024
    hd = h * D
    g = torch.Generator().manual_seed(t)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

    args = (rnd(b, hd), 1 + rnd(hd, scale=0.1), rnd(hd, scale=0.1),
            rnd(hd, 3 * hd, scale=hd ** -0.5), rnd(3 * hd, scale=0.1),
            rnd(hd, hd, scale=hd ** -0.5), rnd(hd, scale=0.1))
    kc, vc = rnd(b, s_max, hd), rnd(b, s_max, hd)
    mask = None
    if masked:
        mask = torch.where(torch.rand(b, s_max, generator=g) < 0.3, -1e30,
                           0.0).cuda()
    kr, vr = kc.clone(), vc.clone()
    ops.reset_launch_counts()
    y, _, _ = fdl.fused_decode_layer_arrays(
        *args, kc, vc, torch.tensor([t], dtype=torch.int32, device="cuda"),
        h, cache_mask=mask)
    plain = fdl.fused_decode_plain(*args, kr, vr, t, h, cache_mask=mask)
    yr, _, _ = fdl.fused_decode_layer_reference(*args, kr, vr, t, h,
                                                cache_mask=mask)
    torch.cuda.synchronize()
    for c, r in ((kc, kr), (vc, vr)):
        assert torch.equal(c[:, :t], r[:, :t])
        assert torch.equal(c[:, t + 1:], r[:, t + 1:])
    if dtype == torch.float32:
        limits = dict(y=tol.FP32_FWD, k=tol.FP32_FWD, v=tol.FP32_FWD)
    else:
        limits = tol.fused_decode_limits(plain, args, kr, vr, t, h,
                                         D ** -0.5)
    for name, got, ref in (("y", y, yr), ("k", kc[:, t], kr[:, t]),
                           ("v", vc[:, t], vr[:, t])):
        _within(got, ref, limits[name], f"fused layer t={t} {name}")
    counts = ops.launch_counts()
    assert counts[fdl.d256.KERNEL] == counts[fdl.KERNEL] == 1
