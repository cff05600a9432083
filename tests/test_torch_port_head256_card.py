"""The port's forward attention kernels at head_dim 256 against their plain
versions, on the card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_head256_card.py

At D = 256: the flash forward in every branch (causal, an additive mask,
kv_lens, segment ids, non-causal) in bfloat16, float16 (the tensor-core
kernel, its P V an m64n256k16 product) and float32 (the CUDA-core
kernel), the ragged kernel on fp32, bf16 and fp16 pools and on int8
pools with q of each type, flash decode in the three types and the fused
decode layer in fp32 and bf16.  Limits (`paddle_tpu_torch.ops.tolerance`):
float32 ``FP32_FWD`` (2e-5 absolute; the module docstring derives it at
D = 256), bf16 / fp16 the per-element limits of each kernel kind.  Pool
writes, int8 codes and scales, and the fused layer's untouched ring rows
bitwise.  Each launch at 256 counts once more under its ``:d256``
counter, a float32 flash forward under ``flash_fwd_causal:simt`` (not
``:tc32``); the backward at 256 raises before any launch, and other head
sizes stay refused by the wrappers and the C entries.
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


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
def test_flash_backward_d256_refused_before_any_launch(dtype):
    """Through autograd: the forward launches, the backward raises its own
    ValueError (not a CUDA error) before the dQ kernel launches."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 2, D, generator=g).to("cuda", dtype)
               .requires_grad_() for _ in range(3))
    ops.reset_launch_counts()
    out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    with pytest.raises(ValueError, match="head_dim 256"):
        out.float().sum().backward()
    counts = ops.launch_counts()
    assert counts[fa.d256.KERNEL] == 1
    assert not any(n for name, n in counts.items()
                   if name.startswith(("flash_bwd_dq", "flash_bwd_dkv")))


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("d", [32, 96, 192, 384])
def test_other_head_dims_stay_refused(d):
    """The wrappers raise ValueError, the C entries return
    cudaErrorInvalidValue (1), for every head size but 64, 128, 256."""
    q, k, v = (torch.zeros(1, 16, 2, d, device="cuda") for _ in range(3))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_arrays(q, k, v, is_causal=True)
    kc = torch.zeros(1, 32, 2 * d, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fd.flash_decode_arrays(q[:, :1], kc, kc, 4)
    out, lse = torch.empty_like(q), torch.empty(1, 2, 16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = fa._bind(_build.load(fa.SOURCE).flash_fwd, 10, 7, 11)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), 0, 0, 0, 0, 0, 1, 2, 16, 16, d, 0, 1,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), 0, 0, 0, 0, 0, 0.125, stream)
    assert err == 1
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
