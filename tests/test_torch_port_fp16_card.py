"""The port's float16 kernels against their fp16 plain versions, on the
card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_fp16_card.py

Limits (`paddle_tpu_torch.ops.tolerance`, fp16): one fp16 step of the
output, plus 2^-10 of the magnitudes p and ds multiply (the flash
forward and backward: both sides round p and ds to fp16), 2^-11 P|V| for
the ragged kernel on fp16 pools (its plain version rounds the normalised
p, the kernel keeps it fp32), none for decode and int8 pools (neither
side rounds p), plus 2^-16 of the magnitudes for fp32 sums in other
orders and 2^-24 absolute terms for subnormals.  Pool writes, int8 codes
and scales bitwise.  Each fp16 launch counts once more under its fp16
counter (``:tc16``, ``:fp16``, ``:int8:fp16``), and a C entry given a
type code it does not instantiate returns an error, which the wrapper
raises on.

The LayerNorm forward and backward and the FFN's designs in fp16
(`tolerance.ln_limit`, `ln_bwd_limits`, `ffn_limit`: one fp16 step of
the output, the fp32 noise of the bf16 argument, 2^-24 for a subnormal
output; the FFN's h rounded to fp16 by both sides, 2^-10 of |h| |W2|):
every (x, w) type pair of the LayerNorm entries at the shapes of
``chip_smoke.py`` phase 12a and a width off 16-byte chunks, the
backward's wide design, each FFN design, a second launch bitwise the
first, and the five entries' refusal of a type code they do not take.
"""
import ctypes

import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol

F16 = torch.float16


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (fp16 kernel vs plain)")


def _within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _qkv(b, s, h, d, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3, h, d, generator=g).to("cuda", F16).unbind(2)


# (name, causal, mask, kv_lens, segments)
BRANCHES = [("causal", True, False, False, False),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("segs", True, False, False, True),
            ("noncausal", False, False, False, False)]


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
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
@pytest.mark.parametrize("s,d", [(200, 64), (1000, 64), (130, 128)])
def test_fp16_flash_forward_and_backward_match_plain(name, s, d):
    b, h = 2, 3
    q, k, v = _qkv(b, s, h, d, s + d)
    do = torch.randn(b, s, h, d, generator=torch.Generator().manual_seed(
        d)).to("cuda", F16)
    causal, mask, lens, segs = _branch(name, b, s)
    scale = d ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    ops.reset_launch_counts()
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    want = fa.mha_reference(q, k, v, m4, causal, scale, lens, segs)
    torch.cuda.synchronize()
    assert out.dtype == F16
    _within(out, want, tol.flash_fwd_limit(out, want, q, k, v, causal, m4,
                                           lens, segs), f"forward {name}")
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    br = dict(causal=causal, mask=m4, lens=lens, segs=segs)
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, row_max=row_max,
                         **br)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                              row_max=row_max, **br)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=segs, row_max=row_max)
    limits = tol.flash_bwd_limits((dq, dk, dv), ref, q, k, v, out, stat, do,
                                  scale, row_max=row_max, **br)
    torch.cuda.synchronize()
    for which, g, r, lim in zip(("dq", "dk", "dv"), (dq, dk, dv), ref,
                                limits):
        assert g.dtype == F16
        _within(g, r, lim, f"backward {which} {name}")
    counts = ops.launch_counts()
    assert counts[fa.tc16.KERNEL] == 1 and counts[fa.tc.KERNEL] == 0
    assert counts[fa.flash_bwd_dq.tc16.KERNEL] == 1
    assert counts[fa.flash_bwd_dkv.tc16.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("length", [1, 129, 1000, 1024])
@pytest.mark.parametrize("h,d", [(12, 64), (16, 128)])
def test_fp16_decode_matches_plain(length, h, d):
    g = torch.Generator().manual_seed(length + d)
    q = torch.randn(8, 1, 3, h, d, generator=g).to("cuda", F16)[:, :, 0]
    kc, vc = (torch.randn(8, 1024, h * d, generator=g).to("cuda", F16)
              for _ in range(2))
    ops.reset_launch_counts()
    out = fd.flash_decode_arrays(q, kc, vc, length)
    again = fd.flash_decode_arrays(
        q, kc, vc, torch.tensor([length], dtype=torch.int32, device="cuda"))
    want = fd.flash_decode_reference(q, kc, vc, length)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    _within(out, want, tol.decode_limit(out, want, q, kc, vc, length,
                                        d ** -0.5), f"decode {length}")
    assert ops.launch_counts()[fd.fp16.KERNEL] == 2


def _ragged(rows, c, nb, bs, h, d, seed):
    """Kernel inputs of rows (kv_len after the write, queries) on a pool
    of nb blocks; tables from a permutation."""
    g = torch.Generator().manual_seed(seed)
    b, maxb = len(rows), 1024 // bs
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
    q, kn, vn = (torch.randn(b, c, h, d, generator=g).to("cuda", F16)
                 for _ in range(3))
    return q, kn, vn, [t.cuda() for t in (tables, pos0, lens, slots)]


# (kv_len after the write, valid queries); a row's queries past its valid
# ones are padding, whose output is unspecified
ROWS = {1: [(1024, 1), (700, 1), (129, 1), (7, 1)],
        5: [(1024, 5), (513, 3), (64, 5), (7, 2)]}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("c", [1, 5])
def test_fp16_ragged_fp16_pools_match_plain(c):
    nb, bs, h, d = 256, 16, 12, 64
    q, kn, vn, idx = _ragged(ROWS[c], c, nb, bs, h, d, c)
    g = torch.Generator().manual_seed(9)
    kb, vb = (torch.randn(nb, bs, h, d, generator=g).to("cuda", F16)
              for _ in range(2))
    kr, vr = kb.clone(), vb.clone()
    ops.reset_launch_counts()
    out, _, _ = rpa.ragged_paged_attention_arrays(q, kn, vn, kb, vb, *idx)
    want, _, _ = rpa.ragged_paged_attention_reference(q, kn, vn, kr, vr,
                                                      *idx)
    torch.cuda.synchronize()
    assert torch.equal(kb, kr) and torch.equal(vb, vr)
    mag = rpa.ragged_paged_attention_reference(
        q.float(), kn.float(), vn.float().abs(), kr.float(),
        vr.float().abs(), *idx)[0]
    mean = rpa.ragged_paged_attention_reference(
        torch.zeros_like(q, dtype=torch.float32), kn.float(),
        vn.float().abs(), kr.float(), vr.float().abs(), *idx)[0]
    keys = idx[1][:, None] + 1 + torch.arange(c, device="cuda")
    sub = mean * keys[:, :, None, None]
    limit = tol.half_limit(out, want, mag, "fwd", sub)
    for r, (_, n) in enumerate(ROWS[c]):     # past n: padded queries
        _within(out[r, :n], want[r, :n], limit[r, :n],
                f"ragged fp16 pools C={c} row {r}")
    counts = ops.launch_counts()
    assert counts[rpa.fp16.KERNEL] == counts[rpa.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("c", [1, 5])
def test_fp16_ragged_int8_pools_match_plain(c):
    nb, bs, h, d = 256, 16, 12, 64
    q, kn, vn, idx = _ragged(ROWS[c], c, nb, bs, h, d, 10 + c)
    g = torch.Generator().manual_seed(c)
    kc, vc = (torch.randint(-127, 128, (nb, bs, h, d), generator=g,
                            dtype=torch.int8).cuda() for _ in range(2))
    ks, vs = ((torch.rand(nb, h, generator=g) * 0.005).cuda()
              for _ in range(2))
    ref = [t.clone() for t in (kc, vc, ks, vs)]
    ops.reset_launch_counts()
    out, *got = rpa.ragged_paged_attention_arrays(q, kn, vn, kc, vc, *idx,
                                                  ks, vs)
    want, *wref = rpa.ragged_paged_attention_reference(q, kn, vn, *ref[:2],
                                                       *idx, *ref[2:])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, wref))
    mag = rpa.folded_quant_attention(q.float(), ref[0], ref[1].abs(),
                                     ref[2], ref[3], idx[0], idx[1],
                                     d ** -0.5)
    limit = tol.half_limit(out, want, mag, "decode")
    for r, (_, n) in enumerate(ROWS[c]):     # past n: padded queries
        _within(out[r, :n], want[r, :n], limit[r, :n],
                f"ragged int8 pools fp16 q C={c} row {r}")
    counts = ops.launch_counts()
    assert counts[rpa.int8_fp16.KERNEL] == counts[rpa.int8.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_c_entries_refuse_unknown_type_codes():
    """Each C entry of the four families returns cudaErrorInvalidValue (1)
    for a type code it does not instantiate; the wrappers raise on it."""
    q, k, v = _qkv(1, 64, 2, 64, 0)
    out = torch.empty_like(q)
    lse = torch.empty(1, 2, 64, device="cuda")
    fn = fa._bind(_build.load(fa.SOURCE).flash_fwd, 10, 7, 11)
    stream = torch.cuda.current_stream().cuda_stream
    for code in (3, -1):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), 0, 0, 0, 0, 0, 1, 2, 64, 64, 64, code, 1,
                 q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), 0, 0, 0, 0, 0, 0.125, stream)
        assert err == 1
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _build.check(err, fa.KERNEL)
    lib = fd._lib()
    kc = torch.zeros(1, 128, 128, dtype=F16, device="cuda")
    qd = torch.zeros(1, 1, 2, 64, dtype=F16, device="cuda")
    err = lib.flash_decode(qd.data_ptr(), kc.data_ptr(), kc.data_ptr(),
                           qd.clone().data_ptr(), 0,
                           _build.tickets(qd.device, 2).data_ptr(), 0, 1, 2,
                           64, 128, 5, 3, 0, ctypes.c_float(0.125), stream)
    assert err == 1


# ---------------------------------------------------------------------------
# the LayerNorm and FFN kernels in fp16
# ---------------------------------------------------------------------------

TYPES = (torch.float32, torch.bfloat16, F16)
PAIRS = [(x, w) for x in TYPES for w in TYPES]


def _ln_inputs(n, h, xdt, pdt, seed):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, h, generator=g) * 2 + 0.5).to("cuda", xdt)
    w = (1 + 0.1 * torch.randn(h, generator=g)).to("cuda", pdt)
    b = (0.1 * torch.randn(h, generator=g)).to("cuda", pdt)
    return x, w, b


def _ln_fwd_limit(y, yr, x, w, b):
    if y.dtype == torch.float32:
        return 2e-5           # chip_smoke.py's TOL_FP32: fp32 on both sides
    return tol.ln_limit(y, yr, x, w, b)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", PAIRS)
@pytest.mark.parametrize("n,h", [(8192, 768), (8, 768), (37, 1002)])
def test_layernorm_forward_every_type_pair_matches_plain(xdt, pdt, n, h):
    """y in promote(x, w, b) within its limit, mu and rstd to 1e-5
    relative, a second launch bitwise; an fp16 x or w counted under
    ``fused_layernorm:fp16``."""
    x, w, b = _ln_inputs(n, h, xdt, pdt, n + h)
    ops.reset_launch_counts()
    y, mu, rs = fm.fused_layernorm_arrays(x, w, b, return_stats=True)
    again = fm.fused_layernorm_arrays(x, w, b)
    yr, mur, rsr = fm.fused_layernorm_reference(x, w, b)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert y.dtype == yr.dtype == torch.promote_types(xdt, pdt)
    assert torch.equal(y, again)
    _within(y, yr, _ln_fwd_limit(y, yr, x, w, b), f"LN {xdt} {pdt}")
    _within(mu, mur, 1e-5 * mur.abs() + 1e-6, "mu")
    _within(rs, rsr, 1e-5 * rsr.abs(), "rstd")
    half = F16 in (xdt, pdt)
    assert counts[fm.ln_fwd.KERNEL] == 2
    assert counts[fm.ln_fwd16.KERNEL] == (2 if half else 0)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", PAIRS)
@pytest.mark.parametrize("n,h", [(8192, 768), (200, 768), (37, 1002),
                                 (64, 12288)])
def test_layernorm_backward_every_type_pair_matches_plain(xdt, pdt, n, h):
    """dx, dw, db within `tolerance.ln_bwd_limits`, a second launch
    bitwise (no atomics); H=12288 takes the wide design in every type
    (past 8192 2-byte and 6144 fp32 columns)."""
    x, w, b = _ln_inputs(n, h, xdt, pdt, n + h + 1)
    g = torch.Generator().manual_seed(n)
    dy = torch.randn(n, h, generator=g).to("cuda",
                                           torch.promote_types(xdt, pdt))
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    assert fm.ln_bwd_plan(n, h, xdt).wide == (h == 12288)
    ops.reset_launch_counts()
    got = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    again = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    for name, gv, wv, lim in zip(("dx", "dw", "db"), got, want,
                                 tol.ln_bwd_limits(got, want, x, w, mu, rs,
                                                   dy)):
        assert gv.dtype == wv.dtype
        _within(gv, wv, lim, f"LN backward {name} {xdt} {pdt}")
    assert counts[fm.ln_bwd16.KERNEL] == (2 if F16 in (xdt, pdt) else 0)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("n,inter,act", [
    (8, 3072, "gelu_tanh"), (16, 3072, "gelu"), (8, 3072, "relu"),
    (2048, 3072, "gelu_tanh"), (8192, 3072, "gelu_tanh"),
    (512, 3072, "gelu"), (512, 3072, "relu"), (1024, 3008, "gelu_tanh"),
    (8, 3008, "relu")])
def test_fp16_ffn_designs_match_plain(n, inter, act):
    """Each design in fp16 (decode below 24 rows, the tensor cores from
    24, the CUDA cores at widths off 128) within `tolerance.ffn_limit`,
    a second launch bitwise, counted under the design and its fp16
    counter; never the split-TF32 design."""
    g = torch.Generator().manual_seed(n + inter)
    x = torch.randn(n, 768, generator=g).to("cuda", F16)
    w1 = (torch.randn(768, inter, generator=g) * 768 ** -0.5).to("cuda", F16)
    b1 = (torch.randn(inter, generator=g) * 0.1).to("cuda", F16)
    w2 = (torch.randn(inter, 768, generator=g) * inter ** -0.5).to("cuda",
                                                                   F16)
    design = fm.ffn_design(n, 768, inter, F16)
    assert design == ("cuda_core" if inter % 128 else
                      "tc" if n >= fm.FFN_TC_MIN_ROWS else "decode")
    ops.reset_launch_counts()
    y = fm.fused_ffn_arrays(x, w1, b1, w2, act)
    again = fm.fused_ffn_arrays(x, w1, b1, w2, act)
    yr = fm.fused_ffn_reference(x, w1, b1, w2, act)
    torch.cuda.synchronize()
    counter = {"tc": (fm.ffn_tc, fm.ffn_tc16),
               "decode": (fm.ffn_decode, fm.ffn_decode16),
               "cuda_core": (fm.ffn_fwd, fm.ffn_fwd16)}[design]
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        c.KERNEL: 2 for c in counter}
    assert y.dtype == F16 and torch.equal(y, again)
    _within(y, yr, tol.ffn_limit(x, w1, b1, w2, act), f"FFN {design} {n}")


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_ln_and_ffn_entries_refuse_unknown_type_codes():
    """The LayerNorm forward and backward and the three FFN designs that
    take fp16 return cudaErrorInvalidValue (1) for a type code they do not
    instantiate (the tensor-core design: anything but bf16 and fp16)."""
    stream = torch.cuda.current_stream().cuda_stream
    x, w, b = _ln_inputs(8, 768, F16, F16, 0)
    y = torch.empty_like(x)
    mu = torch.empty(8, 1, device="cuda")
    rs = torch.empty(8, 1, device="cuda")
    ln = fm.ln_fwd.fn([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_float, ctypes.c_void_p])
    for codes in ((3, 2), (2, 3), (-1, 0)):
        assert ln(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                  mu.data_ptr(), rs.data_ptr(), 8, 768, *codes, 1e-5,
                  stream) == 1
    plan = fm.ln_bwd_plan(8, 768, F16)
    bwd = fm.ln_bwd.fn([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
    part = torch.empty((plan.grid + plan.groups) * 2 * 768, device="cuda")
    tickets = _build.tickets(x.device, plan.groups + 1)
    for codes in ((3, 2), (2, 3)):
        assert bwd(x.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                   x.data_ptr(), y.data_ptr(), w.clone().data_ptr(),
                   b.clone().data_ptr(), part.data_ptr(), tickets.data_ptr(),
                   8, 768, plan.grid, plan.warps, plan.s, plan.seg, plan.k,
                   int(plan.wide), *codes, stream) == 1
    vp, ci = ctypes.c_void_p, ctypes.c_int
    w1 = torch.zeros(768, 3072, dtype=F16, device="cuda")
    h = torch.empty(8, 3072, dtype=F16, device="cuda")
    tc = fm.ffn_tc.fn([vp] * 6 + [ci] * 10 + [vp])
    for code in (0, 3):
        assert tc(x.data_ptr(), w1.data_ptr(), w1.data_ptr(), w1.data_ptr(),
                  h.data_ptr(), y.data_ptr(), 8, 768, 3072, 768, 1, 1, 128, 1,
                  128, code, stream) == 1
    dec = fm.ffn_decode.fn([vp] * 9 + [ci] * 8 + [vp])
    assert dec(x.data_ptr(), w1.data_ptr(), w1.data_ptr(), w1.data_ptr(), 0,
               y.data_ptr(), 0, 0, tickets.data_ptr(), 8, 768, 3072, 768, 4,
               4, 1, 3, stream) == 1
    core = fm.ffn_fwd.fn([vp] * 7 + [ci] * 7 + [vp])
    assert core(x.data_ptr(), w1.data_ptr(), w1.data_ptr(), w1.data_ptr(),
                y.data_ptr(), 0, tickets.data_ptr(), 8, 768, 3072, 768, 16,
                1, 3, stream) == 1
