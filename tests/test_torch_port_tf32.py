"""The split-TF32 arithmetic of the float32 flash forward and dK/dV kernels,
emulated in torch on the CPU, against float64.

The float32 tensor-core kernels (``csrc/flash_fwd_causal.cu``
``flash_fwd_tc32_kernel``, ``csrc/flash_bwd_causal.cu``
``flash_bwd_dkv_tc32_kernel``) compute every product A B of fp32 operands
as three TF32 ``wgmma`` products with fp32 accumulation:

    A B ~ A_hi B_hi + A_hi B_lo + A_lo B_hi,  x_hi = rna_tf32(x),
                                              x_lo = x - x_hi  (exact)

``rna_tf32`` (``cvt.rna.tf32.f32``) rounds to 10 mantissa bits, ties away
from zero; the tensor core reads each operand's upper 19 bits and drops
the low 13 (truncation), which leaves x_hi as it is and truncates x_lo.
Both roundings are emulated here with bit masks on int32 views, and the
products as fp32 matmuls of the rounded operands (each product of two
TF32 values is exact in fp32; the sums round in fp32, as the card's do).
The forward runs the kernel's online softmax over its key tiles (64 keys
at D=64, 32 at D=128) with p split the same way; the dK/dV rebuilds p and
ds = p (dP - delta) from the forward's fp32 lse and delta, as the kernel
does.  Inputs: randn at B=1 S=1024 H=2, D 64 and 128, scales 1 and 4,
causal.

Limits, each against float64 attention computed from the same fp32
inputs (logits, softmax and products in float64):

- forward, scale 1: 2e-5 absolute, the card's float32 limit (it holds the
  kernel against the fp32 plain version within 2e-5 at this scale); the
  emulation is also within 2e-5 of that fp32 plain version,
  ``mha_reference``.
- forward, scale 4: logits 16 times larger make the fp32 rounding of the
  logits themselves (~2^-24 of sum |q||k| per logit, times |v|) exceed
  2e-5: the fp32 plain version is several times 2e-5 away from float64
  here (the test asserts that it misses 2e-5).  The split is held to
  that: its error is at most 1.25 times the fp32 plain version's own --
  float32 accuracy, which is what the split buys.
- dK/dV, both scales: 1e-4 max|ref| per gradient, the card's float32
  backward limit.
- one TF32 pass (each operand truncated, as the hardware reads raw fp32)
  misses both forward criteria by orders of magnitude, at either scale:
  the reason the kernels split.

The tensor core also rounds its fp32 sums toward zero: each ``wgmma``
k-step (8 products and the accumulator) is emulated as an exact sum
rounded toward zero (`mm_tf32_rz`).  Summing P V for every key tile of a
row into O that way (one level) biases O at S=896 with an additive
randn*2 mask (the card's float32 "full" mask case) enough to miss 2e-5
against the plain version, as it did on the card.  The
forward kernel sums P V per key tile afresh and adds it to O in fp32 (two
levels), within 2e-5.  The dK/dV kernel sums dV and dK over every query
tile in one level; that stays within 1e-4 max|ref| at S=1024.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


S, H = 1024, 2
FWD_ABS = 2e-5
BWD_REL = 1e-4
FP32_FACTOR = 1.25


def rna_tf32(x):
    """x rounded to TF32 (10 mantissa bits), ties away from zero: the
    kernels' ``cvt.rna.tf32.f32``."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc_tf32(x):
    """The TF32 value the tensor core reads from an fp32 register or
    shared-memory word: the low 13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, x - hi


def mm_tf32(a, b, passes=3):
    """a @ b as the kernels compute it: three TF32 passes (the small
    terms first), or one pass of the raw operands."""
    if passes == 1:
        return trunc_tf32(a) @ trunc_tf32(b)
    ah, al = split(a)
    bh, bl = split(b)
    al, bl = trunc_tf32(al), trunc_tf32(bl)
    return al @ bh + ah @ bl + ah @ bh


def _rz32(x64):
    """float64 to fp32, rounded toward zero: the low 29 of float64's 52
    mantissa bits dropped, which leaves a value fp32 holds exactly (in
    fp32's normal range; the sums here stay in it)."""
    return (x64.view(torch.int64) & ~0x1FFFFFFF).view(torch.float64).float()


def mm_tf32_rz(a, b, acc=None):
    """acc + a @ b as the tensor core sums it: the three passes of
    `mm_tf32`, 8-deep k-steps, each step's products and acc summed
    exactly and rounded toward zero to fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    al, bl = trunc_tf32(al), trunc_tf32(bl)
    if acc is None:
        acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k in range(0, a.shape[-1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _rz32(acc.double() + x[..., k:k + 8].double()
                        @ y[..., k:k + 8, :].double())
    return acc


def _inputs(d, scale, seed, n=3):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(1, S, H, d).astype(np.float32)
                             * np.float32(scale)) for _ in range(n)]


def _heads(*xs):
    return [x.permute(0, 2, 1, 3) for x in xs]


def _causal(sq, sk, k0=0):
    return torch.arange(sq)[:, None] >= k0 + torch.arange(sk)[None]


def emulate_forward(q, k, v, scale, passes=3):
    """(out [B, S, H, D], lse [B, H, S]) of the kernel's arithmetic:
    key tiles of 64 (D=64) or 32 (D=128) keys, online softmax in fp32,
    excluded keys -inf, S = Q K^T and O += P V in `mm_tf32`."""
    d = q.shape[-1]
    bk = 64 if d == 64 else 32
    qh, kh, vh = _heads(q, k, v)
    m = torch.full(qh.shape[:-1], -1e30)
    l = torch.zeros(qh.shape[:-1])
    o = torch.zeros(qh.shape)
    for k0 in range(0, S, bk):
        s = mm_tf32(qh, kh[..., k0:k0 + bk, :].transpose(-1, -2), passes)
        s = torch.where(_causal(S, bk, k0), s * scale,
                        torch.tensor(float("-inf")))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm_tf32(p, vh[..., k0:k0 + bk, :], passes)
        m = mx
    return (o / l[..., None]).permute(0, 2, 1, 3), m + torch.log(l)


def emulate_dkv(q, k, v, do, lse, delta, scale):
    """(dk, dv) of the dK/dV kernel's arithmetic: S^T = K Q^T and dP^T =
    V dO^T, p = exp(s scale - lse), ds = p (dP - delta), dV = P^T dO and
    dK = scale dS^T Q, every product in `mm_tf32`."""
    qh, kh, vh, dh = _heads(q, k, v, do)
    st = mm_tf32(kh, qh.transpose(-1, -2)) * scale
    p = torch.where(_causal(S, S).T, torch.exp(st - lse[..., None, :]),
                    torch.zeros(()))
    dpt = mm_tf32(vh, dh.transpose(-1, -2))
    ds = p * (dpt - delta[..., None, :])
    dv = mm_tf32(p, dh)
    dk = mm_tf32(ds, qh) * scale
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def reference64(q, k, v, scale, do=None):
    """Causal attention in float64: out, or with ``do`` also (dk, dv)."""
    qh, kh, vh = _heads(*(x.double() for x in (q, k, v)))
    s = (qh @ kh.transpose(-1, -2) * scale).masked_fill(
        ~_causal(S, S), float("-inf"))
    p = torch.softmax(s, -1)
    out = p @ vh
    if do is None:
        return out.permute(0, 2, 1, 3)
    dh = do.double().permute(0, 2, 1, 3)
    dp = dh @ vh.transpose(-1, -2)
    ds = p * (dp - (dh * out).sum(-1, keepdim=True))
    dv = p.transpose(-1, -2) @ dh
    dk = ds.transpose(-1, -2) @ qh * scale
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def _err(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("x,hi,trunc", [
    (1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0),        # a tie: away from zero
    (-(1.0 + 2 ** -11), -(1.0 + 2 ** -10), -1.0),
    (1.0 + 2 ** -11 - 2 ** -23, 1.0, 1.0),        # below the tie
    (3.0, 3.0, 3.0)])
def test_tf32_roundings(x, hi, trunc):
    t = torch.tensor([x], dtype=torch.float32)
    assert rna_tf32(t).item() == hi and trunc_tf32(t).item() == trunc
    h, lo = split(t)
    assert h.double().item() + lo.double().item() == t.double().item()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_split_tf32_forward_is_float32_accurate(d, scale):
    q, k, v = _inputs(d, scale, seed=d + int(scale))
    sm = d ** -0.5
    out, lse = emulate_forward(q, k, v, sm)
    want = reference64(q, k, v, sm)
    plain, plain_lse = fa.mha_reference(q, k, v, is_causal=True, scale=sm,
                                        return_lse=True)
    err, plain_err = _err(out, want), _err(plain, want)
    if scale == 1.0:
        assert err <= FWD_ABS, err
        assert _err(out, plain) <= FWD_ABS
    else:
        assert plain_err > FWD_ABS          # fp32 itself misses 2e-5 here
        assert err <= FP32_FACTOR * plain_err, (err, plain_err)
    assert _err(lse, plain_lse) <= 1e-4 * scale ** 2


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_split_tf32_dkv_within_bwd_limit(d, scale):
    q, k, v, do = _inputs(d, scale, seed=10 * d + int(scale), n=4)
    sm = d ** -0.5
    out, lse = fa.mha_reference(q, k, v, is_causal=True, scale=sm,
                                return_lse=True)
    delta = fa.attention_delta(out, do)
    got = emulate_dkv(q, k, v, do, lse, delta, sm)
    want = reference64(q, k, v, sm, do)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert _err(g, w) <= BWD_REL * w.abs().max().item(), name


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_one_tf32_pass_misses_the_forward_limit(d, scale):
    q, k, v = _inputs(d, scale, seed=d + int(scale))
    sm = d ** -0.5
    out, _ = emulate_forward(q, k, v, sm, passes=1)
    want = reference64(q, k, v, sm)
    plain_err = _err(fa.mha_reference(q, k, v, is_causal=True, scale=sm),
                     want)
    err = _err(out, want)
    assert err > 10 * FWD_ABS and err > 10 * plain_err, (err, plain_err)


def _masked_forward_rz(q, k, v, mask, scale, two_level, bk=64):
    """The forward kernel at D=64 with truncating sums: causal, an
    additive mask, key tiles of 64; P V summed per tile and added to O in
    fp32 (``two_level``), or summed into O directly."""
    qh, kh, vh = _heads(q, k, v)
    s_len = q.shape[1]
    m = torch.full(qh.shape[:-1], float("-inf"))
    l = torch.zeros(qh.shape[:-1])
    o = torch.zeros(qh.shape)
    for k0 in range(0, s_len, bk):
        kt = kh[..., k0:k0 + bk, :]
        s = mm_tf32_rz(qh, kt.transpose(-1, -2)) * scale
        s = s + mask[..., k0:k0 + bk]
        s = torch.where(_causal(s_len, kt.shape[-2], k0), s,
                        torch.tensor(float("-inf")))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None]
        vt = vh[..., k0:k0 + bk, :]
        o = o + mm_tf32_rz(p, vt) if two_level else mm_tf32_rz(p, vt, o)
        m = mx
    return (o / l[..., None]).permute(0, 2, 1, 3)


def test_truncating_sums_need_two_levels_in_the_forward():
    s_len = 896
    g = torch.Generator().manual_seed(7)
    q, k, v = torch.randn(1, s_len, 3, H, 64, generator=g).unbind(2)
    mask = torch.randn(1, H, s_len, s_len, generator=g) * 2
    want = fa.mha_reference(q, k, v, mask, True)
    one = _err(_masked_forward_rz(q, k, v, mask, 0.125, False), want)
    two = _err(_masked_forward_rz(q, k, v, mask, 0.125, True), want)
    assert one > FWD_ABS and two <= FWD_ABS / 2, (one, two)


def test_truncating_sums_keep_dkv_within_bwd_limit():
    q, k, v, do = _inputs(64, 1.0, seed=5, n=4)
    sm = 0.125
    out, lse = fa.mha_reference(q, k, v, is_causal=True, scale=sm,
                                return_lse=True)
    delta = fa.attention_delta(out, do)
    qh, kh, vh, dh = _heads(q, k, v, do)
    st = mm_tf32_rz(kh, qh.transpose(-1, -2)) * sm
    p = torch.where(_causal(S, S).T, torch.exp(st - lse[..., None, :]),
                    torch.zeros(()))
    ds = p * (mm_tf32_rz(vh, dh.transpose(-1, -2)) - delta[..., None, :])
    dv = mm_tf32_rz(p, dh)                      # one level over all queries
    dk = mm_tf32_rz(ds, qh) * sm
    want = reference64(q, k, v, sm, do)
    for name, g, w in zip(("dk", "dv"), (dk, dv), want):
        g = g.permute(0, 2, 1, 3)
        assert _err(g, w) <= BWD_REL * w.abs().max().item(), name
