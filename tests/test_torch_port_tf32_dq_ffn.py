"""The split-TF32 arithmetic of the float32 flash dQ and the float32 FFN
kernels, emulated in torch on the CPU.

``csrc/flash_bwd_causal.cu`` ``flash_bwd_dq_tc32_kernel`` and
``csrc/fused_ffn_tc32.cu`` ``ffn_tc32_kernel`` compute every fp32 product
as three TF32 ``wgmma`` products of the operands' hi and lo parts, as the
float32 forward and dK/dV do (tests/test_torch_port_tf32.py, whose bit-mask
roundings and truncating sums `mm_tf32_rz` this file reuses): each
``wgmma`` k-step (8 products and the accumulator) is an exact sum rounded
toward zero, as the tensor core sums.

dQ: per key tile of 64 keys (D=64) or 32 (D=128), S = Q K^T and dP = dO
V^T summed afresh, p = exp(s scale - lse) (or the masked form exp((s
scale + mask - m) - log l) from the masked forward's pair), ds = p (dP -
delta), and dQ += dS K summed into one accumulator over every key tile:
one level, as the kernel does.  Against float64 attention from the same
fp32 inputs, within 1e-4 max|ref| (the card's float32 backward limit) at
B=1 S=1024 H=2, D 64 and 128, randn scales 1 and 4, causal; with the
additive randn*2 mask at S=896 (the case where the forward's one-level P V
missed its limit); and with packed segment ids.  A second level (each key
tile's dS K summed afresh, added to dQ in fp32) is emulated beside it at
scale 4, where the error is largest: it buys little, which is why the
kernel keeps one level and D/2 registers.

FFN: x W1 and h W2 per 32-deep k-tile summed afresh and added to the
output accumulator in fp32 (two levels), b1 and the activation in fp32,
at GPT-2's MLP (1024 x 768 x 3072): within 1e-5 max|ref| of the fp32
plain `fused_ffn_reference` (the card's float32 FFN limit) and within
`tolerance.ffn_limit`, for each activation.  Summed in one level, the
second product's 3 x 384 truncating k-steps over I = 3072 miss 1e-5
max|ref| by more than twice: the reason the kernel sums in two levels.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import tolerance as tol
from test_torch_port_tf32 import _causal, _err, _heads, _inputs, \
    mm_tf32_rz, split, trunc_tf32
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


S, H = 1024, 2
BWD_REL = 1e-4
FFN_REL = 1e-5


def dq_tile(d):
    """Keys per tile of the dQ kernel (`DqCfg`)."""
    return 64 if d == 64 else 32


def emulate_dq(q, k, v, do, stat, delta, scale, allowed, mask=None,
               row_max=None, two_level=False):
    """dq [B, S, H, D] of the kernel's arithmetic: S and dP per key tile
    in `mm_tf32_rz`, p from the fp32 statistic (``stat`` = lse, or with
    ``row_max`` log l), excluded pairs (``allowed`` [B or 1, 1, Sq, Sk]
    false) p = 0, dQ += dS K into one truncating accumulator, or summed
    per tile and added in fp32 (``two_level``)."""
    qh, kh, vh, dh = _heads(q, k, v, do)
    sk, bk = k.shape[1], dq_tile(q.shape[-1])
    acc = torch.zeros(qh.shape)
    for k0 in range(0, sk, bk):
        kt, vt = kh[..., k0:k0 + bk, :], vh[..., k0:k0 + bk, :]
        x = mm_tf32_rz(qh, kt.transpose(-1, -2)) * scale
        if mask is not None:
            x = x + mask[..., k0:k0 + bk]
        if row_max is None:
            p = torch.exp(x - stat[..., None])
        else:
            p = torch.exp((x - row_max[..., None]) - stat[..., None])
        p = torch.where(allowed[..., k0:k0 + bk], p, torch.zeros(()))
        ds = p * (mm_tf32_rz(dh, vt.transpose(-1, -2)) - delta[..., None])
        if two_level:
            acc = acc + mm_tf32_rz(ds, kt)
        else:
            acc = mm_tf32_rz(ds, kt, acc)
    return (acc * scale).permute(0, 2, 1, 3)


def dq64(q, k, v, do, scale, allowed, mask=None):
    """dQ of attention in float64 from the same fp32 inputs: logits,
    softmax over the allowed keys and products in float64."""
    qh, kh, vh = _heads(*(x.double() for x in (q, k, v)))
    s = qh @ kh.transpose(-1, -2) * scale
    if mask is not None:
        s = s + mask.double()
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
    dh = do.double().permute(0, 2, 1, 3)
    out = p @ vh
    ds = p * (dh @ vh.transpose(-1, -2) - (dh * out).sum(-1, keepdim=True))
    return (ds @ kh * scale).permute(0, 2, 1, 3)


def _dq_case(q, k, v, do, allowed, mask=None, segs=None, two_level=False):
    """(emulated dQ's error over its limit, the same with a second
    level or None): the statistics from the fp32 plain forward, as the
    kernel reads them from the fp32 forward."""
    d = q.shape[-1]
    sm = d ** -0.5
    out, lse = fa.mha_reference(q, k, v, mask, True, sm, None, segs,
                                return_lse=True)
    delta = fa.attention_delta(out, do)
    row_max, stat = None, lse
    if mask is not None:
        row_max, stat = fa.softmax_stats(q, k, sm, True, mask, None, segs)
    want = dq64(q, k, v, do, sm, allowed, mask)
    limit = BWD_REL * want.abs().max().item()
    ratios = [_err(emulate_dq(q, k, v, do, stat, delta, sm, allowed, mask,
                              row_max, two), want) / limit
              for two in ((False, True) if two_level else (False,))]
    return ratios + [None] * (2 - len(ratios))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_split_tf32_dq_one_level_within_bwd_limit(d, scale):
    q, k, v, do = _inputs(d, scale, seed=10 * d + int(scale), n=4)
    one, two = _dq_case(q, k, v, do, _causal(S, S), two_level=scale == 4.0)
    assert one <= 1.0, one
    if two is not None:
        # a second level would buy less than a tenth of the limit here
        assert two <= one and one - two < 0.1, (one, two)


def test_split_tf32_dq_with_additive_mask_within_bwd_limit():
    s_len = 896
    g = torch.Generator().manual_seed(7)
    q, k, v, do = torch.randn(1, s_len, 4, H, 64, generator=g).unbind(2)
    mask = torch.randn(1, H, s_len, s_len, generator=g) * 2
    one, _ = _dq_case(q, k, v, do, _causal(s_len, s_len), mask)
    assert one <= 1.0, one


def test_split_tf32_dq_with_segment_ids_within_bwd_limit():
    q, k, v, do = _inputs(64, 1.0, seed=3, n=4)
    cuts = (0, 300, 310, 700, S)
    ids = torch.cat([torch.full((cuts[i + 1] - cuts[i],), i)
                     for i in range(len(cuts) - 1)])[None]
    allowed = _causal(S, S) & (ids[:, None, :, None] == ids[:, None, None])
    one, _ = _dq_case(q, k, v, do, allowed, segs=ids.int())
    assert one <= 1.0, one


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

FFN_N, FFN_H, FFN_I = 1024, 768, 3072
FFN_TILE = 32        # k-tile depth of csrc/fused_ffn_tc32.cu


def mm_levels(a, b, acc=None):
    """a @ b as the FFN kernel sums it: each `FFN_TILE`-deep k-tile in
    `mm_tf32_rz` afresh, added to the output in fp32."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], FFN_TILE):
        out = out + mm_tf32_rz(a[:, k0:k0 + FFN_TILE], b[k0:k0 + FFN_TILE])
    return out


@pytest.fixture(scope="module")
def ffn_case():
    """(x, w1, b1, w2, the emulated first product x W1): GPT-2's MLP
    widths, weights scaled as in the card's checks."""
    rng = np.random.RandomState(3)
    arrays = (rng.randn(FFN_N, FFN_H), rng.randn(FFN_H, FFN_I) / np.sqrt(
        FFN_H), 0.1 * rng.randn(FFN_I), rng.randn(FFN_I, FFN_H) / np.sqrt(
        FFN_I))
    x, w1, b1, w2 = (torch.from_numpy(a.astype(np.float32)) for a in arrays)
    return x, w1, b1, w2, mm_levels(x, w1)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
def test_split_tf32_ffn_two_levels_within_fp32_limit(act, ffn_case):
    x, w1, b1, w2, xw1 = ffn_case
    h = fm._act(xw1 + b1, act)
    y = mm_levels(h, w2)
    want = fm.fused_ffn_reference(x, w1, b1, w2, act)
    assert _err(y, want) <= FFN_REL * want.abs().max().item()
    _, _, ok = tol.compare(y, want, tol.ffn_limit(x, w1, b1, w2, act))
    assert ok


def test_split_tf32_ffn_one_level_misses_fp32_limit(ffn_case):
    """The second product summed in one truncating accumulator over
    I = 3072 (the first in two levels)."""
    x, w1, b1, w2, xw1 = ffn_case
    h = fm._act(xw1 + b1, "gelu_tanh")
    want = fm.fused_ffn_reference(x, w1, b1, w2, "gelu_tanh")
    ratio = _err(mm_tf32_rz(h, w2), want) / (FFN_REL
                                             * want.abs().max().item())
    assert ratio > 2.0, ratio


def test_split_tf32_ffn_operands_as_the_kernel_reads_them():
    """The kernel's A operands are split in registers and its B operands
    (W^T hi and lo) written by the pre-pass; the tensor core reads lo
    truncated: hi + lo gives each operand back exactly, and hi has no
    bits the hardware would drop."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(64, 96, generator=g)
    hi, lo = split(w.t().contiguous())
    assert torch.equal(hi + lo, w.t())
    assert torch.equal(trunc_tf32(hi), hi)
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()
