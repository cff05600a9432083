"""The split-K decode kernels' algorithms, emulated in torch on the CPU, and
their launch planners.

`csrc/ragged_paged_attention.cu` (the ragged attend) and
`csrc/fused_decode_layer.cu` (phase 2 of the fused layer) cut each
(row, query, head)'s keys into splits.  In the ragged kernel a block of
four warps takes a split of whole 128-key chunks; in the fused layer one
warp takes a split of whole runs of 32 keys, as many splits as fill the
card's warps once.  Each warp walks runs of keys with an online softmax
whose running max m moves once per U loads of KPW keys, the warps merge
in warp order and the splits in split order.  `splitk_attend` repeats
that order of operations in fp32 torch: the ragged kernel keeps p in fp32 (int8 pools: k_scale
times the scaled logit, v_scale times p), the fused layer rounds each p
to the cache type at its warp's running max.  Each emulation is held
against the port's plain version and against the JAX package, on the
same numpy inputs made from a seed:

- ragged, fp and int8 pools, fp32 and bf16 q: the plain version at the
  kernel's limits (`ops.tolerance`: 2e-5 in fp32; in bf16 one bf16 step
  plus 2^-8 P|V|, since only the plain version rounds p); the JAX
  fallback `ragged_paged_attention_arrays` (jitted, as the JAX engine
  runs it) at the same limits, its pools and scales bitwise the plain
  version's.  Rows at the split edges (1, 127, 128, 129 keys and the
  table's full width), a padding row, a row whose bound is 0, a row
  longer than max_splits chunks, and C > 1 chunks.
- the fused layer's attention, fp32 and bf16, masked or not, t = 1, 127,
  128, 129 and 300: the plain layer at `fused_decode_limits` (bf16) and
  2e-5 (fp32); the JAX `_fused_decode_layer_kernel` in interpret mode at
  the limits of tests/test_torch_port_decode.py (1e-5 fp32; bf16 with
  its q.k rounding term).
- the planners (`ragged_splits`, `fused_loads`, `fused_plan`) against
  explicit tables at GPT-2 width on an H100's 132 SMs, and their layout
  rules at other shapes.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.ops import ragged_paged_attention as jrp

from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol

TOL_FP32 = 2e-5          # the kernels' fp32 limit against the plain version
TOL_JAX_FP32 = 1e-5      # the CPU parity limit against the JAX package
QK_ROUNDING = 2.0 ** -8  # the TPU kernels round each q_d k_d to bf16
NEG = -1e30
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_jit_ragged = jax.jit(jrp.ragged_paged_attention_arrays)

# the kernels' loop shapes: warps a block, keys a warp run, loads of K in
# flight a lane (each load 32 / (D / values a 16-byte load) keys a warp:
# 4 in the ragged kernel, a whole run of at most 8 in the fused layer)
RAGGED_LOOP = dict(warps=4, run=32)
FUSED_LOOP = dict(warps=1, run=32)


def _keys_a_load(d, itemsize):
    return 32 // (d // (16 // itemsize))


def splitk_attend(q, k, v, bound, chunk, warps, run, loads, per_load, scale,
                  add=None, ks=None, vs=None, round_to=None):
    """The kernels' split-K softmax of q [H, D] over keys [0, bound) of
    k, v [n, H, D] (fp32): ``add`` [n] is added to the scaled logits (the
    fused layer's mask), ``ks`` / ``vs`` [n, H] scale the logits and the
    probabilities (int8 pools), ``round_to`` rounds each probability
    before the value product (the fused layer).  Returns the merged
    (m [H], l [H], acc [H, D]) of the splits, in split order."""
    h, d = q.shape
    per = per_load * loads
    parts = []
    for lo in range(0, bound, chunk):
        hi = min(lo + chunk, bound)
        states = []
        for w in range(warps):
            m = torch.full((h,), NEG)
            l = torch.zeros(h)
            acc = torch.zeros(h, d)
            for r0 in range(lo + w * run, hi, warps * run):
                r1 = min(r0 + run, hi)
                for k0 in range(r0, r1, per):
                    idx = torch.arange(k0, min(k0 + per, r1))
                    s = torch.einsum("hd,khd->hk", q, k[idx]) * scale
                    if ks is not None:
                        s = s * ks[idx].T
                    if add is not None:
                        s = s + add[idx][None]
                    mnew = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp(m - mnew)
                    p = torch.exp(s - mnew[:, None])
                    l = l * alpha + p.sum(-1)
                    wgt = p if round_to is None else p.to(round_to).float()
                    if vs is not None:
                        wgt = wgt * vs[idx].T
                    acc = (acc * alpha[:, None]
                           + torch.einsum("hk,khd->hd", wgt, v[idx]))
                    m = mnew
            states.append((m, l, acc))
        parts.append(_merge(states))
    return _merge(parts)


def _merge(states):
    """(m, l, acc) of several online-softmax states, in order."""
    gm = torch.stack([s[0] for s in states]).amax(0)
    gl = torch.zeros_like(gm)
    ga = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - gm)
        gl = gl + l * f
        ga = ga + acc * f[:, None]
    return gm, gl, ga


# ---------------------------------------------------------------------------
# ragged paged attention
# ---------------------------------------------------------------------------

def ragged_emulation(q, kpool, vpool, tables, pos0, lens, ks=None, vs=None,
                     sms=132):
    """The ragged attend kernel in torch: out [B, C, H, D] in q's dtype
    from the pools after the write (codes and scales for int8 pools).
    The grid's splits come from `rpa.ragged_splits` and each row's chunk
    from its bound, as the kernel derives them."""
    b, c, h, d = q.shape
    nb, bs = kpool.shape[0], kpool.shape[1]
    maxb = tables.shape[1]
    max_splits = rpa.ragged_splits(b, c, h, maxb * bs, sms)
    per_load = _keys_a_load(d, kpool.element_size())
    out = torch.zeros(b, c, h, d)
    for r in range(b):
        kv_len = min(max(int(lens[r]), 0), maxb * bs)
        keys = torch.arange(kv_len)
        blk = tables[r, keys // bs].long().clamp(0, nb - 1)
        k = kpool[blk, keys % bs].float()
        v = vpool[blk, keys % bs].float()
        kscale = None if ks is None else ks[blk]
        vscale = None if vs is None else vs[blk]
        for j in range(c):
            bound = max(0, min(int(pos0[r]) + j + 1, kv_len))
            if bound == 0:
                continue
            per = -(-bound // max_splits)
            chunk = max(rpa.CHUNK, -(-per // rpa.CHUNK) * rpa.CHUNK)
            _, l, acc = splitk_attend(
                q[r, j].float(), k, v, bound, chunk, per_load=per_load,
                loads=4,
                scale=d ** -0.5, ks=kscale, vs=vscale, **RAGGED_LOOP)
            out[r, j] = acc / l.clamp(min=1e-30)[:, None]
    return out.to(q.dtype)


def _ragged_inputs(rows, c, nb, bs, maxb, h, d, seed, quant):
    """rows: (kv_len after the write, valid queries), None (a padding row)
    or "zero" (a row whose kv_lens is 0 beside a table and pos0 of 5: its
    bound is 0 at every query, its output unspecified)."""
    rng = np.random.RandomState(seed)
    b = len(rows)
    tables = np.full((b, maxb), nb, np.int32)
    pos0 = np.zeros(b, np.int32)
    lens = np.zeros(b, np.int32)
    slots = np.full((b, c), nb * bs, np.int32)
    free = list(rng.permutation(nb))
    qlens = []
    for r, row in enumerate(rows):
        if row is None or row == "zero":
            if row == "zero":
                tables[r, 0], pos0[r] = free.pop(), 5
            qlens.append(0)
            continue
        kv, nq = row
        nblk = -(-kv // bs)
        tables[r, :nblk] = [free.pop() for _ in range(nblk)]
        pos0[r], lens[r] = kv - nq, kv
        for j in range(nq):
            p = pos0[r] + j
            slots[r, j] = tables[r, p // bs] * bs + p % bs
        qlens.append(nq)
    q, kn, vn = (rng.randn(b, c, h, d).astype(np.float32) for _ in range(3))
    if quant:
        pools = [rng.randint(-127, 128, (nb, bs, h, d)).astype(np.int8)
                 for _ in range(2)]
        pools += [(rng.rand(nb, h) * 0.02).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.randn(nb, bs, h, d).astype(np.float32)
                 for _ in range(2)]
    return (q, kn, vn), pools, (tables, pos0, lens, slots), qlens


# (rows, C, table blocks, SMs): the split edges at one 128-key chunk and
# the table's full width (512 keys); a padding row and a row of bound 0;
# rows longer than max_splits chunks (few SMs); C > 1 chunks beside a
# decode row
RAGGED_CASES = {
    "edges": ([(1, 1), (127, 1), (128, 1), (129, 1), (512, 1), None,
               "zero"], 1, 32, 132),
    "wide_chunks": ([(500, 1), (129, 1)], 1, 32, 1),
    "chunk": ([(150, 24), (21, 1), None], 24, 16, 132),
    "chunk_one_split": ([(300, 40)], 40, 24, 132),
}


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a), dtype)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_ragged_emulation_matches_plain_and_jax(case, dtype, quant,
                                                monkeypatch):
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    rows, c, maxb, sms = RAGGED_CASES[case]
    jdt, tdt = DTYPES[dtype]
    h, d, bs = 2, 64, 16
    (q, kn, vn), pools, idx, qlens = _ragged_inputs(rows, c, 96, bs, maxb,
                                                    h, d, 7, quant)
    tq = [_t(a, tdt) for a in (q, kn, vn)]
    tpools = [_t(a) if quant else _t(a, tdt) for a in pools]
    tidx = [_t(a) for a in idx]
    if quant:
        want, kc, vc, ks, vs = rpa.ragged_paged_attention_reference(
            *tq, tpools[0], tpools[1], *tidx, tpools[2], tpools[3])
        jout = _jit_ragged(*(_jnp(a, jdt) for a in (q, kn, vn)),
                           *(jnp.asarray(a) for a in pools[:2]),
                           *(jnp.asarray(a) for a in idx),
                           k_scales=jnp.asarray(pools[2]),
                           v_scales=jnp.asarray(pools[3]))
        for got, jw in zip((kc, vc, ks, vs), jout[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(jw))
        mag = rpa.folded_quant_attention(tq[0].float(), kc, vc.abs(), ks, vs,
                                         tidx[0], tidx[1], d ** -0.5)
    else:
        want, kc, vc = rpa.ragged_paged_attention_reference(
            *tq, tpools[0], tpools[1], *tidx)
        jout = _jit_ragged(*(_jnp(a, jdt) for a in (q, kn, vn)),
                           *(_jnp(a, jdt) for a in pools),
                           *(jnp.asarray(a) for a in idx))
        for got, jw in zip((kc, vc), jout[1:]):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(jw, np.float32))
        ks = vs = None
        mag = rpa.ragged_paged_attention_reference(
            tq[0].float(), tq[1].float(), tq[2].float().abs(), kc.float(),
            vc.float().abs(), *tidx)[0]
    got = ragged_emulation(tq[0], kc, vc, *tidx[:3], ks, vs, sms=sms)
    jw = _t(np.asarray(jout[0], np.float32)).to(tdt)
    for r, n in enumerate(qlens):
        if rows[r] == "zero":
            assert torch.equal(got[r], torch.zeros_like(got[r]))
        if not n:
            continue
        for ref, what in ((want, "plain"), (jw, "jax")):
            o, w = got[r, :n], ref[r, :n]
            limit = (TOL_FP32 if dtype == "float32"
                     else tol.bf16_limit(o, w, mag[r, :n], tol.FWD_COEF))
            err, ratio, ok = tol.compare(o, w, limit)
            assert ok, (case, what, r, err, ratio)


def test_ragged_emulation_takes_several_splits():
    """The edge rows span one to four splits of the grid's eight, the
    few-SM case wider chunks, the chunk cases one split."""
    assert rpa.ragged_splits(7, 1, 2, 32 * 16, 132) == 4
    assert rpa.ragged_splits(2, 1, 2, 32 * 16, 1) == 2
    assert rpa.ragged_splits(3, 24, 2, 16 * 16, 132) == 2
    assert rpa.ragged_splits(1, 40, 2, 24 * 16, 132) == 3


# ---------------------------------------------------------------------------
# fused decode layer
# ---------------------------------------------------------------------------

B, H, D, S_MAX = 2, 2, 64, 384
HD = H * D


def _layer_inputs(seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, HD).astype(np.float32)
    ln_w = (1 + 0.1 * rng.randn(HD)).astype(np.float32)
    ln_b = (0.1 * rng.randn(HD)).astype(np.float32)
    wqkv = (rng.randn(HD, 3 * HD) * HD ** -0.5).astype(np.float32)
    bqkv = (0.1 * rng.randn(3 * HD)).astype(np.float32)
    wo = (rng.randn(HD, HD) * HD ** -0.5).astype(np.float32)
    bo = (0.1 * rng.randn(HD)).astype(np.float32)
    kc, vc = (rng.randn(B, S_MAX, HD).astype(np.float32) for _ in range(2))
    mask = np.where(rng.rand(B, S_MAX) < 0.3, NEG, 0.0).astype(np.float32)
    return (x, ln_w, ln_b, wqkv, bqkv, wo, bo, kc, vc), mask


def fused_emulation(args, t, mask):
    """y [B, hd] of the fused layer as the kernel computes it: q, k, v
    from the plain layer's fp32 qkv (the kernel's sums differ in order
    only), the prefix by `splitk_attend` (the splits of `fdl.fused_split`,
    one warp each, p rounded to the cache type at the warp's running max,
    which moves once a run of 32 keys in bf16), the current
    token's term from the fp32 k and v, the output rounded to the
    weights' type, then out-proj and the fp32 residual."""
    x, ln_w, ln_b, wqkv, bqkv, wo, bo, kc, vc = args
    b, hd = x.shape
    d = hd // H
    scale = d ** -0.5
    cdt = kc.dtype
    plain = fdl.fused_decode_plain(*args, t, H, cache_mask=mask)
    # the splits of an H100 (264 co-resident blocks)
    chunk = fdl.fused_split(t, b * H, 8 * 264)[0]
    per_load = _keys_a_load(d, kc.element_size())
    q = plain["q"].reshape(b, H, d)
    kn, vn = (plain[n].reshape(b, H, d) for n in ("k_new", "v_new"))
    a = torch.zeros(b, H, d)
    for r in range(b):
        gm, gl, ga = splitk_attend(
            q[r], kc[r, :t].float().reshape(t, H, d),
            vc[r, :t].float().reshape(t, H, d), t, chunk,
            per_load=per_load, loads=min(8, FUSED_LOOP["run"] // per_load),
            scale=scale, add=None if mask is None else mask[r],
            round_to=cdt, **FUSED_LOOP)
        s_self = (q[r] * kn[r]).sum(-1) * scale
        m2 = torch.maximum(gm, s_self)
        alpha = torch.exp(gm - m2)
        p_self = torch.exp(s_self - m2)
        ls = (alpha * gl + p_self).clamp(min=1e-30)
        p_r = p_self.to(cdt).float()
        a[r] = (ga * alpha[:, None] + p_r[:, None] * vn[r]) / ls[:, None]
    a = a.reshape(b, hd).to(wqkv.dtype).float()
    y32 = x.float() + (a @ wo.float() + bo.float())
    return y32.to(x.dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 127, 128, 129, 300])
def test_fused_emulation_matches_plain(t, dtype, masked):
    _, tdt = DTYPES[dtype]
    arrays, mask = _layer_inputs(t)
    args = [_t(a, tdt) for a in arrays]
    m = _t(mask) if masked else None
    got = fused_emulation(args, t, m)
    plain = fdl.fused_decode_plain(*args, t, H, cache_mask=m)
    if dtype == "float32":
        limit = TOL_FP32
    else:
        limit = tol.fused_decode_limits(plain, args[:7], args[7], args[8],
                                        t, H, D ** -0.5)["y"]
    err, ratio, ok = tol.compare(got, plain["y"], limit)
    assert ok, (err, ratio)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,masked", [(129, True), (300, False)])
def test_fused_emulation_matches_jax_kernel(t, masked, dtype, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    jdt, tdt = DTYPES[dtype]
    arrays, mask = _layer_inputs(t + 1)
    m = mask if masked else None
    wy, _, _ = jpo.fused_decode_layer_arrays(
        *(_jnp(a, jdt) for a in arrays), t, H,
        cache_mask=None if m is None else jnp.asarray(m))
    args = [_t(a, tdt) for a in arrays]
    mt = None if m is None else _t(m)
    got = fused_emulation(args, t, mt)
    wy = _t(np.asarray(wy, np.float32)).to(tdt)
    if dtype == "float32":
        limit = TOL_JAX_FP32
    else:
        plain = fdl.fused_decode_plain(*args, t, H, cache_mask=mt)
        limit = tol.fused_decode_limits(plain, args[:7], args[7], args[8],
                                        t, H, D ** -0.5,
                                        qk_rounding=QK_ROUNDING)["y"]
    err, ratio, ok = tol.compare(got, wy, limit)
    assert ok, (err, ratio)


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------

# (B, C, H, table width, SMs) -> blocks per (row, query, head): the engine's
# decode step (8 splits of the 1024-key table), one row, gpt3_1p3b's heads,
# the chunked-prefill continuations of chip_smoke.py (C = 188, 512), a
# narrow card, a table narrower than one chunk
RAGGED_SPLITS = [((8, 1, 12, 1024, 132), 8), ((1, 1, 12, 1024, 132), 8),
                 ((8, 1, 16, 1024, 132), 8), ((1, 188, 12, 1024, 132), 1),
                 ((1, 512, 12, 1024, 132), 1), ((8, 1, 12, 1024, 16), 2),
                 ((8, 1, 12, 100, 132), 1), ((2, 16, 12, 1024, 132), 3)]


@pytest.mark.parametrize("shape,splits", RAGGED_SPLITS)
def test_ragged_splits_table(shape, splits):
    assert rpa.ragged_splits(*shape) == splits


@pytest.mark.parametrize("b,c,h,d", [(8, 1, 12, 64), (8, 1, 16, 128),
                                     (1, 512, 12, 64)])
def test_ragged_scratch_holds_every_split(b, c, h, d):
    """(m, l) and acc[D] in fp32 per split of each (row, query, head);
    nothing with one split (the chunked-prefill calls)."""
    splits = rpa.ragged_splits(b, c, h, 1024, 132)
    nbytes = rpa._scratch_bytes(b, c, h, d, splits)
    assert nbytes == (0 if splits == 1 else b * c * h * splits * (d + 2) * 4)
    assert nbytes <= 1 << 20


# (k, cols, dtype, blocks) -> loads a thread: GPT-2's qkv and out-proj on
# 264 co-resident blocks (two an SM of 132), gpt3_1p3b's, few blocks
FUSED_LOADS = [((768, 2304, torch.bfloat16, 264), 4),
               ((768, 768, torch.bfloat16, 264), 2),
               ((768, 2304, torch.float32, 264), 8),
               ((768, 768, torch.float32, 264), 4),
               ((2048, 6144, torch.bfloat16, 264), 4),
               ((2048, 2048, torch.bfloat16, 264), 4),
               ((128, 384, torch.bfloat16, 4), 4),
               ((192, 192, torch.float32, 1000), 1)]


@pytest.mark.parametrize("args,loads", FUSED_LOADS)
def test_fused_loads_table(args, loads):
    assert fdl.fused_loads(*args) == loads


def test_fused_loads_refuses_widths_off_the_units():
    with pytest.raises(ValueError, match="multiples"):
        fdl.fused_loads(100, 300, torch.bfloat16, 264)


# (B, H, D, S_max, dtype, blocks) -> (l1, l3, cap of splits a (row, head),
# the most splits any t < S_max takes, grid, tickets)
FUSED_PLANS = [
    ((8, 12, 64, 128, torch.bfloat16, 264), (4, 2, 22, 4, 216, 108)),
    ((8, 12, 64, 256, torch.bfloat16, 264), (4, 2, 22, 8, 216, 108)),
    ((8, 12, 64, 1024, torch.bfloat16, 264), (4, 2, 22, 22, 264, 108)),
    ((8, 12, 64, 1024, torch.float32, 264), (8, 4, 22, 22, 264, 120)),
    ((8, 16, 128, 1024, torch.bfloat16, 264), (4, 4, 16, 16, 264, 160)),
    ((8, 12, 64, 1024, torch.bfloat16, 132), (4, 4, 11, 11, 132, 108))]


@pytest.mark.parametrize("args,want", FUSED_PLANS)
def test_fused_plan_table(args, want):
    plan = fdl.fused_plan(*args)
    assert (plan.l1, plan.l3, plan.cap, plan.splits, plan.grid,
            plan.tickets) == want


# (t, (row, head) pairs, warps) -> (keys a split, splits): every split of
# whole runs of 32 keys, and no more splits than one round of the warps
FUSED_SPLITS = [((1, 96, 2112), (32, 1)), ((32, 96, 2112), (32, 1)),
                ((33, 96, 2112), (32, 2)), ((1023, 96, 2112), (64, 16)),
                ((2047, 96, 2112), (96, 22)), ((1023, 8, 2112), (32, 32)),
                ((700, 2000, 2112), (704, 1))]


@pytest.mark.parametrize("args,want", FUSED_SPLITS)
def test_fused_split_table(args, want):
    t, bh, warps = args
    chunk, splits = fdl.fused_split(t, bh, warps)
    assert (chunk, splits) == want
    assert chunk % fdl.RUN == 0 and (splits - 1) * chunk < t <= splits * chunk
    assert bh * splits <= max(warps, bh)


@pytest.mark.parametrize("b,h,d,s_max,dtype", [
    (8, 12, 64, 1024, torch.bfloat16), (8, 12, 64, 128, torch.float32),
    (3, 2, 128, 384, torch.bfloat16), (72, 12, 64, 768, torch.float32)])
def test_fused_plan_lays_out_the_scratch(b, h, d, s_max, dtype):
    """One kept buffer: the qkv partials of each k-chunk, the attention
    output, the splits' (m, l) and acc[D], the out-proj partials, each
    from a 256-byte boundary and apart; tickets for every (row, head) and
    every out-proj column slice.  The splits and the grid hold those of
    every t < S_max, which the kernel works out from its device t."""
    plan = fdl.fused_plan(b, h, d, s_max, dtype, 264)
    hd = h * d
    cw = 64 if dtype == torch.bfloat16 else 32
    sizes = (hd // (32 * plan.l1) * b * 3 * hd * 4, b * hd * 4,
             b * h * plan.splits * (d + 2) * 4,
             hd // (32 * plan.l3) * b * hd * 4)
    ends = list(plan.offsets[1:]) + [plan.nbytes]
    for off, end, n in zip(plan.offsets, ends, sizes):
        assert off % 256 == 0 and end - off >= n
    assert plan.cap == 8 * 264 // (b * h)
    most = max(fdl.fused_split(t, b * h, 8 * 264)[1]
               for t in range(1, s_max))
    assert plan.splits == most
    assert plan.tickets == b * h + hd // cw
    assert min(264, -(-b * h * most // 8)) <= plan.grid <= 264
