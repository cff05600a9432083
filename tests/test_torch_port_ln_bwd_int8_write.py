"""The redesigned LayerNorm backward and int8 paged-KV write, on the CPU.

The kernels of ``csrc/fused_layernorm_bwd.cu`` and the int8 write of
``csrc/ragged_paged_attention.cu`` run only on the card.  Here their
orders of operations are emulated in torch and held against the plain
versions and the JAX package:

- LayerNorm backward: `_ln_bwd_emulate` follows the row design of
  `fused_mlp.ln_bwd_plan`'s plan in fp32 -- each lane's columns (a scalar
  head and tail where rows start off 16 bytes, 16-byte chunks of the
  warp's segment), the lane's sums in its order, the 32-lane shuffle
  tree, the S warps of a row in order; dw and db per group of rows, the
  groups of a block in order, the blocks of a merge group, the groups --
  against `fused_layernorm_bwd_reference` at `tolerance.ln_bwd_limits`
  and against the JAX `_ln_vjp_bwd` (the Pallas kernel in interpret
  mode), fp32, bf16 and mixed (bf16 x, fp32 w), n = 0, 1, 8 and counts
  that leave groups and blocks partly empty, H on and off 8.  Every
  column is owned by exactly one lane of a row, at every start offset.
- The planner's grid and warps at H = 768, 2048 and 4096 on 132 SMs.
- int8 write: `_int8_write_emulate` takes the kernel's units -- each
  (row, logical block group, K or V head): the group's pool block from
  its first in-pool slot, the head's abs-max over the kept rows, the
  scale grown once, the old codes rescaled once, the new rows quantized
  -- and must give codes and scales bitwise those of the port's
  `quantized_cache_update_arrays` and of the jitted JAX one: a decode
  step beside a padding row, chunks over 2 to 33 blocks from mid-block,
  scales that grow (old codes rescaled) and that do not, padding slots
  inside a chunk, and half-to-even ties.

JAX comes from the ``jx`` fixture: the card's machine has no JAX.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import tolerance as tol

BF, F32 = torch.bfloat16, torch.float32
LN_MIXES = [(F32, F32), (BF, BF), (BF, F32)]


@pytest.fixture
def jx():
    """(jax, jax.numpy, the JAX package's pallas_ops and paged_attention),
    imported when a test runs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.ops import paged_attention as jpa
    from paddle_tpu.ops import pallas_ops as jpo
    return jax, jnp, jpo, jpa


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------

def _ln_inputs(n, h, xdt, pdt, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, h) * 2 + 0.5).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.randn(h)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(h)).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, h).astype(np.float32))
    x, w, b = x.to(xdt), w.to(pdt), b.to(pdt)
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    return x, w, b, mu, rs, dy.to(torch.promote_types(xdt, pdt))


def _fma(a, b, c):
    """fp32 a * b + c, rounded once (through fp64: the product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _frame(row_start, h, xb):
    """(head, nvec, tail) of a row starting ``row_start`` bytes past a
    16-byte boundary: scalars up to the next boundary, whole 16-byte
    chunks, scalars past the last chunk (the kernel's frame)."""
    v = 16 // xb
    mis = row_start % 16 // xb
    head = min(h, v - mis if mis else 0)
    nvec = (h - head) // v
    return head, nvec, h - head - nvec * v


def _owners(h, xb, start, s, seg):
    """[S, 32, L] columns a lane sums, in its order (-1: none), for rows
    starting ``start`` bytes past 16: its head column, its tail column,
    then its chunks' values."""
    v = 16 // xb
    head, nvec, tail = _frame(start, h, xb)
    nc = -(-seg // 32)
    own = torch.full((s, 32, 2 + nc * v), -1, dtype=torch.long)
    for w in range(s):
        for lane in range(32):
            if w == 0 and lane < head:
                own[w, lane, 0] = lane
            if w == 0 and lane < tail:
                own[w, lane, 1] = head + nvec * v + lane
            for c in range(nc):
                k = lane + 32 * c
                ch = w * seg + k
                if k < seg and ch < nvec:
                    own[w, lane, 2 + c * v:2 + (c + 1) * v] = torch.arange(
                        head + ch * v, head + (ch + 1) * v)
    return own


def _warp_sum(v):
    """The shuffle tree over the last (lane) axis: v[l] += v[l ^ o]."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v


def _ln_bwd_emulate(x, w, mu, rs, dy, plan):
    """(dx, dw, db) of the row design's order of operations, x's buffer
    on 16 bytes."""
    n, h = x.shape
    xb = x.element_size()
    g_rows = plan.warps // plan.s
    t = plan.grid * g_rows
    xf, dyf, wf = x.float(), dy.float(), w.float()
    xh = (xf - mu) * rs
    g = dyf * wf
    dx = torch.zeros(n, h)
    # the row sums, rows grouped by where they start against 16 bytes
    frames = {}
    for r in range(n):
        frames.setdefault(r * h * xb % 16, []).append(r)
    for start, rows in frames.items():
        own = _owners(h, xb, start, plan.s, plan.seg)
        rows = torch.tensor(rows)
        gg = torch.cat([g[rows], torch.zeros(len(rows), 1)], 1)[:, own]
        xx = torch.cat([xh[rows], torch.zeros(len(rows), 1)], 1)[:, own]
        a = gg[..., 0]
        b = a * xx[..., 0]
        for k in range(1, own.shape[-1]):
            a = a + gg[..., k]
            b = _fma(gg[..., k], xx[..., k], b)
        a, b = _warp_sum(a)[..., 0], _warp_sum(b)[..., 0]   # [rows, S]
        sg = sgx = torch.zeros(len(rows))
        for k in range(plan.s):
            sg, sgx = sg + a[:, k], sgx + b[:, k]
        m1, m2 = (sg / h)[:, None], (sgx / h)[:, None]
        dx[rows] = rs[rows] * (g[rows] - m1 - xh[rows] * m2)
    # dw, db: each group's rows in order, the groups of a block, the
    # blocks of a merge group, the merge groups
    pw, pb = torch.zeros(t, h), torch.zeros(t, h)
    for k in range(-(-n // t)):
        rows = torch.arange(k * t, min((k + 1) * t, n))
        gid = rows - k * t
        pw[gid] = _fma(dyf[rows], xh[rows], pw[gid])
        pb[gid] = pb[gid] + dyf[rows]

    def in_order(parts, size):
        out = []
        for i in range(0, parts.shape[0], size):
            acc = torch.zeros(h)
            for p in parts[i:i + size]:
                acc = acc + p
            out.append(acc)
        return torch.stack(out)

    sums = []
    for p in (pw, pb):
        blocks = in_order(p, g_rows)
        groups = in_order(blocks, plan.k)
        sums.append(in_order(groups, groups.shape[0])[0])
    return dx.to(x.dtype), sums[0].to(w.dtype), sums[1].to(w.dtype)


def _check_limits(got, want, x, w, mu, rs, dy, what):
    limits = tol.ln_bwd_limits(got, want, x, w, mu, rs, dy)
    for name, g, r, lim in zip(("dx", "dw", "db"), got, want, limits):
        if not g.numel():
            continue
        err, ratio, ok = tol.compare(g, r, lim)
        assert ok, f"{what} {name}: max error {err}, {ratio:.3g}x its limit"


@pytest.mark.parametrize("xdt,pdt", LN_MIXES)
@pytest.mark.parametrize("n,h", [(1, 768), (8, 768), (33, 768), (203, 768),
                                 (67, 256), (9, 1000), (45, 1002),
                                 (21, 1001), (13, 2048), (0, 768)])
def test_ln_bwd_emulation_matches_plain(n, h, xdt, pdt):
    """The emulated kernel order against the plain backward, at the limits
    the card holds the kernel to: one row, a partial group (8 rows of 2 a
    step), partial blocks and merge groups, widths off 8 whose rows start
    at every offset, a row split over 4 to 6 warps, no rows."""
    x, w, _, mu, rs, dy = _ln_inputs(n, h, xdt, pdt, n + h)
    plan = fm.ln_bwd_plan(max(n, 1), h, xdt)
    assert not plan.wide
    got = _ln_bwd_emulate(x, w, mu, rs, dy, plan)
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    assert [g.dtype for g in got] == [xdt, pdt, pdt]
    _check_limits(got, want, x, w, mu, rs, dy, f"n={n} H={h}")


@pytest.mark.parametrize("xdt,pdt", LN_MIXES)
@pytest.mark.parametrize("n", [8, 24, 384])
def test_ln_bwd_emulation_matches_jax_kernel(n, xdt, pdt, jx,
                                             monkeypatch):
    """Against JAX's `_ln_vjp_bwd` (the Pallas backward in interpret mode)
    at widths and row counts its kernel takes."""
    _, jnp, jpo, _ = jx
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    h = 256
    x, w, b, mu, rs, dy = _ln_inputs(n, h, xdt, pdt, n)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(str(t.dtype)[6:])

    jmu, jrs = (jnp.asarray(t.numpy()) for t in (mu, rs))
    want = jpo._ln_vjp_bwd(1e-5, (j(x), j(w), j(b), jmu, jrs), j(dy))
    plan = fm.ln_bwd_plan(n, h, xdt)
    got = _ln_bwd_emulate(x, w, mu, rs, dy, plan)
    want = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        g.dtype) for a, g in zip(want, got)]
    _check_limits(got, want, x, w, mu, rs, dy, f"n={n} vs JAX")


@pytest.mark.parametrize("xb", [4, 2])
@pytest.mark.parametrize("h", [5, 64, 768, 1000, 1001, 1002, 2048, 4096])
def test_ln_bwd_lanes_cover_each_column_once(h, xb):
    """At each offset a row can start at against 16 bytes, the lanes of
    the plan's S warps own every column exactly once."""
    dt = F32 if xb == 4 else BF
    plan = fm.ln_bwd_plan(64, h, dt)
    for start in range(0, 16, xb):
        own = _owners(h, xb, start, plan.s, plan.seg)
        cols = own[own >= 0]
        assert cols.numel() == h and torch.equal(cols.sort().values,
                                                 torch.arange(h))


# (grid, warps, S, seg, K) at 8, 200 and 8192 rows on 132 SMs, by width
# and x's type
LN_BWD_PLANS = {
    (768, F32): [(1, 16, 2, 96, 1), (13, 16, 2, 96, 13),
                 (132, 16, 2, 96, 12)],
    (768, BF): [(1, 15, 3, 32, 1), (20, 15, 3, 32, 5), (132, 15, 3, 32, 12)],
    (2048, F32): [(2, 12, 6, 86, 2), (50, 12, 6, 86, 8),
                  (132, 12, 6, 86, 12)],
    (2048, BF): [(2, 16, 8, 32, 2), (50, 16, 8, 32, 8), (132, 16, 8, 32, 12)],
    (4096, F32): [(4, 11, 11, 94, 4), (100, 11, 11, 94, 10),
                  (132, 11, 11, 94, 12)],
    (4096, BF): [(4, 16, 16, 32, 4), (100, 16, 16, 32, 10),
                 (132, 16, 16, 32, 12)],
}


@pytest.mark.parametrize("key", sorted(LN_BWD_PLANS, key=str))
def test_ln_bwd_plan_tables(key):
    """GPT-2's, gpt3_1p3b's and gpt3_6p7b's widths: a lane holds 8 bf16 /
    12 fp32 columns (S = 3 and 2 at 768; 8 and 6 at 2048; 16 and 11 at
    4096), 16 // S groups of S warps a block, two rows a group, at
    most one block an SM, and one merge level up to 16 blocks, else
    merge groups of ceil(sqrt(grid)) blocks."""
    h, xdt = key
    for n, want in zip((8, 200, 8192), LN_BWD_PLANS[key]):
        p = fm.ln_bwd_plan(n, h, xdt, 132)
        assert (p.grid, p.warps, p.s, p.seg, p.k) == want and not p.wide
        assert p.warps % p.s == 0 and p.warps <= 16


@pytest.mark.parametrize("h,xb", [(1002, 2), (1001, 2), (1002, 4),
                                  (999, 4)])
def test_ln_bwd_plan_groups_share_an_offset(h, xb):
    """The T = grid * G groups are a multiple of the rows' alignment
    period, so every row a group takes starts at one offset."""
    dt = F32 if xb == 4 else BF
    period = 16 // math.gcd(h * xb, 16)
    for n in (1, 5, 8, 100, 8192):
        p = fm.ln_bwd_plan(n, h, dt)
        t = p.grid * (p.warps // p.s)
        assert t % period == 0
        starts = {(r * h * xb) % 16 for r in range(0, 4 * t, t)}
        assert len(starts) == 1


def test_ln_bwd_plan_wide_rows():
    """Rows wider than 16 warps' columns take the wide design, up to
    the 29056 columns whose two fp32 partial rows fill a block's shared
    memory; its merge groups too."""
    assert fm.ln_bwd_plan(100, 4096, BF).seg == 32      # 8 columns a lane
    p = fm.ln_bwd_plan(100, 8192, BF)                   # 16 columns a lane
    assert not p.wide and (p.s, p.seg) == (16, 64)
    assert fm.ln_bwd_plan(100, 8200, BF).wide
    assert not fm.ln_bwd_plan(100, 6144, F32).wide
    p = fm.ln_bwd_plan(100, 6148, F32)
    assert p.wide and (p.warps, p.grid, p.k) == (4, 25, 5)
    assert fm.ln_bwd_plan(60, 6148, F32).k == 15       # one level
    p = fm.ln_bwd_plan(8192, 29056, F32)
    assert (p.warps, p.grid, p.k, p.groups) == (1, 264, 17, 16)
    with pytest.raises(ValueError, match="shared memory"):
        fm.ln_bwd_plan(8, 29057, BF)


def test_ln_bwd_sequence_length_at_8192_rows():
    """The longest chain of fp32 additions into one dw or db element at
    8192 rows of H = 768 (the `tolerance` docstring's count): a group's
    rows, the block's groups, a merge group's blocks, the merge groups."""
    p = fm.ln_bwd_plan(8192, 768, BF)
    g = p.warps // p.s
    chain = -(-8192 // (p.grid * g)) + g + p.k + p.groups
    assert chain == 41


# ---------------------------------------------------------------------------
# int8 write
# ---------------------------------------------------------------------------

def _int8_write_emulate(blocks, scales, rows, slots, pos0):
    """The kernel's int8 write, in place: one unit per (row, logical block
    group, head) of one pool (K or V)."""
    nb, bs, h, _ = blocks.shape
    b, c = slots.shape
    num = nb * bs
    for r in range(b):
        p0 = max(int(pos0[r]), 0)
        for i in range((c + bs - 2) // bs + 1):
            lb = p0 // bs + i
            j0, j1 = max(0, lb * bs - p0), min(c, (lb + 1) * bs - p0)
            if j0 >= j1:
                continue
            sl = slots[r, j0:j1].long()
            inpool = (sl >= 0) & (sl < num)
            if not inpool.any():
                continue
            base = int(sl[inpool][0]) // bs * bs
            keep = (sl >= base) & (sl < base + bs)
            x = rows[r, j0:j1][keep].float()
            off = sl[keep] - base
            blk = base // bs
            for hh in range(h):
                old = scales[blk, hh].clone()
                new = torch.maximum(old, x[:, hh].abs().max() * pa.INV_QMAX)
                if new > 0:
                    fac, wsc = old / new, new
                else:
                    fac, wsc = torch.tensor(1.0), torch.tensor(1.0)
                if fac != 1:
                    blocks[blk, :, hh] = torch.round(
                        blocks[blk, :, hh].float() * fac).clamp(
                            -pa.QMAX, pa.QMAX).to(torch.int8)
                blocks[blk, off, hh] = torch.round(x[:, hh] / wsc).clamp(
                    -pa.QMAX, pa.QMAX).to(torch.int8)
                scales[blk, hh] = new
    return blocks, scales


def _write_case(rows_spec, c, nb, bs, h, d, seed, scale_hi=0.02):
    """Pools, scales, rows, slots and pos0 for rows ``(pos0, n)`` writing
    positions pos0 .. pos0 + n - 1 (n < c: padding slots after them;
    None: a padding row), each row's blocks drawn from a shuffled pool;
    ``(pos0, n, gaps)`` also drops the positions in ``gaps``."""
    rng = np.random.RandomState(seed)
    b = len(rows_spec)
    slots = np.full((b, c), nb * bs, np.int32)
    pos0 = np.zeros(b, np.int32)
    free = list(rng.permutation(nb))
    for r, spec in enumerate(rows_spec):
        if spec is None:
            continue
        p0, n, *gaps = spec
        pos0[r] = p0
        table = [free.pop() for _ in range(-(-(p0 + c) // bs))]
        for j in range(n):
            p = p0 + j
            if j not in (gaps[0] if gaps else ()):
                slots[r, j] = table[p // bs] * bs + p % bs
    codes = rng.randint(-127, 128, (nb, bs, h, d)).astype(np.int8)
    scales = (rng.rand(nb, h) * scale_hi).astype(np.float32)
    x = (rng.randn(b, c, h, d) * 2).astype(np.float32)
    return codes, scales, x, slots, pos0


INT8_CASES = {
    # decode step: rows at block starts, ends and middles, a padding row
    "decode": ([(0, 1), (15, 1), (16, 1), (37, 1), None, (100, 1)], 1,
               40, 16, 3, 8, 1),
    # chunks of 2 and 4 blocks from mid-block, beside a decode row
    "chunk_2_blocks": ([(5, 20), (40, 1)], 20, 24, 16, 2, 8, 2),
    "chunk_4_blocks": ([(13, 40), None, (3, 1)], 40, 24, 16, 2, 8, 3),
    # the engine's C = 512 chunk from mid-block: 33 blocks
    "chunk_33_blocks": ([(13, 512)], 512, 48, 16, 2, 8, 4),
    # a chunk that ends early (padding slots after it) and one whose
    # middle positions are dropped
    "chunk_padded": ([(7, 30), (2, 41, (3, 17, 18, 30))], 48, 32, 16, 2,
                     8, 5),
    # scales large enough that no scale grows: codes unchanged
    "no_growth": ([(3, 10), (20, 1)], 10, 12, 16, 2, 8, 6),
}


def _emulate_both(codes, scales, x, slots, pos0, dtype):
    rows = torch.from_numpy(x).to(dtype)
    got = _int8_write_emulate(torch.from_numpy(codes.copy()),
                              torch.from_numpy(scales.copy()), rows,
                              torch.from_numpy(slots), pos0)
    want = pa.quantized_cache_update_arrays(
        torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy()),
        rows, torch.from_numpy(slots))
    return got, want


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_write_emulation_bitwise(case, dtype, jx):
    spec, c, nb, bs, h, d, seed = INT8_CASES[case]
    hi = 1000.0 if case == "no_growth" else 0.02
    codes, scales, x, slots, pos0 = _write_case(spec, c, nb, bs, h, d, seed,
                                                scale_hi=hi)
    got, want = _emulate_both(codes, scales, x, slots, pos0, dtype)
    for g, w in zip(got, want):
        assert torch.equal(g, w), case
    grown = int((got[1].numpy() != scales).sum())
    assert (grown == 0) == (case == "no_growth")
    jax, jnp, _, jpa = jx
    jb, js = jax.jit(jpa.quantized_cache_update_arrays)(
        jnp.asarray(codes), jnp.asarray(scales),
        jnp.asarray(x).astype(str(dtype)[6:]), jnp.asarray(slots))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jb))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(js))


def test_int8_write_emulation_half_to_even():
    """Block 0's scale doubles exactly, so its odd old codes land on
    n + 1/2 when rescaled; block 1 keeps its scale of 0.5 and takes rows
    at (n + 1/2) * 0.5: both round half to even, as the plain version."""
    nb, bs, h, d = 3, 4, 1, 4
    new0 = np.float32(100.0) * np.float32(pa.INV_QMAX)
    codes = np.zeros((nb, bs, h, d), np.int8)
    codes[0, 0, 0] = [5, 7, -5, 3]
    codes[1, 0, 0] = [11, -13, 127, -127]
    scales = np.array([[new0 / 2], [0.5], [0.0]], np.float32)
    x = np.zeros((2, 1, h, d), np.float32)
    x[0, 0, 0] = [100.0, 1.0, -2.0, 0.0]          # block 0, slot 1
    x[1, 0, 0] = [1.25, 1.75, -1.25, 0.25]        # block 1, slot 5
    slots = np.array([[1], [5]], np.int32)
    pos0 = np.array([1, 1], np.int32)
    (gb, gs), want = _emulate_both(codes, scales, x, slots, pos0, F32)
    assert torch.equal(gb, want[0]) and torch.equal(gs, want[1])
    assert gs[0, 0] == new0 and gs[1, 0] == 0.5 and gs[2, 0] == 0.0
    assert gb[0, 0, 0].tolist() == [2, 4, -2, 2]    # rescaled, ties even
    assert gb[1, 0, 0].tolist() == [11, -13, 127, -127]
    assert gb[1, 1, 0].tolist() == [2, 4, -2, 0]    # new row, ties even
