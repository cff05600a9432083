"""The bf16 flash limits (`tolerance.FLASH_FWD_COEF`, `tolerance.BWD_COEF`)
and the float32 dQ limit against the JAX package, on the CPU; and, on the
card, the float32 flash forward, dQ and dK/dV kernels and the float32 FFN
(split TF32 on the tensor cores) against their plain versions.

The tensor-core forward rounds p to bf16 for its PV product at the running
max of each key tile, as the TPU kernel `_flash_fwd_kernel` does
(`pallas_ops.py:180-181`); the port's plain version (`mha_reference`)
rounds the normalised probabilities, at each row's final max.  The limit
the card tests hold the kernel to, 2^-7 max(|out|, |ref|) + 2^-7 P|V| per
element (`tolerance` docstring), has to cover that difference.  Here JAX's
own `_flash_fwd`, run in bf16 in interpret mode with 128-row blocks (so two
key tiles and their running max per row), is held against the port's
`mha_reference` under that limit, for every branch the kernel takes:
causal, a left-pad mask, kv_lens, segment ids (sorted documents across the
tiles in row 0, permuted in row 1) and non-causal, at S=256 and D 64 and
128.  Its lse is held to 1e-4 (both fp32, from the same bf16 products).

Rows the pad mask closes entirely (queries before the pad's end, whose
every allowed key is masked) are left out: there JAX's kernel spreads the
row over whole key tiles and the port over the allowed keys, a difference
by design (ROADMAP Queue 3); no real token reads such a row.

The backward: the tensor-core dQ and dK/dV round ds (and p for dV) to
bf16 before their products, as `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel` do (`pallas_ops.py:250-251`, `:313-316`).  JAX's
own `_flash_bwd`, run in bf16 in interpret mode with 128-row blocks on
the output and lse of its bf16 forward, is held against the port's
`flash_attention_bwd_reference` on the same out and statistic (JAX's lse;
with a mask or kv_lens the port's (row max, log l) pair, which the masked
backward reads) under the limit the card tests apply to the kernels:
2^-7 max(|out|, |ref|) + `BWD_COEF` times the gradient's sum of
magnitudes (`flash_bwd_magnitudes`), every element of dQ, dK and dV.
dO is zero on the rows the pad mask closes entirely, so that those rows,
whose p differs by design as above, carry no gradient on either side.
The same in fp32: JAX's fp32 `_flash_bwd` (interpret mode, its products
at HIGHEST) gives a dQ within 1e-4 max|ref| of the port's plain dQ on the
same out and statistic, for every branch at D 64 and 128 -- the limit the
card holds the split-TF32 dQ to against that plain version.

The FFN: JAX's `fused_ffn_arrays` (`_ffn_fwd_kernel` in interpret mode,
one 256-row block, two 128-wide blocks of I) against the port's
`fused_ffn_reference` at n=256, H=128, I=256, a shape the port's picker
sends to the tensor-core designs (bf16, and fp32 in split TF32), for each
activation: fp32 within 1e-5 max|ref| (fp32 sums in other
orders), bf16 within `tolerance.ffn_limit` (one bf16 step of y plus the
rounding of h to bf16 through |W2|, the limit the card holds each design
to against the same plain version).

The float32 tensor-core kernels (card tests, the ``cuda`` marker; they
skip without a card): the forward, dQ and dK/dV of every branch (causal,
a left-pad mask whose pad rows are closed entirely, kv_lens, segment ids
sorted and permuted, non-causal, and segments with an additive mask and
kv_lens), D 64 and 128, S 200 and 1000 (off the key tiles), q, k, v
slices of one fused projection: out within 2e-5, lse and the masked pair
within 1e-4, dQ, dK and dV within 1e-4 max|ref| (the float32 limits,
which the split keeps: tests/test_torch_port_tf32.py,
tests/test_torch_port_tf32_dq_ffn.py), one launch each under ``:tc32``,
and a second launch of each bitwise equal to the first; the split-TF32
FFN (``fused_ffn_tc32``) at 64, 200, 333 and 1024 rows, each activation,
within 1e-5 max|ref| and bitwise on a second launch.  JAX
is imported by the JAX tests alone (the ``jx`` fixture), so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_tc.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import tolerance as tol
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


B, H, S = 2, 2, 256
PADS = (0, 37)
BRANCHES = ["causal", "pad_mask", "kv_lens", "segments", "noncausal"]


@pytest.fixture
def jx():
    """(jax.numpy, the JAX package's pallas_ops), imported when a test
    runs: the card's machine has no JAX and runs this file's card tests
    alone, where the JAX tests skip."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import pallas_ops as jpo
    return jnp, jpo


def _inputs(branch, d, seed):
    """q, k, v float32 [B, S, H, D] (bf16-exact), causal, the additive
    [B, 1, S, S] mask, kv_lens [B] and segment ids [B, S] of a branch, and
    the first row each batch row is compared from."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, S, H, d).astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
               for a in (q, k, v))
    mask = lens = segs = None
    first = [0] * B
    if branch == "pad_mask":
        mask = np.zeros((B, 1, S, S), np.float32)
        for r, n in enumerate(PADS):
            mask[r, :, :, :n] = -1e30
        first = list(PADS)
    if branch == "kv_lens":
        lens = np.array([S - 45, S], np.int32)
    if branch == "segments":
        row = np.concatenate([np.full(n, i) for i, n in
                              enumerate((100, 70, 50, 36))]).astype(np.int32)
        segs = np.stack([row, rng.permutation(row)])
    return q, k, v, branch != "noncausal", mask, lens, segs, first


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", BRANCHES)
def test_jax_bf16_flash_fwd_within_flash_limit(branch, d, monkeypatch, jx):
    jnp, jpo = jx
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    q, k, v, causal, mask, lens, segs, first = _inputs(branch, d, 7 + d)
    scale = d ** -0.5
    of, lse = jpo._flash_fwd(
        *(jpo._fold_heads(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v)),
        causal, scale, block_q=128, block_k=128, n_heads=H,
        mask=None if mask is None else jnp.asarray(mask),
        kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
        segments=None if segs is None else jnp.asarray(segs))
    assert of.dtype == jnp.bfloat16
    got = torch.from_numpy(np.asarray(
        jpo._unfold_heads(of, b=B, h=H).astype(jnp.float32)))
    got_lse = torch.from_numpy(np.asarray(lse)).reshape(B, H, S)

    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mt, lt, st = (None if a is None else torch.from_numpy(a)
                  for a in (mask, lens, segs))
    want, want_lse = fa.mha_reference(qt, kt, vt, mt, causal, scale, lt, st,
                                      return_lse=True)
    mag = tol.flash_fwd_magnitude(qt, kt, vt, causal, mt, lt, st)
    limit = tol.bf16_limit(got, want, mag, tol.FLASH_FWD_COEF)
    for r in range(B):
        rows = slice(first[r], S)
        err, ratio, ok = tol.compare(got[r, rows], want[r, rows],
                                     limit[r, rows])
        assert ok, (branch, d, r, err, ratio)
        lse_err = (got_lse[r, :, rows] - want_lse[r, :, rows]).abs().max()
        assert lse_err.item() <= 1e-4, (branch, d, r, lse_err.item())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", BRANCHES)
def test_jax_bf16_flash_bwd_within_bwd_limit(branch, d, monkeypatch, jx):
    jnp, jpo = jx
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    q, k, v, causal, mask, lens, segs, first = _inputs(branch, d, 11 + d)
    do = np.random.RandomState(13 + d).randn(B, S, H, d).astype(np.float32)
    for r in range(B):
        do[r, :first[r]] = 0.0
    scale = d ** -0.5
    qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a, jnp.bfloat16))
                       for a in (q, k, v, do))
    kw = dict(n_heads=H, mask=None if mask is None else jnp.asarray(mask),
              kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
              segments=None if segs is None else jnp.asarray(segs))
    of, lse = jpo._flash_fwd(qf, kf, vf, causal, scale, block_q=128,
                             block_k=128, **kw)
    got = jpo._flash_bwd(qf, kf, vf, of, lse, dof, causal, scale,
                         block_q=128, block_k=128, **kw)
    assert all(g.dtype == jnp.bfloat16 for g in got)

    def port(a):
        return torch.from_numpy(np.array(
            jpo._unfold_heads(a, b=B, h=H).astype(jnp.float32))).bfloat16()

    qt, kt, vt, dot = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    out = port(of)
    mt, lt, st = (None if a is None else torch.from_numpy(a)
                  for a in (mask, lens, segs))
    stat = torch.from_numpy(np.array(lse)).reshape(B, H, S)
    row_max = None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(qt, kt, scale, causal, mt, lt, st)
    want = fa.flash_attention_bwd_reference(
        qt, kt, vt, out, stat, dot, scale, is_causal=causal, mask=mt,
        kv_lens=lt, segment_ids=st, row_max=row_max)
    mags = tol.flash_bwd_magnitudes(qt, kt, vt, out, stat, dot, scale,
                                    causal=causal, mask=mt, lens=lt,
                                    segs=st, row_max=row_max)
    for what, g, w, mag in zip(("dq", "dk", "dv"), got, want, mags):
        g = port(g)
        limit = tol.bf16_limit(g, w, mag, tol.BWD_COEF)
        err, ratio, ok = tol.compare(g, w, limit)
        assert ok, (branch, d, what, err, ratio)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", BRANCHES)
def test_jax_fp32_flash_dq_within_bwd_limit(branch, d, monkeypatch, jx):
    """JAX's fp32 `_flash_bwd` (`_flash_bwd_dq_kernel` in interpret mode,
    128-row blocks, fp32 products at HIGHEST) against the port's plain
    dQ on JAX's own fp32 out and statistic (with a mask or kv_lens the
    port's (row max, log l) pair), within 1e-4 max|ref|: the limit the
    card holds the split-TF32 dQ to against the same plain version."""
    jnp, jpo = jx
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    q, k, v, causal, mask, lens, segs, first = _inputs(branch, d, 17 + d)
    do = np.random.RandomState(19 + d).randn(B, S, H, d).astype(np.float32)
    for r in range(B):
        do[r, :first[r]] = 0.0
    scale = d ** -0.5
    qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a)) for a in (q, k, v, do))
    kw = dict(n_heads=H, mask=None if mask is None else jnp.asarray(mask),
              kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
              segments=None if segs is None else jnp.asarray(segs))
    of, lse = jpo._flash_fwd(qf, kf, vf, causal, scale, block_q=128,
                             block_k=128, **kw)
    got = jpo._flash_bwd(qf, kf, vf, of, lse, dof, causal, scale,
                         block_q=128, block_k=128, **kw)[0]
    assert got.dtype == jnp.float32
    got = torch.from_numpy(np.array(jpo._unfold_heads(got, b=B, h=H)))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    out = torch.from_numpy(np.array(jpo._unfold_heads(of, b=B, h=H)))
    mt, lt, st = (None if a is None else torch.from_numpy(a)
                  for a in (mask, lens, segs))
    stat = torch.from_numpy(np.array(lse)).reshape(B, H, S)
    row_max = None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(qt, kt, scale, causal, mt, lt, st)
    want = fa.flash_attention_bwd_reference(
        qt, kt, vt, out, stat, dot, scale, is_causal=causal, mask=mt,
        kv_lens=lt, segment_ids=st, row_max=row_max)[0]
    for r in range(B):
        rows = slice(first[r], S)
        err = (got[r, rows] - want[r, rows]).abs().max().item()
        assert err <= 1e-4 * want[r].abs().max().item(), (branch, d, r, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
def test_jax_ffn_kernel_matches_port_plain_at_tc_shape(act, dtype,
                                                       monkeypatch, jx):
    jnp, jpo = jx
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    n, h, i = 256, 128, 256
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    assert fm.ffn_design(n, h, i, tdt) == ("tc" if tdt == torch.bfloat16
                                           else "tc32")
    rng = np.random.RandomState(21)
    arrays = (rng.randn(n, h), rng.randn(h, i) / np.sqrt(h),
              0.1 * rng.randn(i), rng.randn(i, h) / np.sqrt(i))
    arrays = [a.astype(np.float32) for a in arrays]
    got = jpo.fused_ffn_arrays(*(jnp.asarray(a).astype(jdt)
                                 for a in arrays), act=act)
    assert got.dtype == jdt and got.shape == (n, h)
    got = torch.from_numpy(np.asarray(got.astype(jnp.float32))).to(tdt)
    args = [torch.from_numpy(a).to(tdt) for a in arrays]
    want = fm.fused_ffn_reference(*args, act)
    limit = (1e-5 * want.float().abs().max().item()
             if tdt == torch.float32 else tol.ffn_limit(*args, act))
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, (act, dtype, err, ratio)


# ---------------------------------------------------------------------------
# the float32 flash kernels and FFN on the card (split TF32)
# ---------------------------------------------------------------------------

@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain)")


TC32_BRANCHES = ["causal", "pad_mask", "kv_lens", "segments", "noncausal",
                 "all"]


def _tc32_inputs(branch, b, s, h, d, seed):
    """fp32 q, k, v (slices of one fused [B, S, 3, H, D] tensor), dO and
    the branches of a case on the card: ``pad_mask`` left-pad keys and rows
    (rows the mask closes entirely), ``segments`` documents across the
    tiles in row 0 and permuted ids in row 1, ``all`` segments, an
    additive [B, H, S, S] mask and kv_lens, causal."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).cuda().unbind(2)
    do = torch.randn(b, s, h, d, generator=g).cuda()
    mask = lens = segs = None
    if branch == "pad_mask":
        m = torch.zeros(b, 1, s, s)
        for r in range(b):
            m[r, :, :, :13 + 40 * r] = -1e30
            m[r, :, :13 + 40 * r, :] = -1e30
        mask = m.expand(b, h, s, s).cuda()
    if branch in ("segments", "all"):
        cuts = [0, 50, 90, 150, 171, s]
        row = torch.cat([torch.full((cuts[i + 1] - cuts[i],), i)
                         for i in range(len(cuts) - 1)])
        segs = torch.stack([row, row[torch.randperm(s, generator=g)]]
                           + [row] * (b - 2)).int().cuda()
    if branch == "all":
        mask = (torch.randn(b, h, s, s, generator=g) * 2).cuda()
    if branch in ("kv_lens", "all"):
        lens = torch.tensor([s - 45 * r for r in range(b)],
                            dtype=torch.int32).cuda()
    return q, k, v, do, branch != "noncausal", mask, lens, segs


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("s", [200, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", TC32_BRANCHES)
def test_fp32_tc_flash_fwd_and_dkv_match_plain(branch, d, s):
    """The split-TF32 forward and dK/dV against the plain versions, every
    row: out within 2e-5, lse and the masked pair within 1e-4, dK and dV
    within 1e-4 max|ref|; one launch each under ``:tc32``; a second launch
    of each bitwise equal to the first."""
    q, k, v, do, causal, mask, lens, segs = _tc32_inputs(branch, 2, s, 2, d,
                                                         s + d)
    scale = d ** -0.5
    fa.tc32.launches = fa.flash_bwd_dkv.tc32.launches = 0
    out, lse, pair = fa._launch(q, k, v, scale, causal, mask, lens, segs)
    again = fa._launch(q, k, v, scale, causal, mask, lens, segs)
    want, want_lse = fa.mha_reference(q, k, v, mask, causal, scale, lens,
                                      segs, return_lse=True)
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    kw = dict(causal=causal, mask=mask, lens=lens, segs=segs,
              row_max=row_max)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale, **kw)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=mask,
        kv_lens=lens, segment_ids=segs, row_max=row_max)
    torch.cuda.synchronize()
    assert (fa.tc32.launches, fa.flash_bwd_dkv.tc32.launches) == (2, 2)
    assert (out - want).abs().max().item() <= 2e-5
    assert (lse - want_lse).abs().max().item() <= 1e-4
    if pair is not None:
        pm, pl = fa.softmax_stats(q, k, scale, causal, mask, lens, segs)
        assert (pair[0] - pm).abs().max().item() <= 1e-4
        assert (pair[1] - pl).abs().max().item() <= 1e-4
    for what, got, r in (("dk", dk, ref[1]), ("dv", dv, ref[2])):
        err = (got - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), (what, err)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("s", [200, 1000])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("branch", TC32_BRANCHES)
def test_fp32_tc_flash_dq_matches_plain(branch, d, s):
    """The split-TF32 dQ against the plain backward, every row, on the
    forward's own statistics: within 1e-4 max|ref|; one launch under
    ``flash_bwd_dq_causal:tc32``; a second launch bitwise equal to the
    first."""
    q, k, v, do, causal, mask, lens, segs = _tc32_inputs(branch, 2, s, 2, d,
                                                         s + d + 1)
    scale = d ** -0.5
    out, lse, pair = fa._launch(q, k, v, scale, causal, mask, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    kw = dict(causal=causal, mask=mask, lens=lens, segs=segs,
              row_max=row_max)
    fa.flash_bwd_dq.tc32.launches = 0
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, **kw)
    again = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, **kw)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=mask,
        kv_lens=lens, segment_ids=segs, row_max=row_max)[0]
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.tc32.launches == 2
    err = (dq - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
    assert torch.equal(again, dq)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("n,h,i", [(64, 768, 3072), (200, 768, 3072),
                                   (1024, 768, 3072), (333, 256, 512)])
def test_fp32_tc_ffn_matches_plain(n, h, i, act):
    """The split-TF32 FFN (``csrc/fused_ffn_tc32.cu``) against the fp32
    plain version within 1e-5 max|ref| (the float32 FFN limit, which the
    split and its two levels of sums keep:
    tests/test_torch_port_tf32_dq_ffn.py); launched under ``fused_ffn_tc32``;
    a second launch bitwise equal to the first."""
    g = torch.Generator().manual_seed(n + i)
    args = (torch.randn(n, h, generator=g),
            torch.randn(h, i, generator=g) * h ** -0.5,
            torch.randn(i, generator=g) * 0.1,
            torch.randn(i, h, generator=g) * i ** -0.5)
    args = [a.cuda() for a in args]
    fm.ffn_tc32.launches = 0
    y = fm._tc32_launch(*args, act)
    again = fm._tc32_launch(*args, act)
    want = fm.fused_ffn_reference(*args, act)
    torch.cuda.synchronize()
    assert fm.ffn_tc32.launches == 2
    err = (y - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert torch.equal(again, y)
