"""float16 through paddle_tpu_torch's attention kernels' plain versions,
against the JAX package, on the CPU; and the fp16 limits of
`paddle_tpu_torch.ops.tolerance`, emulated.

The same numpy inputs, made from a seed, go through both packages in
float16 (S <= 256, H=2, D=64):

(a) the plain flash forward (out and lse) and backward against the JAX
    Pallas kernels `_flash_fwd` / `_flash_bwd` in interpret mode
    (``PTPU_PALLAS_INTERPRET=1``), every branch: causal, segment ids
    causal and non-causal, an additive mask, kv_lens, non-causal, and mask
    with kv_lens non-causal; and `flash_attention_arrays` gradients
    through autograd against the same backward kernels.
(b) the plain decode (`flash_decode_reference`) against the JAX
    `_decode_kernel` (`flash_decode_arrays`, interpret mode, forced with
    ``PTPU_FLASH_DECODE=1``), which computes an fp16 cache in fp32 and
    rounds no probability, as the plain version does in fp16.
(c) the ragged plain version on fp16 pools, and on int8 pools with fp16
    q, k_new and v_new, against the JAX XLA fallback (the oracle of
    ROADMAP's "Caveat about the reference"): pools bitwise, int8 codes
    and scales bitwise, the outputs within the limit of two fp32 sums in
    other orders rounded to fp16.
(d) `_build.dtype_code`: float32 0, bfloat16 1, float16 2, anything else
    raises; and the gates: each wrapper takes fp16 on the CPU (its plain
    version) and counts nothing.
(e) the fp16 tensor-core kernels' arithmetic emulated in torch (the
    forward's online softmax over 64-key tiles with p rounded to fp16 at
    the tile's running max; the backward's p and ds rounded from fp32
    values summed in another order) against the plain version within the
    fp16 limits, also on logits 16 times larger, where many probabilities
    are subnormal in fp16 -- the case of the limits' absolute term.

Limits (`tolerance`, fp16): one fp16 step of the output (2^-10
relative), plus ``coef`` times the magnitudes the rounded intermediates
multiply (2^-10 for the flash forward and backward, where both sides
round p and ds), plus 2^-16 of those magnitudes for fp32 sums in other
orders, plus 2^-24 absolute and 2^-24 times the sum of what a subnormal
intermediate may weight.  The lse: 1e-5 absolute (fp32 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.ops import ragged_paged_attention as jrpa

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


B, H, D = 2, 2, 64
LSE_TOL = 1e-5
# (name, causal, mask, kv_lens, segments)
BRANCHES = [("causal", True, False, False, False),
            ("segs_causal", True, False, False, True),
            ("segs_noncausal", False, False, False, True),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("noncausal", False, False, False, False),
            ("mask_kv_lens_noncausal", False, True, True, False)]


def _h(a):
    """numpy float32 -> torch float16."""
    return torch.from_numpy(np.array(a, np.float32)).half()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jh(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.float16)


def _assert_within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _additive(shape, rng):
    """N(0, 2) scores, -1e30 at ~30 % of the keys, column 0 and the
    diagonal open (every row keeps a key)."""
    m = (rng.randn(*shape) * 2).astype(np.float32)
    m[rng.rand(*shape) < 0.3] = -1e30
    m[..., 0] = 0.0
    idx = np.arange(shape[-1])
    m[..., idx, idx] = 0.0
    return m


def _segments(s, rng, lens=(100, 70, 50, 20)):
    row = np.concatenate([np.full(n, i) for i, n in enumerate(lens)])
    row = np.concatenate([row, np.full(s - len(row), len(lens))])
    return np.stack([row, rng.permutation(row)]).astype(np.int32)


def _branch_inputs(name, s, seed):
    _, causal, has_mask, has_lens, has_segs = next(
        c for c in BRANCHES if c[0] == name)
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, s, H, D).astype(np.float32)
                   for _ in range(4))
    mask = _additive((B, 1, s, s), rng) if has_mask else None
    lens = np.array([s - 37, s], np.int32) if has_lens else None
    segs = _segments(s, rng) if has_segs else None
    return causal, q, k, v, do, mask, lens, segs


# ---------------------------------------------------------------------------
# (a) flash forward and backward against the JAX kernels, fp16
# ---------------------------------------------------------------------------

S = 256


@pytest.fixture(scope="module")
def jax_flash():
    """{branch: (out, lse, (dq, dk, dv))} of the JAX Pallas kernels in
    fp16, interpret mode, 128-row blocks."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PTPU_PALLAS_INTERPRET", "1")
    runs = {}
    try:
        for name, *_ in BRANCHES:
            causal, q, k, v, do, mask, lens, segs = _branch_inputs(name, S,
                                                                   11)
            qf, kf, vf, dof = (jpo._fold_heads(_jh(a)) for a in (q, k, v, do))
            kw = dict(n_heads=H,
                      mask=None if mask is None else jnp.asarray(mask),
                      kv_lens=(None if lens is None
                               else jnp.asarray(lens)[:, None]),
                      segments=None if segs is None else jnp.asarray(segs))
            of, lse = jpo._flash_fwd(qf, kf, vf, causal, D ** -0.5,
                                     block_q=128, block_k=128, **kw)
            grads = jpo._flash_bwd(qf, kf, vf, of, lse, dof, causal,
                                   D ** -0.5, block_q=128, block_k=128, **kw)
            assert of.dtype == jnp.float16
            assert all(g.dtype == jnp.float16 for g in grads)
            runs[name] = (jpo._unfold_heads(of, B, H), lse,
                          tuple(jpo._unfold_heads(g, B, H) for g in grads))
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
def test_plain_forward_matches_jax_kernel_fp16(name, jax_flash):
    causal, q, k, v, _, mask, lens, segs = _branch_inputs(name, S, 11)
    want, want_lse, _ = jax_flash[name]
    qt, kt, vt = (_h(a) for a in (q, k, v))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    got, lse = fa.mha_reference(qt, kt, vt, br[0], causal, D ** -0.5,
                                *br[1:], return_lse=True)
    assert got.dtype == torch.float16
    want = _h(_np(want))
    limit = tol.flash_fwd_limit(got, want, qt, kt, vt, causal, *br)
    _assert_within(got, want, limit, f"forward {name}")
    np.testing.assert_allclose(lse.numpy(), _np(want_lse).reshape(B, H, S),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
def test_plain_backward_matches_jax_kernels_fp16(name, jax_flash):
    """The port's plain backward from the JAX kernel's fp16 out (and its
    lse, or the port's own (row max, log l) pair where a mask or kv_lens
    is given) against `_flash_bwd`'s dq, dk, dv."""
    causal, q, k, v, do, mask, lens, segs = _branch_inputs(name, S, 11)
    out, lse, want = jax_flash[name]
    qt, kt, vt, dot = (_h(a) for a in (q, k, v, do))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    stat = torch.from_numpy(_np(lse).reshape(B, H, S))
    row_max = None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(qt, kt, D ** -0.5, causal, *br)
    outt = _h(_np(out))
    got = fa.flash_attention_bwd_reference(
        qt, kt, vt, outt, stat, dot, D ** -0.5, is_causal=causal,
        mask=br[0], kv_lens=br[1], segment_ids=br[2], row_max=row_max)
    want = [_h(_np(w)) for w in want]
    limits = tol.flash_bwd_limits(got, want, qt, kt, vt, outt, stat, dot,
                                  D ** -0.5, causal=causal, mask=br[0],
                                  lens=br[1], segs=br[2], row_max=row_max)
    for which, g, w, lim in zip(("dq", "dk", "dv"), got, want, limits):
        assert g.dtype == torch.float16
        _assert_within(g, w, lim, f"backward {which} {name}")


@pytest.mark.parametrize("name", ["causal", "segs_causal", "kv_lens"])
def test_autograd_fp16_matches_jax_kernels(name, monkeypatch):
    """`flash_attention_arrays` on fp16 tensors that need gradients: the
    `FlashAttention` function, on the CPU the plain forward and backward
    (no launch), fp16 gradients within the backward limits of
    `_flash_bwd` (interpret mode) fed the port's forward out and lse."""
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    causal, q, k, v, do, _, lens, segs = _branch_inputs(name, S, 13)
    qt, kt, vt = (_h(a).requires_grad_() for a in (q, k, v))
    lt = None if lens is None else torch.from_numpy(lens)
    st = None if segs is None else torch.from_numpy(segs)
    ops.reset_launch_counts()
    out, lse = fa.flash_attention_arrays(qt, kt, vt, is_causal=causal,
                                         kv_lens=lt, segment_ids=st,
                                         return_lse=True)
    assert "FlashAttention" in out.grad_fn.name()
    dot = _h(do)
    out.backward(dot)
    assert set(ops.launch_counts().values()) == {0}
    out = out.detach()
    want = jpo._flash_bwd(
        *(jpo._fold_heads(_jh(a)) for a in (q, k, v)),
        jpo._fold_heads(jnp.asarray(out.float().numpy(), jnp.float16)),
        jnp.asarray(lse.numpy()).reshape(B * H, 1, S),
        jpo._fold_heads(_jh(do)), causal, D ** -0.5, block_q=128,
        block_k=128, n_heads=H,
        kv_lens=None if lens is None else jnp.asarray(lens)[:, None],
        segments=None if segs is None else jnp.asarray(segs))
    want = [_h(_np(jpo._unfold_heads(w, B, H))) for w in want]
    got = (qt.grad, kt.grad, vt.grad)
    limits = tol.flash_bwd_limits(got, want, qt.detach(), kt.detach(),
                                  vt.detach(), out, lse, dot, D ** -0.5,
                                  causal=causal, lens=lt, segs=st)
    for which, g, w, lim in zip(("dq", "dk", "dv"), got, want, limits):
        assert g.dtype == torch.float16
        _assert_within(g, w, lim, f"autograd {which} {name}")


# ---------------------------------------------------------------------------
# (b) decode against the JAX decode kernel, fp16
# ---------------------------------------------------------------------------

S_MAX = 256


@pytest.mark.parametrize("length", [1, 100, 256])
def test_decode_reference_matches_jax_kernel_fp16(length, monkeypatch):
    monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PTPU_FLASH_DECODE", "1")
    rng = np.random.RandomState(length)
    q = rng.randn(B, 1, H, D).astype(np.float32)
    kc, vc = (rng.randn(B, S_MAX, H * D).astype(np.float32)
              for _ in range(2))
    assert jpo._decode_ok(_jh(q), _jh(kc), _jh(vc))
    want = jpo.flash_decode_arrays(_jh(q), _jh(kc), _jh(vc), length)
    assert want.dtype == jnp.float16
    qt, kt, vt = (_h(a) for a in (q, kc, vc))
    got = fd.flash_decode_reference(qt, kt, vt, length)
    assert got.dtype == torch.float16
    want = _h(_np(want))
    limit = tol.decode_limit(got, want, qt, kt, vt, length, D ** -0.5)
    _assert_within(got, want, limit, f"decode length {length}")


def test_decode_reference_keeps_p_fp32_in_fp16_only():
    """The plain decode rounds p to a bf16 cache's type (the TPU kernel's
    bf16 ``fast`` type) and keeps it fp32 for fp16 and fp32 caches."""
    rng = np.random.RandomState(3)
    q = rng.randn(1, 1, 1, D).astype(np.float32)
    kc, vc = (rng.randn(1, 64, D).astype(np.float32) for _ in range(2))
    for dtype, rounds in ((torch.bfloat16, True), (torch.float16, False)):
        qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, kc, vc))
        s = torch.einsum("d,kd->k", qt[0, 0, 0].float(), kt[0].float()) \
            * D ** -0.5
        p = torch.exp(s - s.max())
        if rounds:
            p = p.to(dtype).float()
        want = (p @ vt[0].float()) / torch.exp(s - s.max()).sum()
        got = fd.flash_decode_reference(qt, kt, vt, 64)
        assert torch.equal(got[0, 0, 0], want.to(dtype))


# ---------------------------------------------------------------------------
# (c) ragged on fp16 pools and int8 pools with fp16 q, against the fallback
# ---------------------------------------------------------------------------

NB, BS = 24, 16


def _ragged_inputs(seed, c=1):
    """Rows of 40, 17 and 64 keys after the write (the last a chunk of C
    queries), block 16, tables from a permutation of the pool."""
    rng = np.random.RandomState(seed)
    lens = np.array([40, 17, 64], np.int32)
    b = len(lens)
    pos0 = (lens - c).astype(np.int32)
    maxb = 4
    perm = rng.permutation(NB)
    tables = perm[:b * maxb].reshape(b, maxb).astype(np.int32)
    slots = np.stack([tables[r, (pos0[r] + np.arange(c)) // BS] * BS
                      + (pos0[r] + np.arange(c)) % BS
                      for r in range(b)]).astype(np.int32)
    q, kn, vn = (rng.randn(b, c, H, D).astype(np.float32) for _ in range(3))
    kb, vb = (rng.randn(NB, BS, H, D).astype(np.float32) for _ in range(2))
    return q, kn, vn, kb, vb, tables, pos0, lens, slots


@pytest.mark.parametrize("c", [1, 5])
def test_ragged_fp16_pools_match_jax_fallback(c):
    q, kn, vn, kb, vb, tables, pos0, lens, slots = _ragged_inputs(c, c)
    idx = [jnp.asarray(a) for a in (tables, pos0, lens, slots)]
    assert not jrpa._ragged_kernel_ok(_jh(q), _jh(kb), c, False)  # no TPU
    want, wk, wv = jrpa.ragged_paged_attention_arrays(
        _jh(q), _jh(kn), _jh(vn), _jh(kb), _jh(vb), *idx)
    assert want.dtype == jnp.float16
    qt, knt, vnt, kbt, vbt = (_h(a) for a in (q, kn, vn, kb, vb))
    ti = [torch.from_numpy(a) for a in (tables, pos0, lens, slots)]
    ops.reset_launch_counts()
    got, gk, gv = rpa.ragged_paged_attention_arrays(qt, knt, vnt, kbt, vbt,
                                                    *ti)
    assert set(ops.launch_counts().values()) == {0}
    assert torch.equal(gk, _h(_np(wk))) and torch.equal(gv, _h(_np(wv)))
    want = _h(_np(want))
    mag = rpa.ragged_paged_attention_reference(
        q=qt.float(), k_new=knt.float(), v_new=vnt.float().abs(),
        k_blocks=gk.float(), v_blocks=gv.float().abs(), block_table=ti[0],
        pos0=ti[1], kv_lens=ti[2], slots=ti[3])[0]
    limit = tol.half_limit(got, want, mag, "decode")
    _assert_within(got, want, limit, f"ragged fp16 pools C={c}")


@pytest.mark.parametrize("c", [1, 5])
def test_ragged_int8_pools_fp16_q_match_jax_fallback(c):
    q, kn, vn, _, _, tables, pos0, lens, slots = _ragged_inputs(10 + c, c)
    rng = np.random.RandomState(c)
    codes = [rng.randint(-127, 128, (NB, BS, H, D)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.rand(NB, H) * 0.005).astype(np.float32)
              for _ in range(2)]
    idx = [jnp.asarray(a) for a in (tables, pos0, lens, slots)]
    want, *wpools = jax.jit(jrpa.ragged_paged_attention_arrays)(
        _jh(q), _jh(kn), _jh(vn), jnp.asarray(codes[0]),
        jnp.asarray(codes[1]), *idx, jnp.asarray(scales[0]),
        jnp.asarray(scales[1]))
    assert want.dtype == jnp.float16
    qt, knt, vnt = (_h(a) for a in (q, kn, vn))
    ti = [torch.from_numpy(a) for a in (tables, pos0, lens, slots)]
    pools = [torch.from_numpy(a.copy()) for a in codes + scales]
    got, *gpools = rpa.ragged_paged_attention_arrays(
        qt, knt, vnt, pools[0], pools[1], *ti, pools[2], pools[3])
    for g, w in zip(gpools, wpools):
        assert torch.equal(g, torch.from_numpy(np.asarray(w)))
    assert not np.array_equal(gpools[2].numpy(), scales[0])   # they grew
    want = _h(_np(want))
    mag = rpa.folded_quant_attention(qt.float(), gpools[0], gpools[1].abs(),
                                     gpools[2], gpools[3], ti[0], ti[1],
                                     D ** -0.5)
    limit = tol.half_limit(got, want, mag, "decode")
    _assert_within(got, want, limit, f"ragged int8 pools fp16 q C={c}")


# ---------------------------------------------------------------------------
# (d) the dtype code and the gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1),
                                        (torch.float16, 2)])
def test_dtype_code(dtype, code):
    assert _build.dtype_code(dtype) == code


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8, torch.int32,
                                   "float16x"])
def test_dtype_code_refuses_other_types(dtype):
    with pytest.raises(ValueError):
        _build.dtype_code(dtype)


def test_fp16_gates_admit_fp16_and_count_nothing_on_the_cpu():
    rng = np.random.RandomState(0)
    q, k, v = (_h(rng.randn(1, 9, H, D)) for _ in range(3))
    fa._check_qkv(q, k, v)
    fd._check(q[:, :1], k.reshape(1, 9, H * D).contiguous(),
              v.reshape(1, 9, H * D).contiguous(), 9)
    ops.reset_launch_counts()
    out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    assert out.dtype == torch.float16
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="float16"):
        fa._check_qkv(q.double(), k.double(), v.double())


# ---------------------------------------------------------------------------
# (e) the fp16 kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

BK = 64


def _emulated_forward(q, k, v, scale):
    """The fp16 tensor-core forward's arithmetic, causal, in torch: exact
    fp16 products summed in fp32 per 64-key tile, the online softmax in
    fp32, p = exp(s - m) at the tile's running max rounded to fp16 for
    the P V product, l the sum of the unrounded p, out = acc / l rounded
    to fp16."""
    b, s, h, d = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, s), float("-inf"))
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, d)
    rows = torch.arange(s)[:, None]
    for k0 in range(0, s, BK):
        sc = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2) * scale
        keys = k0 + torch.arange(sc.shape[-1])[None, :]
        sc = sc.masked_fill(keys > rows, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new).nan_to_num(0.0)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.half().float() @ vf[:, :, k0:k0 + BK]
        m = m_new
    return (acc / l[..., None]).permute(0, 2, 1, 3).half()


@pytest.mark.parametrize("logit_scale", [1.0, 16.0])
def test_emulated_fp16_forward_within_the_limit(logit_scale):
    """At logit_scale 16 most probabilities of a row fall below 2^-14
    (subnormal in fp16): the limit's absolute term covers them."""
    rng = np.random.RandomState(5)
    q, k, v = (_h(rng.randn(1, 256, H, D)) for _ in range(3))
    scale = D ** -0.5 * logit_scale
    got = _emulated_forward(q, k, v, scale)
    want = fa.mha_reference(q, k, v, None, True, scale)
    limit = tol.flash_fwd_limit(got, want, q, k, v, True)
    p = torch.softmax(fa._logits(q, k, scale, True), -1)
    if logit_scale > 1:
        assert ((p > 0) & (p < 2.0 ** -14)).float().mean() > 0.25
    _assert_within(got, want, limit, f"emulated forward x{logit_scale}")


def test_emulated_fp16_backward_within_the_limit():
    """p and ds rounded to fp16 from fp32 values summed in another order
    (here: from fp64 logits and dP, rounded to fp32): within the fp16
    backward limits of the plain backward."""
    rng = np.random.RandomState(6)
    q, k, v, do = (_h(rng.randn(1, 192, H, D)) for _ in range(4))
    scale = D ** -0.5
    out, lse = fa.mha_reference(q, k, v, None, True, scale, return_lse=True)
    out = out.half()
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    s = (torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale)
    causal = torch.ones(192, 192, dtype=torch.bool).tril()
    p = torch.exp(s.float() - lse[..., None]).masked_fill(~causal, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.double(), v.double()).float()
    ds = p * (dp - fa.attention_delta(out, do)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.half().float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.half().float(), q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.half().float(), k.float()) * scale
    got = [x.half() for x in (dq, dk, dv)]
    limits = tol.flash_bwd_limits(got, want, q, k, v, out, lse, do, scale)
    for which, g, w, lim in zip(("dq", "dk", "dv"), got, want, limits):
        _assert_within(g, w, lim, f"emulated backward {which}")


def test_fp16_limit_terms():
    """The fp16 limit's terms: one fp16 step of the larger output, the
    magnitudes times coef + 2^-16, 2^-24 absolute and 2^-24 per unit of
    ``sub``."""
    out = torch.tensor([1.0, -2.0, 0.0]).half()
    want = torch.tensor([1.0, -4.0, 0.0]).half()
    mag = torch.tensor([2.0, 0.0, 0.0])
    sub = torch.tensor([0.0, 0.0, 8.0])
    lim = tol.fp16_limit(out, want, mag, tol.FP16_FLASH_FWD_COEF, sub)
    want_lim = torch.tensor([
        2.0 ** -10 + (2.0 ** -10 + 2.0 ** -16) * 2 + 2.0 ** -24,
        4 * 2.0 ** -10 + 2.0 ** -24, 2.0 ** -24 * 9])
    torch.testing.assert_close(lim, want_lim, rtol=1e-6, atol=0)
    assert torch.equal(tol.half_limit(out, want, mag, "flash_fwd", sub), lim)
