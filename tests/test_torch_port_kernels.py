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
  2^-7 max(|out|, |ref|) + 2^-8 P|V| (the ragged kernels, which do not
  round p), 2^-7 max(|out|, |ref|) + 2^-7 P|V| (the flash forward, whose
  tensor-core kernel rounds p at the running max of each key tile and the
  plain version at the final max).
- backward kernels, float32: max absolute error 1e-4 max|ref| per
  gradient (fp32 sums over up to S keys, in different orders); bfloat16:
  per element 2^-7 max(|out|, |ref|) + 2^-7 times the gradient's sum of
  magnitudes (P^T|dO|, scale W^T|Q|, scale W|K|, with W = P (|dO|.|V|^T
  + |dO|.|out|) bounding ds = P (dP - delta) and its fp32 noise).
- pool writes: bitwise; for int8 pools the codes and the scales too.
- the split-K ragged attend, fp and int8 pools: the mixes and rows at its
  edges (1, 127, 128, 129 keys, the table's full width of 1024 keys, a
  padding row, D = 128, a C > 1 chunk beside a decode row); a second fp
  launch gives the same bits and leaves the tickets at zero.
- the int8 ragged kernel's output: the forward limit above (both sides
  compute in fp32; bf16 rounds the output once).
- the masked / kv_lens flash forward: the flash forward limit above, on
  every row, left-pad rows (all keys masked) included.
- the flash forward, dQ and dK/dV run on the tensor cores in both types:
  each bf16 launch counts once more under ``:tc``, each fp32 launch
  under ``:tc32`` (split TF32: tests/test_torch_port_tc.py); a slice
  whose start or strides break the 16-byte copies raises ValueError, in
  all three kernels of both types.
- the split-K flash decode: every length from one split (1, 2) to eight
  (1000, 1024) and across the 128-key split edges (255, 256, 257), rings
  longer than the length, B 1 and 8, D 64 and 128; a second launch on the
  same buffers is bitwise equal to the first (the merge runs in split
  order) and leaves the tickets at zero.
- the variant branches of the flash kernels (segment ids, non-causal, mask
  and kv_lens, forward and backward): the forward and backward limits
  above, every row (rows the mask closes entirely too); lse and the
  masked (row max, log l) pair within 1e-4; fp32 autograd through
  `flash_attention_arrays` on the card within 1e-4 max|ref| of the same
  call on the CPU.
- LayerNorm backward: each of dx, dw, db within 1e-5 of its sum over
  term magnitudes, plus one bf16 step for a bf16 output
  (`tolerance.ln_bwd_limits`); a second launch bitwise equal; no rows,
  one row, H = 2048 and 4096 and the wide design (H = 20000); rows off 16
  bytes (H = 1002, and x, w, dy at an offset into their buffers); three
  launches bitwise equal with both merge levels, the tickets left at
  zero.
- int8 paged-KV write: codes and scales bitwise the plain version's at
  the decode step, the split edges, H = 16 D = 128 and a C = 512 chunk
  over 33 blocks.
- decode, fused decode layer, LayerNorm, FFN, float32: max absolute error
  2e-5 (FFN: 1e-5 max|ref|, sums over the intermediate); LayerNorm
  statistics 1e-5 relative.  bfloat16: one bf16 step of each output plus
  the rounding of what each side rounds (`tolerance` docstring): p for
  decode (2^-7 P|V|); xn, p and the attention output through the weights
  for the fused layer, and xn's effect on the written rows; for LayerNorm
  the fp32 noise of its terms where they cancel; h for the FFN (2^-7 |h| |W2|).  The fused layer leaves
  every ring row but row t bitwise unchanged, at t on both sides of its
  128-key split edges and at 1023, and a second launch gives the same
  bits.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _build
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


def _fwd_ok(out, want, mag, coef=tol.FWD_COEF):
    """Max error, and whether every element is within the limit of its
    dtype (module docstring); ``mag`` is P|V| and ``coef`` its
    coefficient, used in bf16 only."""
    limit = (TOL_FP32 if out.dtype == torch.float32
             else tol.bf16_limit(out, want, mag, coef))
    err, _, ok = tol.compare(out, want, limit)
    return err, ok


def _fused_qkv(b, s, h, d, dtype, seed):
    """q, k, v as slices of one fused [B, S, 3, H, D] projection, as the
    GPT block passes them."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, s, 3, h, d, generator=g).to("cuda",
                                                      dtype).unbind(2)


# S on and off the 64-row tiles; 6 (S=7) to 96 blocks, all below 132
FLASH_SHAPES = [(7, 64), (65, 64), (200, 64), (1000, 64), (130, 128),
                (129, 128), (1000, 128)]


def _flash_fwd_ok(out, want, mag):
    return _fwd_ok(out, want, mag, tol.FLASH_FWD_COEF)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", FLASH_SHAPES)
def test_flash_kernel_matches_plain(s, d, dtype):
    q, k, v = _fused_qkv(2, s, 3, d, dtype, s + d)
    fa.tc.launches = 0
    out, lse = fa.flash_attention_arrays(q, k, v, is_causal=True,
                                         return_lse=True)
    want, want_lse = fa.mha_reference(q, k, v, is_causal=True,
                                      return_lse=True)
    torch.cuda.synchronize()
    assert fa.tc.launches == int(dtype == torch.bfloat16)
    err, ok = _flash_fwd_ok(out, want, tol.flash_fwd_magnitude(q, k, v))
    assert ok, err
    assert (lse - want_lse).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", FLASH_SHAPES)
def test_flash_bwd_kernels_match_plain(s, d, dtype):
    q, k, v = _fused_qkv(2, s, 3, d, dtype, 10 * s + d)
    scale = d ** -0.5
    out, lse = fa.flash_attention_arrays(q, k, v, is_causal=True,
                                         return_lse=True)
    g = torch.Generator().manual_seed(s)
    # a strided dO: the [B, S, H, D] view of a [B, S, 2, H, D] tensor
    do = torch.randn(2, s, 2, 3, d, generator=g).to("cuda", dtype)[:, :, 1]
    delta = fa.attention_delta(out, do)
    fa.flash_bwd_dq.tc.launches = fa.flash_bwd_dkv.tc.launches = 0
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, scale)
    mags = tol.flash_bwd_magnitudes(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert (fa.flash_bwd_dq.tc.launches, fa.flash_bwd_dkv.tc.launches) == (
        bf16, bf16)
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
    out = fa.flash_attention_arrays(q, k, v, is_causal=True)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == 1 and fa.flash_bwd_dkv.launches == 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


# rows at the split-K attend's edges, block size 16: (rows, C, table
# blocks, H, D); a row: (kv_len after the write, valid queries) or None
# (padding).  One 128-key chunk and one more key, the table's full width
# (1024 keys: eight splits), a decode row beside a C > 1 chunk, and
# gpt3_1p3b's head width
SPLIT_EDGES = {
    "edges": ([(1, 1), (127, 1), (128, 1), (129, 1), (1024, 1), None], 1,
              64, 12, 64),
    "edges_d128": ([(129, 1), (1024, 1), (300, 1), None], 1, 64, 4, 128),
    "chunk_beside_decode": ([(300, 60), (129, 1), None], 60, 24, 2, 64),
}


def _edge_case(name, nb=160, bs=16, seed=5):
    """(q, k_new, v_new, tables, pos0, lens, slots, valid, qlens,
    geometry) in `mix`'s layout for a `SPLIT_EDGES` case."""
    rows, c, maxb, h, d = SPLIT_EDGES[name]
    rng = np.random.RandomState(seed)
    b = len(rows)
    tables = np.full((b, maxb), nb, np.int32)
    pos0, lens = np.zeros(b, np.int32), np.zeros(b, np.int32)
    slots = np.full((b, c), nb * bs, np.int32)
    free = list(rng.permutation(nb))
    qlens = []
    for r, row in enumerate(rows):
        if row is None:
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
    valid = [r for r, n in enumerate(qlens) if n]
    return q, kn, vn, tables, pos0, lens, slots, valid, qlens, (nb, bs, h, d)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mix_name", MIXES + sorted(SPLIT_EDGES))
def test_ragged_kernel_matches_plain(mix_name, dtype):
    """The mixes of tests/test_ragged_attention.py (D = 64) and the
    split-K edges; a second launch gives the same bits (the splits merge
    in split order) and leaves the tickets at zero."""
    if mix_name in SPLIT_EDGES:
        q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = \
            _edge_case(mix_name)
        nb, bs, H, d = geo
        rng = np.random.RandomState(2)
        b, c = q.shape[:2]
    else:
        q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = \
            mix(mix_name)
        nb, bs, H, _ = geo
        d = 64
        rng = np.random.RandomState(2)
        b, c, _, _ = q.shape
        q, kn, vn = _t(rng.randn(b, c, 3, H, d).astype(np.float32)).unbind(2)
    kb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    vb = _t(rng.randn(nb, bs, H, d).astype(np.float32))
    dev = [(_t(x) if isinstance(x, np.ndarray) else x).to("cuda", dtype)
           for x in (q, kn, vn, kb, vb)]
    idx = [_t(a).cuda() for a in (tables, pos0, lens, slots)]
    ref = [x.clone() for x in dev[3:]]
    out, k2, v2 = rpa.ragged_paged_attention_arrays(*dev, *idx)
    again, _, _ = rpa.ragged_paged_attention_arrays(*dev, *idx)
    want, k2r, v2r = rpa.ragged_paged_attention_reference(
        *dev[:3], *ref, *idx)
    # P|V|: the plain version on the widened inputs with |V| pools
    mag, _, _ = rpa.ragged_paged_attention_reference(
        dev[0].float(), dev[1].float(), dev[2].float().abs(),
        ref[0].float(), ref[1].float().abs(), *idx)
    torch.cuda.synchronize()
    assert torch.equal(k2, k2r) and torch.equal(v2, v2r)
    assert int(_build.tickets(dev[0].device, b * c * H).abs().sum()) == 0
    for b in valid:
        n = qlens[b]
        assert torch.equal(out[b, :n], again[b, :n])
        err, ok = _fwd_ok(out[b, :n], want[b, :n], mag[b, :n])
        assert ok, (mix_name, b, err)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("bad", ["start", "stride"])
def test_ragged_misaligned_new_rows_raise(bad):
    """The fp attend reads the call's own rows from k_new / v_new with
    16-byte loads: a k_new that starts off 16 bytes, or whose row stride
    is not a multiple of 16 bytes, raises ValueError naming it."""
    q, kn, vn, tables, pos0, lens, slots, _, _, geo = _edge_case("edges")
    nb, bs, h, d = geo
    dev = [_t(x).to("cuda", torch.bfloat16) for x in (q, kn, vn)]
    pools = [torch.zeros(nb, bs, h, d, dtype=torch.bfloat16, device="cuda")
             for _ in range(2)]
    idx = [_t(a).cuda() for a in (tables, pos0, lens, slots)]
    b, c = dev[1].shape[:2]
    if bad == "start":
        buf = torch.zeros(b * c * h * d + 8, dtype=torch.bfloat16,
                          device="cuda")
        odd = buf[1:1 + b * c * h * d].view(b, c, h, d)
    else:                  # row stride h*d + 2
        odd = torch.zeros(b, c * h * d + 2, dtype=torch.bfloat16,
                          device="cuda")[:, :c * h * d].view(b, c, h, d)
    odd.copy_(dev[1])
    with pytest.raises(ValueError, match="^k_new must start on 16 bytes"):
        rpa.ragged_paged_attention_arrays(dev[0], odd, dev[2], *pools, *idx)


def _int8_pools(nb, bs, h, d, seed):
    rng = np.random.RandomState(seed)
    codes = [_t(rng.randint(-127, 128, (nb, bs, h, d)).astype(np.int8))
             for _ in range(2)]
    scales = [_t((rng.rand(nb, h) * 0.02).astype(np.float32))
              for _ in range(2)]
    return codes, scales


def _chunk_case(c, pos0, bs, nb, h, d, seed):
    """One row writing C positions from pos0 (spanning several blocks,
    starting mid-block) beside one decode row and one padding row."""
    rng = np.random.RandomState(seed)
    need = -(-(pos0 + c) // bs)
    maxb = max(8, need)
    tables = np.full((3, maxb), nb, np.int32)
    ids = rng.permutation(nb)
    tables[0, :need] = ids[:need]
    tables[1, :2] = ids[need:need + 2]
    p0 = np.array([pos0, 20, 0], np.int32)
    lens = np.array([pos0 + c, 21, 0], np.int32)
    slots = np.full((3, c), nb * bs, np.int32)
    for j in range(c):
        p = pos0 + j
        slots[0, j] = tables[0, p // bs] * bs + p % bs
    slots[1, 0] = tables[1, 1] * bs + 20 % bs
    q, kn, vn = _t(rng.randn(3, c, 3, h, d).astype(np.float32)).unbind(2)
    return (q, kn, vn, tables, p0, lens, slots, [0, 1], [c, 1],
            (nb, bs, h, d))


# _chunk_case's (C, pos0, bs, nb, H, D, seed): a chunk over 4 blocks; the
# engine's C = 512 chunk from mid-block (33 blocks); a decode step at
# gpt3_1p3b's heads (H=16 D=128)
INT8_CHUNKS = {"chunk": (40, 13, 16, 24, 2, 64, 7),
               "chunk_512": (512, 13, 16, 48, 2, 64, 11),
               "decode_h16_d128": (1, 700, 16, 64, 16, 128, 12)}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MIXES + sorted(INT8_CHUNKS)
                         + sorted(SPLIT_EDGES))
def test_ragged_int8_kernel_matches_plain(case, dtype):
    if case in INT8_CHUNKS:
        q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = \
            _chunk_case(*INT8_CHUNKS[case])
    elif case in SPLIT_EDGES:
        q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = \
            _edge_case(case)
        q, kn, vn = (_t(3 * x) for x in (q, kn, vn))
    else:
        q, kn, vn, tables, pos0, lens, slots, valid, qlens, geo = mix(case)
        rng = np.random.RandomState(2)
        b, c, h, _ = q.shape
        q, kn, vn = _t(3 * rng.randn(b, c, 3, h, 64).astype(
            np.float32)).unbind(2)
        geo = geo[:3] + (64,)
    (kc, vc), (ks, vs) = _int8_pools(*geo, seed=3)
    dev = [x.to("cuda", dtype) for x in (q, kn, vn)]
    pools = [x.cuda() for x in (kc, vc, ks, vs)]
    ref = [x.clone() for x in pools]
    idx = [_t(a).cuda() for a in (tables, pos0, lens, slots)]
    rpa.int8.launches = 0
    out, *got = rpa.ragged_paged_attention_arrays(
        *dev, pools[0], pools[1], *idx, k_scales=pools[2],
        v_scales=pools[3])
    want, *wref = rpa.ragged_paged_attention_reference(
        *dev, ref[0], ref[1], *idx, ref[2], ref[3])
    # P|V|: the plain attention of the widened q over |V| codes
    mag = rpa.folded_quant_attention(
        dev[0].float(), ref[0], ref[1].abs(), ref[2], ref[3], idx[0],
        idx[1], geo[3] ** -0.5)
    torch.cuda.synchronize()
    assert rpa.int8.launches == 1 and out.dtype == dtype
    for g, w in zip(got, wref):
        assert torch.equal(g, w)
    assert not torch.equal(pools[2], ks.cuda())    # some scale grew
    for b in valid:
        n = qlens[b]
        err, ok = _fwd_ok(out[b, :n], want[b, :n], mag[b, :n])
        assert ok, (case, b, err)


def _mask_inputs(b, s, h, d, kind, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    mask = lens = None
    if kind in ("pad", "pad_lens"):
        # left pads: a [B, 1, 1, S] key-validity row, a stride-0 view
        pads = torch.tensor([0, 37, 150][:b])
        row = torch.where(torch.arange(s)[None] < pads[:, None], -1e30, 0.0)
        mask = row.cuda()[:, None, None, :].expand(b, 1, s, s)
    if kind == "full":
        mask = torch.randn(b, h, s, s, generator=g).cuda() * 2
    if kind == "bool":
        mask = (torch.rand(1, 1, s, s, generator=g) > 0.3).cuda()
        mask[..., 0] = True
    if kind in ("lens", "pad_lens"):
        lens = torch.tensor([s, s - 50, 90][:b], dtype=torch.int32).cuda()
    return q, k, v, mask, lens


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d,kind", [(3, 200, 3, 64, "pad"),
                                          (3, 200, 3, 64, "pad_lens"),
                                          (2, 130, 2, 128, "full"),
                                          (2, 96, 2, 64, "bool"),
                                          (3, 257, 2, 64, "lens"),
                                          (3, 200, 2, 128, "pad"),
                                          (3, 129, 2, 128, "pad_lens"),
                                          (2, 65, 2, 64, "full"),
                                          (2, 96, 2, 128, "bool"),
                                          (3, 257, 2, 128, "lens")])
def test_flash_masked_kernel_matches_plain(b, s, h, d, kind, dtype):
    q, k, v, mask, lens = _mask_inputs(b, s, h, d, kind, dtype, s + d)
    fa.launches = fa.masked.launches = 0
    out, lse = fa.flash_attention_arrays(q, k, v, mask, is_causal=True,
                                         kv_lens=lens, return_lse=True)
    want, want_lse = fa.mha_reference(q, k, v, is_causal=True,
                                      return_lse=True, mask=mask,
                                      kv_lens=lens)
    mag = fa.mha_reference(q.float(), k.float(), v.float().abs(),
                           is_causal=True, mask=mask, kv_lens=lens)
    torch.cuda.synchronize()
    assert (fa.launches, fa.masked.launches) == (0, 1)
    err, ok = _flash_fwd_ok(out, want, mag)            # every row
    assert ok, err
    assert (lse - want_lse).abs().max().item() <= 1e-4


def _variant_inputs(kind, b, s, h, d, dtype, seed):
    """q, k, v (slices of one fused qkv tensor), dO and the branches
    (causal, mask, kv_lens, segment ids) of a variant case: ``segs``
    sorted documents straddling the 64-row tiles in row 0 and the same ids
    permuted in row 1, causal; ``segs_nc`` the same, non-causal; ``nc``
    non-causal, Sk = s + 70; ``pad`` left-pad keys and rows (rows the mask
    closes entirely), causal; ``lens_nc`` kv_lens, non-causal; ``all``
    segments, an additive [B, H, S, S] mask and kv_lens, causal."""
    g = torch.Generator().manual_seed(seed)
    sk = s + 70 if kind == "nc" else s
    qkv = torch.randn(b, sk, 3, h, d, generator=g).to("cuda", dtype)
    q, k, v = qkv[:, :s, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    causal = kind in ("segs", "pad", "all")
    mask = lens = segs = None
    if kind in ("segs", "segs_nc", "all"):
        cuts = [0, 50, 90, 150, 171, s]
        row = torch.cat([torch.full((cuts[i + 1] - cuts[i],), i)
                         for i in range(len(cuts) - 1)])
        segs = torch.stack([row, row[torch.randperm(s, generator=g)]]
                           + [row] * (b - 2)).int().cuda()
    if kind == "pad":
        m = torch.zeros(b, 1, s, s)
        for r in range(b):
            n = 13 + 40 * r
            m[r, :, :, :n] = -1e30
            m[r, :, :n, :] = -1e30
        mask = m.cuda()
    if kind == "all":
        mask = (torch.randn(b, h, s, s, generator=g) * 2).cuda()
    if kind in ("lens_nc", "all"):
        lens = torch.tensor([s - 45 * r for r in range(b)],
                            dtype=torch.int32).cuda()
    return q, k, v, do, causal, mask, lens, segs


VARIANT_CASES = [("segs", 3, 200, 3, 64), ("segs_nc", 2, 200, 2, 64),
                 ("nc", 2, 130, 2, 64), ("pad", 2, 200, 3, 64),
                 ("lens_nc", 3, 200, 2, 128), ("all", 2, 200, 2, 64),
                 # D=128 for every branch, S on and off the tile edges
                 ("segs", 3, 257, 2, 128), ("segs_nc", 2, 256, 2, 128),
                 ("nc", 2, 65, 2, 128), ("pad", 2, 129, 2, 128),
                 ("lens_nc", 2, 65, 2, 64), ("all", 2, 1000, 2, 128)]


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,b,s,h,d", VARIANT_CASES)
def test_flash_variant_kernels_match_plain(kind, b, s, h, d, dtype):
    """The variant branches of the forward and both backward kernels
    against the plain versions, every row; each counts one launch under
    its variant."""
    q, k, v, do, causal, mask, lens, segs = _variant_inputs(
        kind, b, s, h, d, dtype, s + d)
    scale = d ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s,
                                                     k.shape[1])
    name = fa.variant_name(causal, m4, lens, segs)
    counters = [fa.segs, fa.masked, fa.noncausal,
                fa.flash_bwd_dq.variants[name],
                fa.flash_bwd_dkv.variants[name], fa.tc, fa.flash_bwd_dq.tc,
                fa.flash_bwd_dkv.tc]
    for c in counters:
        c.launches = 0
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    want, want_lse = fa.mha_reference(q, k, v, m4, causal, scale, lens,
                                      segs, return_lse=True)
    mag = tol.flash_fwd_magnitude(q, k, v, causal, m4, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    kw = dict(causal=causal, mask=m4, lens=lens, segs=segs, row_max=row_max)
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale, **kw)
    ref = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=segs, row_max=row_max)
    mags = tol.flash_bwd_magnitudes(q, k, v, out, stat, do, scale, **kw)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert [c.launches for c in counters] == [
        int(name == "segs"), int(name == "mask"), int(name == "noncausal"),
        1, 1, bf16, bf16, bf16]
    err, ok = _flash_fwd_ok(out, want, mag)
    assert ok, ("out", err)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    if pair is not None:
        pm, pl = fa.softmax_stats(q, k, scale, causal, m4, lens, segs)
        assert (pair[0] - pm).abs().max().item() <= 1e-4
        assert (pair[1] - pl).abs().max().item() <= 1e-4
    for what, got, r, mg in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, mags):
        assert got.shape == r.shape and got.dtype == dtype
        limit = (BWD_REL_FP32 * r.abs().max().item()
                 if dtype == torch.float32
                 else tol.bf16_limit(got, r, mg, tol.BWD_COEF))
        err, ratio, ok = tol.compare(got, r, limit)
        assert ok, (what, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("kind", ["segs", "nc", "pad", "lens_nc", "all"])
def test_flash_autograd_variants_match_cpu(kind):
    """fp32 gradients through `flash_attention_arrays` on the card (the
    variant kernels) against the same call on the CPU (the plain forward
    and backward), each within 1e-4 max|ref|; the card launches the
    variant forward, dQ and dK/dV once each (each also under ``:tc32``),
    the CPU nothing."""
    q, k, v, do, causal, mask, lens, segs = _variant_inputs(
        kind, 2, 200, 2, 64, torch.float32, 9)
    grads = {}
    for dev in ("cuda", "cpu"):
        qt, kt, vt = (t.detach().to(dev).requires_grad_() for t in (q, k, v))
        ops.reset_launch_counts()
        out = fa.flash_attention_arrays(
            qt, kt, vt, None if mask is None else mask.to(dev), causal,
            kv_lens=None if lens is None else lens.to(dev),
            segment_ids=None if segs is None else segs.to(dev))
        out.backward(do.to(dev))
        counts = ops.launch_counts()
        grads[dev] = [t.grad.cpu() for t in (qt, kt, vt)]
        if dev == "cpu":
            assert set(counts.values()) == {0}
        else:
            name = fa.variant_name(causal, mask, lens, segs)
            assert {n: c for n, c in counts.items() if c} == {
                f"{fa.KERNEL}:{name}": 1, f"{fa.flash_bwd_dq.KERNEL}:{name}": 1,
                f"{fa.flash_bwd_dkv.KERNEL}:{name}": 1,
                f"{fa.KERNEL}:tc32": 1, f"{fa.flash_bwd_dq.KERNEL}:tc32": 1,
                f"{fa.flash_bwd_dkv.KERNEL}:tc32": 1}
    for what, g, r in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        assert (g - r).abs().max().item() <= \
            BWD_REL_FP32 * r.abs().max().item(), what


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("bad", ["start", "stride"])
def test_flash_bf16_misaligned_slice_raises(bad):
    """The tensor-core kernels' 16-byte copies: a q, k, v or dO that
    starts off 16 bytes, or whose sequence stride is not a multiple of 16
    bytes, raises ValueError naming it, in the forward, dQ and dK/dV of
    both types (bf16 and split-TF32 fp32)."""
    b, s, h, d = 2, 65, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fused_qkv(b, s, h, d, dtype, 1)
        if bad == "start":
            buf = torch.zeros(b * s * h * d + 8, dtype=dtype, device="cuda")
            odd = buf[1:1 + b * s * h * d].view(b, s, h, d)
        else:                  # sequence stride h*d + 2
            odd = torch.zeros(b, s, h * d + 2, dtype=dtype,
                              device="cuda")[..., :h * d].unflatten(-1, (h, d))
        odd.copy_(q)
        out, lse = fa.flash_attention_arrays(q, k, v, is_causal=True,
                                             return_lse=True)
        delta = fa.attention_delta(out, q)
        calls = [("q", lambda: fa.flash_attention_arrays(odd, k, v,
                                                         is_causal=True)),
                 ("k", lambda: fa.flash_attention_arrays(q, odd, v,
                                                         is_causal=True)),
                 ("do", lambda: fa.flash_bwd_dkv(q, k, v, odd, lse, delta,
                                                 d ** -0.5)),
                 ("do", lambda: fa.flash_bwd_dq(q, k, v, odd, lse, delta,
                                                d ** -0.5)),
                 ("q", lambda: fa.flash_bwd_dq(odd, k, v, q, lse, delta,
                                               d ** -0.5))]
        for name, call in calls:
            with pytest.raises(ValueError, match=f"^{name}: .*strides"):
                call()
    torch.cuda.synchronize()


def _randn(shape, seed, dtype, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)


# one split (1, 2), the 128-key split edges (255, 256, 257), eight splits
# (1000, 1024), B 1 and 8, D 64 and 128, rings longer than the length
DECODE_CASES = [(2, 256, 3, 64, 200), (3, 384, 2, 128, 300)] + [
    (b, 1040, h, d, length) for length in (1, 2, 255, 256, 257, 1000, 1024)
    for b, h, d in ((1, 12, 64), (8, 12, 64), (1, 16, 128), (8, 16, 128))]


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s_max,h,d,length", DECODE_CASES)
def test_flash_decode_kernel_matches_plain(b, s_max, h, d, length, dtype):
    """The split-K decode against its plain version; a second launch on the
    same buffers gives the same bits (the merge runs in split order) and
    leaves the tickets at zero."""
    # q: the [B, 1, H, D] slice of a fused [B, 1, 3, H, D] projection
    q = _randn((b, 1, 3, h, d), length, dtype)[:, :, 0]
    kc = _randn((b, s_max, h * d), length + 1, dtype)
    vc = _randn((b, s_max, h * d), length + 2, dtype)
    fd.launches = 0
    out = fd.flash_decode_arrays(q, kc, vc, length)
    again = fd.flash_decode_arrays(q, kc, vc, length)
    want = fd.flash_decode_reference(q, kc, vc, length)
    torch.cuda.synchronize()
    assert fd.launches == 2 and out.dtype == dtype
    assert fd._lib().flash_decode_splits(length) == -(-length // 128)
    assert torch.equal(out, again)
    assert int(_build.tickets(q.device, b * h).abs().sum()) == 0
    limit = TOL_FP32 if dtype == torch.float32 else tol.decode_limit(
        out, want, q, kc, vc, length, d ** -0.5)
    err, ratio, ok = tol.compare(out, want, limit)
    assert ok, (err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,d,s_max,t,masked",
                         [(2, 2, 64, 256, 37, True),
                          (3, 2, 128, 384, 300, False),
                          # the split-K attention's edges at GPT-2 width:
                          # one 128-key split, two, and the full ring
                          (8, 12, 64, 1024, 1, False),
                          (8, 12, 64, 1024, 127, True),
                          (8, 12, 64, 1024, 128, False),
                          (8, 12, 64, 1024, 129, True),
                          (8, 12, 64, 1024, 1023, True),
                          # two row chunks of 8; gpt3_1p3b's heads
                          (9, 2, 64, 512, 200, True),
                          (4, 16, 128, 512, 257, False)])
def test_fused_decode_layer_kernel_matches_plain(b, h, d, s_max, t, masked,
                                                 dtype):
    """Within the limits of the module docstring; every ring row but row t
    unchanged; a second launch gives the same bits (fixed-order sums, the
    splits merged in split order) and leaves the tickets at zero."""
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
    again, _, _ = fdl.fused_decode_layer_arrays(*args, kc, vc, t, h,
                                                cache_mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    assert int(_build.tickets(x.device, 1).abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,hidden", [(8, 768), (100, 1000), (37, 1002),
                                      (16, 4096), (8192, 768)])
def test_layernorm_kernel_matches_plain(n, hidden, offset, xdt, pdt):
    """Rows read once into registers: widths whose rows fall into 16-byte
    chunks (768, 1000 in bf16, 4096) and one whose rows do not (1002: a
    scalar head and tail, alternating with the row), and x and w based
    one element past 16 bytes (``offset``)."""
    x = (_randn((n * hidden + offset,), n, xdt, 2.0) + 0.5)[offset:]
    x = x.view(n, hidden)
    w = (1 + _randn((hidden + offset,), n + 1, pdt, 0.1))[offset:]
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


# (n, H, I): the decode step, a few rows of a narrow model, the tensor-core
# and CUDA-core shapes of a narrow and of GPT-2's MLP, the training rows
FFN_SHAPES = [(8, 768, 3072), (40, 128, 256), (512, 256, 512),
              (256, 768, 3072), (8192, 768, 3072)]


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("n,hidden,inter", FFN_SHAPES)
def test_ffn_kernel_matches_plain(n, hidden, inter, act, dtype):
    """Each design (`ffn_design`: decode rows, the tensor cores for bf16,
    split TF32 on the tensor cores for fp32) within its limit, both
    launches counted under it alone, a second launch bitwise the first."""
    x = _randn((n, hidden), n, dtype)
    w1 = _randn((hidden, inter), n + 1, dtype, hidden ** -0.5)
    b1 = _randn((inter,), n + 2, dtype, 0.1)
    w2 = _randn((inter, hidden), n + 3, dtype, inter ** -0.5)
    design = fm.ffn_design(n, hidden, inter, dtype)
    counter = {"tc": fm.ffn_tc, "tc32": fm.ffn_tc32, "decode": fm.ffn_decode,
               "cuda_core": fm.ffn_fwd}[design]
    ops.reset_launch_counts()
    y = fm.fused_ffn_arrays(x, w1, b1, w2, act)
    y2 = fm.fused_ffn_arrays(x, w1, b1, w2, act)   # tickets were reset
    yr = fm.fused_ffn_reference(x, w1, b1, w2, act)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        counter.KERNEL: 2}
    assert torch.equal(y, y2)
    limit = (1e-5 * yr.float().abs().max().item() if dtype == torch.float32
             else tol.ffn_limit(x, w1, b1, w2, act))
    err, ratio, ok = tol.compare(y, yr, limit)
    assert ok, (design, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("n", [8, 512])
@pytest.mark.parametrize("bad", ["x", "w1", "b1", "w2"])
def test_ffn_misaligned_slice_raises(bad, n):
    """The decode and tensor-core designs load 16 bytes at a time: an
    operand that starts off 16 bytes raises ValueError naming it, in bf16
    and fp32 (8 rows: the decode design; 512: the tensor cores, split
    TF32 in fp32); the CUDA-core design would take it."""
    hidden, inter = 256, 512
    for dtype in (torch.bfloat16, torch.float32):
        shapes = {"x": (n, hidden), "w1": (hidden, inter), "b1": (inter,),
                  "w2": (inter, hidden)}
        args = {}
        for i, (name, shape) in enumerate(shapes.items()):
            numel = int(np.prod(shape))
            buf = _randn((numel + 8,), i, dtype, 0.05)
            start = 1 if name == bad else 0
            args[name] = buf[start:start + numel].view(shape)
        design = fm.ffn_design(n, hidden, inter, dtype)
        call = lambda: fm.fused_ffn_arrays(*args.values(), "gelu")  # noqa
        if design == "cuda_core":
            call()
        else:
            with pytest.raises(ValueError, match=f"{bad} must start on 16"):
                call()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,hidden", [(8, 768), (200, 768), (8192, 768),
                                      (100, 1000), (300, 4096), (64, 1002),
                                      (0, 768), (1, 768), (1, 1002),
                                      (333, 2048), (40, 20000)])
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
    assert fm.ln_bwd.launches == (2 if n else 0)   # none for no rows
    assert [g.dtype for g in got] == [xdt, pdt, pdt]
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # no atomics
    limits = tol.ln_bwd_limits(got, want, x, w, mu, rs, dy)
    for name, g, r, lim in zip(("dx", "dw", "db"), got, want, limits):
        if not g.numel():                           # dx of no rows
            continue
        err, ratio, ok = tol.compare(g, r, lim)
        assert ok, (name, err, ratio)


def _offset(t, k):
    """t's values in a contiguous tensor whose storage starts k elements
    into its buffer (rows off 16 bytes where k * itemsize is not)."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("xdt,pdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,hidden,k", [(100, 768, 1), (77, 1002, 3),
                                        (5000, 768, 2)])
def test_layernorm_bwd_kernel_offset_rows(n, hidden, k, xdt, pdt):
    """x, dy and w at k elements into their buffers: every row starts off
    16 bytes, so each takes a scalar head and tail (and dy, w the scalar
    loads of chunks off 16 bytes); within the limits of the aligned
    test, bitwise on a second launch."""
    x = _offset(_randn((n, hidden), 5, xdt, 2.0) + 0.5, k)
    w = _offset(1 + _randn((hidden,), 6, pdt, 0.1), k)
    b = _randn((hidden,), 7, pdt, 0.1)
    dy = _offset(_randn((n, hidden), 8, torch.promote_types(xdt, pdt)), k)
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    got = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    again = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    want = fm.fused_layernorm_bwd_reference(x, w, mu, rs, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    limits = tol.ln_bwd_limits(got, want, x, w, mu, rs, dy)
    for name, g, r, lim in zip(("dx", "dw", "db"), got, want, limits):
        err, ratio, ok = tol.compare(g, r, lim)
        assert ok, (name, err, ratio)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("n", [8192, 65536])
def test_layernorm_bwd_kernel_deterministic(n):
    """At the most blocks the plan takes (both merge levels), three
    launches give the same bits and leave the tickets at zero."""
    x = _randn((n, 768), 1, torch.bfloat16, 2.0)
    w = 1 + _randn((768,), 2, torch.bfloat16, 0.1)
    b = _randn((768,), 3, torch.bfloat16, 0.1)
    dy = _randn((n, 768), 4, torch.bfloat16)
    _, mu, rs = fm.fused_layernorm_reference(x, w, b)
    plan = fm.ln_bwd_plan(n, 768, x.dtype, _build.sms(x.device))
    assert plan.groups > 1
    first = fm.fused_layernorm_bwd(x, w, mu, rs, dy)
    for _ in range(2):
        assert all(torch.equal(a, c) for a, c in zip(
            first, fm.fused_layernorm_bwd(x, w, mu, rs, dy)))
    assert not _build.tickets(x.device, plan.groups + 1).any()


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
        ops.reset_launch_counts()
        h = fm.fused_layernorm_arrays(x, lw, lb)
        fm.fused_ffn_arrays(h, w1, b1, w2, "gelu_tanh").backward(dy.to(dev))
        launched = (fm.ln_fwd.launches, fm.ln_bwd.launches,
                    fm.ffn_fwd.launches + fm.ffn_tc.launches
                    + fm.ffn_tc32.launches + fm.ffn_decode.launches)
        assert launched == ((1, 1, 1) if dev == "cuda" else (0, 0, 0))
        grads[dev] = [t.grad.cpu() for t in (x, lw, lb, w1, b1, w2)]
    for name, g, r in zip(("dx", "dlw", "dlb", "dw1", "db1", "dw2"),
                          grads["cuda"], grads["cpu"]):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item(), \
            name


# ---------------------------------------------------------------------------
# the FFN's and the LayerNorm forward's launch geometry, on the CPU
# ---------------------------------------------------------------------------

# the design of each row count at GPT-2's MLP (H 768, I 3072), as measured
# on the H100: bf16 takes the tensor cores from 24 rows, fp32 the decode
# design up to 64 rows and the split-TF32 tensor cores above
FFN_DESIGNS = {
    torch.bfloat16: {8: "decode", 16: "decode", 24: "tc", 40: "tc",
                     64: "tc", 256: "tc", 512: "tc", 1024: "tc",
                     8192: "tc", 65536: "tc"},
    torch.float32: {8: "decode", 16: "decode", 24: "decode", 40: "decode",
                    64: "decode", 256: "tc32", 512: "tc32", 1024: "tc32",
                    8192: "tc32", 65536: "tc32"}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 16, 24, 40, 64, 256, 512, 1024, 8192,
                               65536])
def test_ffn_design_picks(n, dtype):
    """Decode rows (8: the fused-mode generate step) take the decode
    design in both types; training rows (1024 and 8192) take the tensor
    cores in both, fp32 as split TF32 (as accurate as fp32 products);
    no width of 128s takes the CUDA-core design."""
    assert fm.ffn_design(n, 768, 3072, dtype) == FFN_DESIGNS[dtype][n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,i,h2", [(768, 3000, 768), (700, 3072, 768),
                                    (768, 3072, 720)])
def test_ffn_design_widths_off_128_take_cuda_cores(h, i, h2, dtype):
    """Widths the decode and tensor-core designs do not take (not
    multiples of 128) go to the CUDA-core kernel, at any row count."""
    for n in (8, 8192):
        assert fm.ffn_design(n, h, i, dtype, h2) == "cuda_core"


@pytest.mark.parametrize("n", [64, 200, 256, 512, 1024, 8192])
@pytest.mark.parametrize("i,h2", [(3072, 768), (512, 256), (4096, 1024)])
def test_ffn_tc_tiles_divide_the_widths(n, i, h2):
    """Each product's tile (warpgroups, BN) is one the kernel has and BN
    divides its width, on an H100's 132 SMs and on a card of 78."""
    for sms in (132, 78):
        for (wgs, bn), width in zip(fm.ffn_tc_tiles(n, i, h2, sms),
                                    (i, h2)):
            assert (wgs, bn) in fm._TC_TILES and width % bn == 0


@pytest.mark.parametrize("n,first,second", [
    (256, (1, 128), (1, 128)), (512, (2, 128), (1, 128)),
    (1024, (2, 256), (1, 128)), (8192, (2, 256), (2, 128))])
def test_ffn_tc_tiles_at_gpt2_width(n, first, second):
    """At GPT-2's MLP (I 3072, H 768) the picker takes the tiles that
    measured fastest on the H100 for each product."""
    assert fm.ffn_tc_tiles(n, 3072, 768) == (first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,cols", [(8, 768, 3072), (8, 3072, 768),
                                      (40, 128, 256), (64, 4096, 1024)])
def test_ffn_decode_loads_divide_the_rows(n, k, cols, dtype):
    """The decode design's k-chunks (32 rows a load) divide the weight's
    rows; at GPT-2 width and 8 rows both products fill the 132 SMs."""
    loads = fm.ffn_decode_loads(n, k, cols, dtype)
    assert loads in (4, 8, 16) and k % (32 * loads) == 0
    cw = 64 if dtype == torch.bfloat16 else 32
    blocks = -(-n // 8) * (cols // cw) * (k // (32 * loads))
    if (n, k) in ((8, 768), (8, 3072)):
        assert blocks >= 132
    with pytest.raises(ValueError, match="multiple of 128"):
        fm.ffn_decode_loads(n, 100, cols, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,i,h2", [(8, 768, 3072, 768), (16, 128, 256, 128),
                                      (512, 768, 3072, 768),
                                      (64, 4096, 1024, 4096)])
def test_ffn_decode_plan_lays_out_the_scratch(n, h, i, h2, dtype):
    """The decode design's kept scratch holds h [n, i] in x's type and
    the fp32 partials of each k-chunk of both products, apart and each
    from a 256-byte boundary; the tickets cover every column slice of
    both products."""
    l1, l2, off1, off2, size, tickets = fm._decode_plan(n, h, i, h2, dtype,
                                                        132)
    item = 2 if dtype == torch.bfloat16 else 4
    assert (l1, l2) == (fm.ffn_decode_loads(n, h, i, dtype),
                        fm.ffn_decode_loads(n, i, h2, dtype))
    assert off1 % 256 == 0 and off2 % 256 == 0
    assert off1 >= n * i * item
    assert off2 - off1 >= h // (32 * l1) * n * i * 4
    assert size - off2 >= i // (32 * l2) * n * h2 * 4
    cw = 128 // item
    assert tickets == -(-n // 8) * (i // cw + h2 // cw)


@pytest.mark.parametrize("sms,loads,first_256", [
    (78, 8, (2, 128)), (132, 8, (1, 128)), (200, 4, (1, 128)),
    (264, 4, (1, 128))])
def test_ffn_pickers_follow_the_sm_count(sms, loads, first_256):
    """The pickers fill the card they are given: with more SMs the decode
    design takes fewer loads a thread (more, shorter k-chunks) at the
    bf16 decode step of GPT-2's MLP, still a full wave; with fewer, the
    tensor-core design's first product at 256 rows takes taller tiles."""
    for k, cols in ((768, 3072), (3072, 768)):
        got = fm.ffn_decode_loads(8, k, cols, torch.bfloat16, sms)
        assert got == loads and (cols // 64) * (k // (32 * got)) >= sms
    assert fm.ffn_tc_tiles(256, 3072, 768, sms)[0] == first_256
