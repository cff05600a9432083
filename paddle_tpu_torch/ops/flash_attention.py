"""Flash attention — the port of the flash part of
`paddle_tpu/ops/pallas_ops.py`, forward and backward, with every branch of
its three kernels: causal or not, an additive (or bool) mask, ``kv_lens``
and packed ``segment_ids``.

`flash_attention_arrays` launches the CUDA kernels of
``csrc/flash_fwd_causal.cu`` on a CUDA tensor and computes `mha_reference`
(the plain version, `pallas_ops.py:73`) on a CPU tensor.  Under autograd it
goes through `FlashAttention`, the counterpart of `_flash_attn_core`'s
custom_vjp (`pallas_ops.py:678-732`): the forward saves its softmax
statistics, and the backward launches the two kernels of
``csrc/flash_bwd_causal.cu`` (`flash_bwd_dq`, then `flash_bwd_dkv`, as
`_flash_bwd` does) on CUDA tensors, or computes
`flash_attention_bwd_reference` on CPU tensors.  Layout
``[batch, seq, heads, head_dim]``, as in the JAX package.

Each source has one entry per kernel, which picks the template
instantiation (``MASKED`` for a mask and / or ``kv_lens``, ``SEGS``,
``CAUSAL``) from the branches it is given, and the design from the type,
passed as a code (`_build.dtype_code`): in bfloat16 and float16 all three
run on the tensor cores (``wgmma``, ``csrc/flash_tc.cuh``; one template,
instantiated per 16-bit type, p and ds rounded to that type as the TPU
kernels round them); in float32 all three run on the tensor cores
too, each fp32 product as three TF32 products of the operands' hi and lo
parts (split TF32, as accurate as fp32 products: ``flash_tc.cuh``).
Each wrapper counts
the causal launches with no mask, ``kv_lens`` or segments (the serving
prefill and unpacked training) under the kernel's name, and the others
apart, by the first of: ``segs`` (any call with segment ids), ``mask`` (a
mask or ``kv_lens``), ``noncausal``.  The tensor-core launches are counted
once more, apart, any branch: bfloat16 under ``flash_fwd_causal:tc``,
``flash_bwd_dq_causal:tc`` and ``flash_bwd_dkv_causal:tc``, float16 under
``:tc16`` and float32 under ``:tc32`` of the same names.

Head dims: the forward and the backward take 64, 128, 256 (Gemma 2B's
and GPT-J's head size) and every larger multiple of 128, the head dims
JAX's flash gate admits (`pallas_ops.py:646`); any other raises the
gate's ValueError before a launch.  A launch at 256 counts once more
under ``flash_fwd_causal:d256``, ``flash_bwd_dq_causal:d256`` or
``flash_bwd_dkv_causal:d256``; in float32 the three run on the CUDA cores
there (``flash_fwd_simt_kernel``, ``flash_bwd_dq_simt_kernel``,
``flash_bwd_dkv_simt_kernel``: split TF32 does not fit a block) and count
under ``:simt`` of their names in place of ``:tc32``.  In bfloat16 and
float16 the dK/dV kernel at 256 is two warpgroups a block, each owning
half of dK's and dV's columns.  D = 384, 512, ... (`kernel_route`): in
bfloat16 and float16 up to ``WIDE_TC_MAX_D`` (1024) the forward and dK/dV
run on the tensor cores (``csrc/flash_wide_tc.cu``, entries
``flash_wide_tc_fwd`` and ``flash_wide_tc_dkv``: a cluster of D / 128
blocks, each owning 128 columns, the scores' parts summed across the
cluster); float32 at every such D, 16-bit past 1024, and dQ in every type
take the CUDA-core kernels of ``csrc/flash_wide_fwd.cu`` (entry
``flash_wide_fwd``) and ``csrc/flash_wide_bwd.cu`` (``flash_wide_dq``,
``flash_wide_dkv``: D a runtime argument, a grid axis of D / 128 output
slices).  Their launches count under the base and branch counters as
any other, under ``:wide`` of the kernel's name (every launch at such a
D, in place of the type's counter: ``flash_fwd_causal:wide``,
``flash_bwd_dq_causal:wide``, ``flash_bwd_dkv_causal:wide``) and, the
tensor-core ones, once more under ``:wide_tc`` (``flash_fwd_causal:wide_tc``,
``flash_bwd_dkv_causal:wide_tc``).

The kernels copy 16-byte rows: on the card q, k, v (and dO) must start on
16 bytes, with batch and sequence strides of a multiple of 16 bytes (8
bfloat16 or float16, or 4 float32 elements; the slices of a fused
``[B, S, 3, H, D]`` projection are); anything else raises.

The softmax statistic the backward reads is the logsumexp, except with a
mask or ``kv_lens``: there it is the pair (row max ``m``, ``log l``), which
the masked forward always writes, since
a row whose every key the mask closes has ``m`` ~ -1e30, where
``lse = m + log l`` rounds ``log l`` away in fp32.  With the pair the
backward rebuilds the probabilities the forward used, so it is the
derivative of the port's own forward on every row (JAX's kernels read lse
and rebuild ``exp(0) = 1`` in place of ``1/n`` on such a row).
"""
from __future__ import annotations

import collections
import ctypes
import math
import os

import torch

from . import _build

__all__ = ["flash_attention_arrays", "mha_reference", "FlashAttention",
           "flash_attention_bwd_reference", "softmax_stats",
           "recompute_probs",
           "attention_delta", "flash_bwd_dq", "flash_bwd_dkv", "masked",
           "segs", "noncausal", "d256", "simt", "wide", "wide_tc",
           "normalize_mask", "head_dim_ok", "kernel_route",
           "variant_name", "count_path", "attention_path_counts",
           "reset_attention_path_counts"]

KERNEL = "flash_fwd_causal"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
BWD_SOURCE = "flash_bwd_causal"
# the kernels at head_dim 384, 512, ... (every multiple of 128 past 256):
# on the CUDA cores, and in bf16 / fp16 up to WIDE_TC_MAX_D on the tensor
# cores (a cluster of D / 128 blocks; 8, the portable cluster size, at most)
WIDE_SOURCE = "flash_wide_fwd"
WIDE_BWD_SOURCE = "flash_wide_bwd"
WIDE_TC_SOURCE = "flash_wide_tc"
WIDE_TC_MAX_D = 1024
launches = 0          # causal (no mask, kv_lens or segments) launches

_NEG_INF = -1e30
VARIANTS = ("mask", "segs", "noncausal")

# the attention paths taken, counted under PTPU_ATTN_DEBUG=1 as JAX counts
# them (`pallas_ops.py:45-59`); the port counts its one fallback,
# "attn_fallback:head_dim" (`nn.functional.flash_attention`)
_PATH_COUNTS = collections.Counter()


def count_path(name):
    if os.environ.get("PTPU_ATTN_DEBUG") == "1":
        _PATH_COUNTS[name] += 1


def attention_path_counts():
    """{path name: calls} since the last reset, under PTPU_ATTN_DEBUG=1."""
    return dict(_PATH_COUNTS)


def reset_attention_path_counts():
    _PATH_COUNTS.clear()


# the variants' counters (module docstring); by type: bf16 and fp16 the
# tensor-core kernel, fp32 the split-TF32 one
masked = _build.Counter(KERNEL + ":mask", SOURCE)
segs = _build.Counter(KERNEL + ":segs", SOURCE)
noncausal = _build.Counter(KERNEL + ":noncausal", SOURCE)
tc = _build.Counter(KERNEL + ":tc", SOURCE)
tc16 = _build.Counter(KERNEL + ":tc16", SOURCE)
tc32 = _build.Counter(KERNEL + ":tc32", SOURCE)
# forward launches at head_dim 256 (any type), and the float32 ones among
# them (the CUDA-core kernel, counted here in place of ``tc32``)
d256 = _build.Counter(KERNEL + ":d256", SOURCE)
simt = _build.Counter(KERNEL + ":simt", SOURCE)
# forward launches at head_dim 384, 512, ... (any type; counted in place of
# the type's counter), and the tensor-core ones among them
wide = _build.Counter(KERNEL + ":wide", WIDE_SOURCE)
wide_tc = _build.Counter(KERNEL + ":wide_tc", WIDE_TC_SOURCE)
_FWD_VARIANTS = {"mask": masked, "segs": segs, "noncausal": noncausal}
# the counter suffix of each type the kernels take
_TYPE_SUFFIX = {torch.bfloat16: "tc", torch.float16: "tc16",
                torch.float32: "tc32"}
# every design counter of the forward, by its suffix (`kernel_route`)
_FWD_DESIGNS = {"tc": tc, "tc16": tc16, "tc32": tc32, "d256": d256,
                "simt": simt, "wide": wide, "wide_tc": wide_tc}


def variant_name(is_causal, mask, kv_lens, segment_ids):
    """The counter a launch with these branches counts under: ``segs``,
    ``mask`` (a mask or kv_lens), ``noncausal``, or None (the causal
    entry)."""
    if segment_ids is not None:
        return "segs"
    if mask is not None or kv_lens is not None:
        return "mask"
    return None if is_causal else "noncausal"


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracle
# ---------------------------------------------------------------------------

def mha_reference(q, k, v, mask=None, is_causal=False, scale=None,
                  kv_lens=None, segment_ids=None, *, return_lse=False):
    """q, k, v: [B, S, H, D] -> [B, Sq, H, D] in v's dtype, in the JAX
    argument order.  fp32 logits (einsum of the operands widened to fp32,
    as JAX's ``preferred_element_type=float32``), fp32 softmax, probs cast
    to v's dtype.  With ``return_lse`` also the fp32 logsumexp [B, H, Sq].

    ``mask``: additive float or bool (True attends) [Sq, Sk], [B, Sq, Sk]
    or [Bm, Hm, Sq, Sk]; ``kv_lens``: [B] valid key counts (>= 1);
    ``segment_ids``: [B, S] int ids (self-attention): a pair attends iff
    its ids match.  Causal aligns at the end (query i sees keys <=
    i + Sk - Sq).  In the JAX order (`pallas_ops.py:73-103`): the scaled
    logits plus the mask (fp32; a bool mask as 0 / -1e30); keys that
    causal, ``kv_lens`` or the ids exclude carry no weight (-1e30, or -inf
    where a mask or kv_lens is given).  Wherever a row keeps a key the mask
    leaves open this is the JAX reference's arithmetic bit for bit.  A row
    whose every allowed key the mask closes (a left-pad query) takes the
    uniform softmax over its allowed keys, as the kernel computes it;
    JAX's reference spreads such a row over the excluded keys too and its
    TPU kernel over whole key tiles.  No real token reads such a row.  A
    row with no allowed key at all (segment ids with kv_lens can make one)
    is unspecified, as in JAX; here it is zeros."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = _logits(q, k, scale, is_causal, mask, kv_lens, segment_ids)
    probs = torch.softmax(logits, dim=-1)
    if kv_lens is not None and segment_ids is not None:
        probs = probs.nan_to_num(0.0)           # rows with no allowed key
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _logits(q, k, scale, is_causal, mask=None, kv_lens=None,
            segment_ids=None):
    """fp32 [B, H, Sq, Sk]: the scaled logits plus the mask, with the keys
    that causal, kv_lens or the segment ids exclude at -1e30 (-inf where a
    mask or kv_lens is given, so that any finite mask value stays exact)."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + normalize_mask(mask, b, h, sq, sk)
    allowed = None
    if is_causal:
        allowed = torch.ones((1, 1, sq, sk), dtype=torch.bool,
                             device=q.device).tril(sk - sq)
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, device=q.device).reshape(b, 1, 1, 1)
        valid = torch.arange(sk, device=q.device) < lens
        allowed = valid if allowed is None else allowed & valid
    if segment_ids is not None:
        ids = torch.as_tensor(segment_ids, device=q.device)
        same = (ids[:, None, :, None] == ids[:, None, None, :])
        allowed = same if allowed is None else allowed & same
    if allowed is None:
        return logits
    fill = (float("-inf") if mask is not None or kv_lens is not None
            else _NEG_INF)
    return logits.masked_fill(~allowed, fill)


def softmax_stats(q, k, scale, is_causal, mask=None, kv_lens=None,
                  segment_ids=None):
    """(row max m, log l), each fp32 [B, H, Sq]: the softmax statistics
    the masked backward reads (module docstring); ``m + log l`` is the
    logsumexp."""
    logits = _logits(q, k, scale, is_causal, mask, kv_lens, segment_ids)
    m = logits.amax(-1)
    return m, torch.exp(logits - m[..., None]).sum(-1).log()


def _key_mask_view(m, b, h, sq, sk):
    """A mask one row of which serves every query, [..., 1, Sk], as 4-D
    the way the JAX reference broadcasts it against [B, H, Sq, Sk]
    (leading 1s), or None unless it is [Bm, Hm, 1, Sk] with Bm in {1, B},
    Hm in {1, H}."""
    if m.dim() > 4 or m.dim() < 2 or tuple(m.shape[-2:]) != (1, sk):
        return None
    m = m.reshape((1,) * (4 - m.dim()) + tuple(m.shape))
    return m if m.shape[0] in (1, b) and m.shape[1] in (1, h) else None


def normalize_mask(attn_mask, b, h, sq, sk):
    """A 2-, 3- or 4-D bool or additive mask as an additive fp32
    [B, H, Sq, Sk] view (`_normalize_mask`, `pallas_ops.py:735-748`):
    broadcast dims keep stride 0, so nothing is copied but a bool or
    non-fp32 mask's conversion.  Takes what JAX's kernel gate takes
    (`_mask_shape_ok`, `:628-637`: [Sq, Sk], [B, Sq, Sk], [Bm, Hm, Sq, Sk]
    with Bm in {1, B}, Hm in {1, H}) and, as a stride-0 view over the
    queries, a key mask [Bm, Hm, 1, Sk] (BERT's padding mask; 2- and 3-D
    forms broadcast as the JAX reference broadcasts them, leading 1s),
    which JAX's gate sends to `mha_reference`; raises on anything else."""
    m = attn_mask
    if m.dim() == 2:
        m = m[None, None]
    elif m.dim() == 3:
        m = m[:, None]
    if m.dim() != 4 or tuple(m.shape[2:]) != (sq, sk) \
            or m.shape[0] not in (1, b) or m.shape[1] not in (1, h):
        m = _key_mask_view(attn_mask, b, h, sq, sk)
    if m is None:
        raise ValueError(f"attn_mask must be [Sq, Sk], [B, Sq, Sk], "
                         f"[Bm, Hm, Sq, Sk] or [Bm, Hm, 1, Sk] with Bm in "
                         f"(1, {b}), Hm in (1, {h}), Sq={sq}, Sk={sk}; got "
                         f"{tuple(attn_mask.shape)}")
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, _NEG_INF)
    elif m.dtype != torch.float32:
        m = m.float()
    return m.expand(b, h, sq, sk)


def attention_delta(out, do):
    """``rowsum(float(dO) * float(out))`` as a contiguous fp32 [B, H, Sq]:
    the ``delta`` of `_flash_bwd` (`pallas_ops.py:548-549`), formed from
    the STORED output (bf16 in a bf16 run)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(),
                        out.float()).contiguous()


def recompute_probs(q, k, scale, lse, causal=True, mask=None, lens=None,
                    segs=None, row_max=None):
    """fp32 [B, H, Sq, Sk] probabilities rebuilt from the forward's
    statistic, as the backward kernels rebuild them: ``exp(s - lse)``, or
    with ``row_max`` (masked calls, where ``lse`` holds log l)
    ``exp((s - m) - log l)``."""
    logits = _logits(q, k, scale, causal, mask, lens, segs)
    if row_max is None:
        return torch.exp(logits - lse[..., None])
    p = torch.exp(logits - row_max[..., None] - lse[..., None])
    if lens is not None and segs is not None:
        p = p.nan_to_num(0.0)                   # rows with no allowed key
    return p


def _bwd_plain(q, k, v, do, lse, delta, scale, causal=True, mask=None,
               lens=None, segs=None, row_max=None):
    """The explicit recompute formula of the two backward kernels, with
    their rounding points: p rounded to dO's dtype before the dV product,
    ds to q's dtype before the dK product and to k's before the dQ product
    (`pallas_ops.py:251`, `:313-316`); all products accumulate in fp32;
    p from `recompute_probs`."""
    p = recompute_probs(q, k, scale, lse, causal, mask, lens, segs, row_max)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, scale, *,
                                  is_causal=True, mask=None, kv_lens=None,
                                  segment_ids=None, row_max=None):
    """Plain flash backward: (dq, dk, dv) in the inputs' dtypes from q, k,
    v [B, S, H, D], the forward's stored ``out``, its fp32 statistic
    ``lse`` [B, H, Sq] and the output gradient ``do``.  Recomputes
    ``p = exp(s * scale - lse)`` rather than differentiating the forward,
    as `_flash_bwd` does (`pallas_ops.py:524-625`).  With a mask or
    kv_lens pass ``row_max`` and ``lse`` = log l (`softmax_stats`):
    ``p = exp((s - m) - log l)``.  Causal unless ``is_causal=False``, as
    the kernels it mirrors."""
    return _bwd_plain(q, k, v, do, lse, attention_delta(out, do), scale,
                      is_causal, mask, kv_lens, segment_ids, row_max)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def head_dim_ok(d):
    """The flash gate's head dims: 64, 128, 256 and every larger multiple
    of 128, as JAX's (`pallas_ops.py:646`).  The decode kernels take only
    `_build.HEAD_DIMS`."""
    return d in _build.HEAD_DIMS or (d > 0 and d % 128 == 0)


def kernel_route(kind, d, dtype):
    """``(source, entry, designs)`` of the kernel a launch of ``kind``
    ("fwd", "dq" or "dkv") takes at head_dim ``d`` in ``dtype``: the
    ``csrc/<source>.cu`` library, its C entry, and the suffixes of the
    counters the launch counts under besides its branch counter (module
    docstring): the type's (``tc``, ``tc16``, ``tc32``) or, at 256 in
    float32, ``simt``, with ``d256`` at 256; ``wide`` past 256, and
    ``wide_tc`` for the tensor-core wide kernels (forward and dK/dV in
    bfloat16 and float16 up to `WIDE_TC_MAX_D`).  Decided by shape and
    type alone, before a launch."""
    if d in _build.HEAD_DIMS:
        source = SOURCE if kind == "fwd" else BWD_SOURCE
        entry = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
        if d != 256:
            return source, entry, (_TYPE_SUFFIX[dtype],)
        return source, entry, ("d256", "simt" if dtype == torch.float32
                               else _TYPE_SUFFIX[dtype])
    if (kind != "dq" and dtype in (torch.bfloat16, torch.float16)
            and d <= WIDE_TC_MAX_D):
        return WIDE_TC_SOURCE, f"flash_wide_tc_{kind}", ("wide", "wide_tc")
    return (WIDE_SOURCE if kind == "fwd" else WIDE_BWD_SOURCE,
            f"flash_wide_{kind}", ("wide",))


def _check_qkv(q, k, v, causal=True):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, D], got "
                             f"{tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share one device and dtype")
        if not _head_layout(t):
            raise ValueError(f"{name} needs unit stride in D and stride D "
                             f"between heads, got strides {t.stride()}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _TYPE_SUFFIX:
        raise ValueError(f"kernel takes float32, bfloat16 or float16, got "
                         f"{q.dtype}")
    if not head_dim_ok(d):
        raise ValueError(f"kernel takes head_dim "
                         f"{', '.join(map(str, _build.HEAD_DIMS))} or a "
                         f"larger multiple of 128, got {d}")
    if causal and k.shape[1] < sq:
        raise ValueError("causal attention needs Sk >= Sq")
    if q.is_cuda:
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_aligned(name, t)


def _aligned(t):
    """What the 16-byte copies of the kernels need: a
    16-byte-aligned start, and batch and sequence strides of a multiple of
    16 bytes (a dimension of size 1 takes any stride)."""
    return t.data_ptr() % 16 == 0 and all(
        t.shape[i] == 1 or t.stride(i) * t.element_size() % 16 == 0
        for i in (0, 1))


def _check_aligned(name, t):
    if not _aligned(t):
        raise ValueError(
            f"{name}: the flash kernels need a 16-byte-aligned start "
            f"and batch and sequence strides of a multiple of 16 bytes "
            f"({16 // t.element_size()} {t.dtype} elements); got strides "
            f"{t.stride()}, start at {t.data_ptr() % 16} bytes past 16")


def _head_layout(t):
    """Unit stride in D and stride D between heads: the layout the kernels
    index with only batch and sequence strides."""
    return t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == t.shape[3])


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _bind(fn, n_ptr, n_int, n_ll):
    """Set ctypes argument types once: pointers, ints, long longs, then the
    float scale and the stream."""
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * n_ptr + [i] * n_int + [ll] * n_ll \
            + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _branch_args(q, causal, mask, lens, sid):
    """Checked pointers and strides of the branches: ``mask`` an fp32
    [B, H, Sq, Sk] view or None, ``lens`` an int32 [B] or None, ``sid`` an
    int32 [B, S] with unit stride in S or None."""
    for name, t in (("attn_mask", mask), ("kv_lens", lens),
                    ("segment_ids", sid)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if lens is not None and not lens.is_contiguous():
        raise ValueError("kv_lens must be contiguous")
    if sid is not None and sid.stride(1) != 1:
        raise ValueError("segment_ids needs unit stride in S")
    mstrides = mask.stride() if mask is not None else (0, 0, 0, 0)
    ptrs = [0 if t is None else t.data_ptr() for t in (mask, lens, sid)]
    return ptrs, [*mstrides, 0 if sid is None else sid.stride(0)], \
        int(bool(causal))


def _launch(q, k, v, scale, causal=True, mask=None, lens=None, sid=None):
    """The forward kernel.  Returns ``(out, lse, pair)``: ``pair`` is
    ``(row_max, log_sum)`` with a mask or kv_lens, else None."""
    global launches
    _check_qkv(q, k, v, causal)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    ptrs, strides, c = _branch_args(q, causal, mask, lens, sid)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    pair = None
    if mask is not None or lens is not None:
        pair = tuple(torch.empty_like(lse) for _ in range(2))
    pair_ptrs = (0, 0) if pair is None else (t.data_ptr() for t in pair)
    lib, entry, designs = kernel_route("fwd", d, q.dtype)
    fn = _bind(getattr(_build.load(lib), entry), 10, 7, 11)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), *pair_ptrs, *ptrs, b, h, sq, sk, d,
             _build.dtype_code(q.dtype), c, q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), v.stride(0), v.stride(1), *strides,
             float(scale), _stream(q))
    _build.check(err, KERNEL)
    name = variant_name(causal, mask, lens, sid)
    if name is None:
        launches += 1
    else:
        _FWD_VARIANTS[name].launches += 1
    for design in designs:
        _FWD_DESIGNS[design].launches += 1
    return out, lse, pair


class _BwdKernel:
    """Launch wrapper of one kernel of ``csrc/flash_bwd_causal.cu`` (the
    extern entry ``entry``), with a launch counter for its causal launches
    with no other branch, one per variant (``variants``), and one per type
    (``types``): its bf16 launches (``tc``: the 16-bit tensor-core
    kernel), its fp16 launches (``tc16``: the same kernel in fp16) and its
    fp32 launches (``tc32``: the split-TF32 tensor-core kernel; at head_dim
    256 ``simt``, the CUDA-core kernel, in its place); ``d256`` counts
    every launch at head_dim 256 once more; ``wide`` the launches at 384,
    512, ... (any type), in place of the type's counter, and ``wide_tc``
    the dK/dV kernel's tensor-core ones among them (`kernel_route`).
    ``(q, k, v, do, lse, delta, scale)`` plus the branches -> ``dq`` (the dQ kernel, one output) or ``(dk, dv)`` (the
    dK/dV kernel, two), each a contiguous [B, S, H, D] in the inputs'
    dtype; with a mask or kv_lens, ``lse`` is log l and ``row_max`` the
    row max (module docstring).  On a CUDA tensor it launches the kernel
    and raises on anything the kernel does not take; on a CPU tensor it
    computes the same outputs of the plain backward."""

    SOURCE = BWD_SOURCE

    def __init__(self, kernel, kind, n_out):
        self.KERNEL = kernel
        self.launches = 0          # causal launches since the reset
        self._kind = kind
        self.variants = {n: _build.Counter(f"{kernel}:{n}", BWD_SOURCE)
                         for n in VARIANTS}
        self.types = {dt: _build.Counter(f"{kernel}:{n}", BWD_SOURCE)
                      for dt, n in _TYPE_SUFFIX.items()}
        self.tc, self.tc16, self.tc32 = (
            self.types[dt] for dt in (torch.bfloat16, torch.float16,
                                      torch.float32))
        self.d256 = _build.Counter(f"{kernel}:d256", BWD_SOURCE)
        self.simt = _build.Counter(f"{kernel}:simt", BWD_SOURCE)
        self.wide = _build.Counter(f"{kernel}:wide", WIDE_BWD_SOURCE)
        self._designs = {**{_TYPE_SUFFIX[dt]: c
                            for dt, c in self.types.items()},
                         "d256": self.d256, "simt": self.simt,
                         "wide": self.wide}
        if kind == "dkv":
            self.wide_tc = _build.Counter(f"{kernel}:wide_tc",
                                          WIDE_TC_SOURCE)
            self._designs["wide_tc"] = self.wide_tc
        self._n_out = n_out

    def __call__(self, q, k, v, do, lse, delta, scale, *, causal=True,
                 mask=None, lens=None, segs=None, row_max=None):
        if not q.is_cuda:
            dq, dk, dv = _bwd_plain(q, k, v, do, lse, delta, scale, causal,
                                    mask, lens, segs, row_max)
            return dq if self._n_out == 1 else (dk, dv)
        return self._launch(q, k, v, do, lse, delta, scale, causal, mask,
                            lens, segs, row_max)

    def _launch(self, q, k, v, do, lse, delta, scale, causal, mask, lens,
                segs, row_max):
        _check_qkv(q, k, v, causal)
        if do.shape != q.shape or do.dtype != q.dtype \
                or do.device != q.device or not _head_layout(do):
            raise ValueError(f"do must match q in shape, dtype, device and "
                             f"head layout: {tuple(do.shape)} {do.dtype} on "
                             f"{do.device}, strides {do.stride()}")
        _check_aligned("do", do)
        b, sq, h, d = q.shape
        sk = k.shape[1]
        name = variant_name(causal, mask, lens, segs)
        stats = (("lse", lse), ("delta", delta))
        if mask is not None or lens is not None:
            if row_max is None:
                raise ValueError("a masked backward needs row_max")
            stats += (("row_max", row_max),)
        for what, t in stats:
            if (tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{what} must be a contiguous float32 "
                                 f"{(b, h, sq)} on {q.device}")
        rows = sq if self._n_out == 1 else sk
        outs = [torch.empty((b, rows, h, d), dtype=q.dtype, device=q.device)
                for _ in range(self._n_out)]
        common = (b, h, sq, sk, d, _build.dtype_code(q.dtype))
        qkvd = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), do.stride(0), do.stride(1))
        ptrs, strides, c = _branch_args(q, causal, mask, lens, segs)
        lib, entry, designs = kernel_route(self._kind, d, q.dtype)
        fn = _bind(getattr(_build.load(lib), entry), 10 + self._n_out, 7, 13)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 0 if row_max is None else row_max.data_ptr(), *ptrs,
                 *(o.data_ptr() for o in outs), *common, c, *qkvd, *strides,
                 float(scale), _stream(q))
        _build.check(err, self.KERNEL)
        counter = self if name is None else self.variants[name]
        counter.launches += 1
        for design in designs:
            self._designs[design].launches += 1
        return outs[0] if self._n_out == 1 else tuple(outs)


flash_bwd_dq = _BwdKernel("flash_bwd_dq_causal", "dq", 1)
flash_bwd_dkv = _BwdKernel("flash_bwd_dkv_causal", "dkv", 2)


def _forward(q, k, v, scale, causal, mask, lens, sid):
    """(out in q's dtype, lse, the masked pair or None) on either device:
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.is_cuda:
        return _launch(q, k, v, scale, causal, mask, lens, sid)
    out, lse = mha_reference(q, k, v, mask, causal, scale, lens, sid,
                             return_lse=True)
    pair = None
    if mask is not None or lens is not None:
        pair = softmax_stats(q, k, scale, causal, mask, lens, sid)
    return out.to(q.dtype), lse, pair


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: ``apply(q, k, v, scale, causal, mask,
    lens, segs)`` -> ``(out, lse)``, lse not differentiable.  ``mask`` an
    fp32 [B, H, Sq, Sk] view, ``lens`` int32 [B], ``segs`` int32 [B, S],
    each or None; none of them gets a gradient, as on the JAX kernel path
    (`pallas_ops.py:709-714`, `:783-787`, `:804`).  Saves q, k, v (the
    caller's tensors: views of the fused qkv projection in the GPT block),
    out, the softmax statistics and the branches' tensors, so nothing but
    out and the statistics is added to what the graph keeps, as in the JAX
    custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal=True, mask=None, lens=None,
                segs=None):
        out, lse, pair = _forward(q, k, v, scale, causal, mask, lens, segs)
        row_max, stat = (None, lse) if pair is None else pair
        ctx.save_for_backward(q, k, v, out, stat, row_max, mask, lens, segs)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, stat, row_max, mask, lens, segs = ctx.saved_tensors
        if q.is_cuda and not (_head_layout(do) and _aligned(do)):
            # autograd gives no layout guarantee; one copy of [B, S, H, D]
            do = do.contiguous()
        delta = attention_delta(out, do)
        kw = dict(causal=ctx.causal, mask=mask, lens=lens, segs=segs,
                  row_max=row_max)
        if q.is_cuda:
            dq = flash_bwd_dq(q, k, v, do, stat, delta, ctx.scale, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, stat, delta, ctx.scale, **kw)
        else:
            dq, dk, dv = _bwd_plain(q, k, v, do, stat, delta, ctx.scale,
                                    ctx.causal, mask, lens, segs, row_max)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_arrays(q, k, v, attn_mask=None, is_causal=False,
                           scale=None, kv_lens=None, segment_ids=None, *,
                           return_lse=False):
    """Attention over [B, S, H, D] in the JAX argument order and defaults
    (non-causal unless ``is_causal``).  Returns ``out`` (in q's dtype)
    and, with ``return_lse``, the fp32 logsumexp [B, H, Sq].

    ``attn_mask``: bool (True attends) or additive, [Sq, Sk], [B, Sq, Sk]
    or [Bm, Hm, Sq, Sk] (Bm in {1, B}, Hm in {1, H}); ``kv_lens``: [B]
    valid key counts (>= 1); ``segment_ids``: [B, S] packed-sequence ids,
    self-attention only (positions attend iff their ids match).  All
    compose with each other and with causal as in `mha_reference`.

    On a CUDA tensor this launches the hand-written kernels — any S, head
    dims 64, 128, 256 and every larger multiple of 128 in both
    directions, float32, bfloat16 or
    float16, every branch — and raises on anything they do not take; it
    never falls back.  On a CPU tensor it computes `mha_reference`.  When grad is enabled and q, k or
    v requires it, the call goes through `FlashAttention`, whose backward
    is the two backward kernels (CUDA) or the plain backward (CPU); the
    mask, kv_lens and ids get no gradient, as on the JAX kernel path.  On the CPU a mask
    that itself requires grad is differentiated through `mha_reference`
    instead (the JAX fallback's VJP)."""
    d = q.shape[-1]
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sid = None
    if segment_ids is not None:
        sid = torch.as_tensor(segment_ids, dtype=torch.int32,
                              device=q.device)
        if sq != sk or tuple(sid.shape) != (b, sq):
            raise ValueError(
                f"segment_ids must be [batch, seq] = [{b}, {sq}] for "
                f"self-attention (got shape {tuple(sid.shape)}, key length "
                f"{sk})")
        if sid.stride(1) != 1:
            sid = sid.contiguous()
    lens = None
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                               device=q.device).reshape(-1)
        if lens.shape != (b,):
            raise ValueError(f"kv_lens must be [{b}], got "
                             f"{tuple(torch.as_tensor(kv_lens).shape)}")
        lens = lens.contiguous()
    mask = None if attn_mask is None else normalize_mask(attn_mask, b, h,
                                                         sq, sk)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    mask_grad = (attn_mask is not None and attn_mask.requires_grad
                 and torch.is_grad_enabled())
    if grad and not (mask_grad and not q.is_cuda):
        out, lse = FlashAttention.apply(q, k, v, scale, is_causal,
                                        None if mask is None
                                        else mask.detach(), lens, sid)
    elif q.is_cuda:
        out, lse, _ = _forward(q, k, v, scale, is_causal, mask, lens, sid)
    else:
        res = mha_reference(q, k, v, mask, is_causal, scale, lens, sid,
                            return_lse=return_lse)
        out, lse = res if return_lse else (res, None)
        out = out.to(q.dtype)
    return (out, lse) if return_lse else out
