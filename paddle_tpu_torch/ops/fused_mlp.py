"""Fused LayerNorm and fused FFN with their autograd — the port of
`fused_layernorm_arrays` / `fused_layernorm_2d` (`paddle_tpu/ops/
pallas_ops.py:1443-1526`), `fused_ffn_arrays` / `fused_ffn_2d`
(`:1537-1632`), their gates `ln_geometry_ok` / `ffn_geometry_ok` and
`maybe_fused_ffn` (`:1635-1656`).

On a CUDA tensor each launches its kernels (``csrc/fused_layernorm.cu``,
the port of `_ln_fwd_kernel` `:1391`; ``csrc/fused_layernorm_bwd.cu``, of
`_ln_bwd_kernel` `:1404`; of `_ffn_fwd_kernel` `:1548` one of four
designs that `ffn_design` picks from the rows, widths and dtype:
``csrc/fused_ffn_tc.cu``, bf16 or fp16 on the tensor cores, for many
rows; ``csrc/fused_ffn_tc32.cu``, fp32 on the tensor cores in split TF32,
for many rows; ``csrc/fused_ffn_decode.cu``, a bandwidth design for a few
rows, any of the three types; ``csrc/fused_ffn.cu``, on the CUDA cores,
for widths the other three do not take); on a CPU tensor each computes
its plain version.  The kernels take float32, bfloat16 and float16, each
entry its types as `_build.dtype_code` codes (the LayerNorm any of the
nine pairs of x's and w's types, as the TPU kernels do); each wrapper
counts its float16 launches once more under ``<kernel>:fp16`` (`ln_fwd16`,
...).  Both are
differentiable, as the JAX custom VJPs are: the LayerNorm's backward is the
backward kernel (`LayerNormFunction`), the FFN's recomputes the intermediate
in plain PyTorch (`FusedFFNFunction`, `_ffn_vjp_bwd` `:1607`).  Under
``torch.no_grad()`` (the decode step) nothing is recorded.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..amp import cast_inputs
from . import _build

__all__ = ["fused_layernorm_arrays", "fused_layernorm_reference",
           "fused_layernorm_bwd", "fused_layernorm_bwd_reference",
           "LayerNormFunction", "fused_ffn_arrays", "fused_ffn_reference",
           "FusedFFNFunction", "maybe_fused_ffn", "ln_geometry_ok",
           "ffn_geometry_ok", "ln_fwd", "ln_bwd", "ffn_fwd", "ffn_tc",
           "ffn_tc32", "ffn_decode", "ln_fwd16", "ln_bwd16", "ffn_fwd16",
           "ffn_tc16", "ffn_decode16", "ln_block_rows", "ffn_design",
           "ffn_tc_tiles", "ffn_decode_loads", "ln_bwd_plan",
           "LnBwdPlan"]

_ACTS = ("gelu", "gelu_tanh", "relu")
H100_SMS = 132               # the planners' default SM count (H100 SXM)


class _Launcher:
    """Launch counter of one kernel; ``KERNEL`` is the C entry point and
    ``SOURCE`` its file ``csrc/<SOURCE>.cu``."""

    def __init__(self, kernel):
        self.KERNEL = self.SOURCE = kernel
        self.launches = 0          # kernel launches since the last reset

    def fn(self, nargs):
        f = getattr(_build.load(self.SOURCE), self.KERNEL)
        if f.argtypes is None:
            f.argtypes = nargs
            f.restype = ctypes.c_int
        return f


ln_fwd = _Launcher("fused_layernorm")
ln_bwd = _Launcher("fused_layernorm_bwd")
ffn_fwd = _Launcher("fused_ffn")            # the CUDA-core design
ffn_tc = _Launcher("fused_ffn_tc")          # bf16, fp16 on the tensor cores
ffn_tc32 = _Launcher("fused_ffn_tc32")      # fp32 on the tensor cores
ffn_decode = _Launcher("fused_ffn_decode")  # a few rows, bandwidth
# the float16 launches of each (a float16 x or w), counted once more
ln_fwd16, ln_bwd16, ffn_fwd16, ffn_tc16, ffn_decode16 = (
    _build.Counter(k.KERNEL + ":fp16", k.SOURCE)
    for k in (ln_fwd, ln_bwd, ffn_fwd, ffn_tc, ffn_decode))
_FP16 = {ln_fwd: ln_fwd16, ln_bwd: ln_bwd16, ffn_fwd: ffn_fwd16,
         ffn_tc: ffn_tc16, ffn_decode: ffn_decode16}


def _count(launcher, *ts):
    """One launch of ``launcher``, and of its float16 counter where one
    of the tensors ``ts`` is float16."""
    launcher.launches += 1
    if any(t.dtype == torch.float16 for t in ts):
        _FP16[launcher].launches += 1


def ln_block_rows(n):
    """The JAX row block of the LN and FFN kernels (`_ln_block_rows`,
    `pallas_ops.py:1422`): None where no block divides ``n``.  The gates
    below keep it, so the port takes the kernels where the JAX package
    does."""
    for bm in (256, 128, 8):
        if n % bm == 0:
            return bm
    return None


def ln_geometry_ok(n, h):
    """The fused LayerNorm's gate (`pallas_ops.py:1429`) without its
    on-TPU condition: whole 128-lane tiles in H and a row block for the
    ``n`` rows."""
    return h % 128 == 0 and ln_block_rows(n) is not None


def ffn_geometry_ok(n_rows, h, i, h2):
    """The fused FFN's gate (`pallas_ops.py:1567`) without its on-TPU
    condition."""
    return (h % 128 == 0 and i % 128 == 0 and h2 % 128 == 0
            and ln_block_rows(n_rows) is not None)


def _out_dtype(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

def fused_layernorm_reference(x2, w, b, eps=1e-5):
    """Plain row LayerNorm of [n, H] -> (y, mu [n, 1], rstd [n, 1]):
    two-pass fp32 statistics, ``var = mean((x - mu)^2)``, ``y = (x - mu)
    * rstd * w + b`` in fp32, cast to ``promote(x, w, b)``
    (`pallas_ops.py:1392-1401`, `:1455`)."""
    x = x2.float()
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    rs = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = xc * rs * w.float() + b.float()
    return y.to(_out_dtype(x2, w, b)), mu, rs


def fused_layernorm_bwd_reference(x2, w, mu, rs, dy, b_dtype=None):
    """Plain LayerNorm backward of [n, H] -> (dx, dw, db)
    (`pallas_ops.py:1404-1419`, `:1483-1514`): in fp32, ``x^ = (x - mu)
    rstd``, ``g = dy w``, ``dx = rstd (g - mean(g) - x^ mean(g x^))`` cast
    to x's dtype; ``dw = sum(dy x^)`` over rows in w's dtype and ``db =
    sum(dy)`` in ``b_dtype`` (default w's)."""
    x, dy32 = x2.float(), dy.float()
    xhat = (x - mu) * rs
    g = dy32 * w.float()
    h = x.shape[-1]
    m1 = g.sum(-1, keepdim=True) / h
    m2 = (g * xhat).sum(-1, keepdim=True) / h
    dx = rs * (g - m1 - xhat * m2)
    return (dx.to(x2.dtype), (dy32 * xhat).sum(0).to(w.dtype),
            dy32.sum(0).to(b_dtype or w.dtype))


def _ln_launch(x2, w, b, eps):
    n, h = x2.shape
    for name, t in (("w", w), ("b", b)):
        if tuple(t.shape) != (h,) or not t.is_contiguous() \
                or t.device != x2.device:
            raise ValueError(f"{name} must be a contiguous ({h},) on "
                             f"{x2.device}")
    if w.dtype != b.dtype:
        raise ValueError(f"kernel takes w and b of one dtype, got {w.dtype}, "
                         f"{b.dtype}")
    codes = _build.dtype_code(x2.dtype), _build.dtype_code(w.dtype)
    x2 = x2.contiguous()
    out_dt = _out_dtype(x2, w, b)
    y = torch.empty((n, h), dtype=out_dt, device=x2.device)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rs = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = ln_fwd.fn([vp] * 6 + [i] * 4 + [ctypes.c_float, vp])
    err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
             mu.data_ptr(), rs.data_ptr(), n, h, *codes, eps,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, ln_fwd.KERNEL)
    _count(ln_fwd, x2, w)
    return y, mu, rs


_LN_BWD_SMEM = 232448     # shared memory a block may take on an H100
_LN_BWD_WIDE_GRID = 264   # the wide design's blocks: two per SM
_LN_BWD_BLOCK_WARPS = 16  # warps of a block (128 registers each): one an SM
_LN_BWD_GROUP_ROWS = 2    # rows a group of warps takes at the least
_LN_BWD_ONE_LEVEL = 16    # blocks whose partials one merge level adds


class LnBwdPlan(NamedTuple):
    """The launch of ``csrc/fused_layernorm_bwd.cu`` for [n, H]: ``grid``
    blocks of ``warps`` warps; the row design (``wide`` False): ``s``
    warps a row, each ``seg`` chunks of 16 bytes of x, ``warps // s`` rows
    a block at a time; the wide design: one warp a row.  Both merge the
    blocks' partial sums in groups of ``k`` blocks."""
    grid: int
    warps: int
    s: int
    seg: int
    k: int
    wide: bool

    @property
    def groups(self):
        """Partial rows of the merge's second level."""
        return -(-self.grid // self.k)


def ln_bwd_plan(n, h, x_dtype, sms=H100_SMS):
    """`LnBwdPlan` of the LayerNorm backward for ``n`` rows of width
    ``h``, x in ``x_dtype``, on a card of ``sms`` SMs, from host values
    only.  The row design: a lane holds 8 columns with x in a 2-byte type,
    bf16 or fp16 (16 where 16 warps of 8 do not cover the row) and 12 in
    fp32 (their w and dw and db partials in registers: `NC_MAX` of the
    source; fewer warps a row measured no faster in bf16, more slower in
    fp32: PERF.md), so s is the fewest warps whose lanes cover a row, at
    most 16; a block holds 16 // s groups of s warps (one block an SM: 128
    registers a thread, and the shared-memory ring of rows in flight); as
    many blocks as give each group two rows, at most one an SM, and a
    multiple that makes the groups a multiple of the rows' alignment
    period (16 / gcd(h * itemsize, 16)).  Wider rows take the wide design:
    up to 16 warps a block, as many as leave each its fp32 row of both
    partial sums in shared memory, at most `_LN_BWD_WIDE_GRID` blocks;
    raises ValueError for an h that leaves no room for one warp.  k, the
    blocks of a first-level group of the merge, is the grid up to
    `_LN_BWD_ONE_LEVEL` blocks (one level: a ticket's round trip fewer),
    else ceil(sqrt(grid)), so that neither level adds more than
    ~sqrt(grid) partials in sequence."""
    xb = x_dtype.itemsize
    v = 16 // xb                           # x's values in a chunk
    nvec = h // v
    for nc in ((1, 2) if xb == 2 else (3,)):   # chunks a lane
        s = max(1, -(-nvec // (32 * nc)))
        if s <= _LN_BWD_BLOCK_WARPS:
            break
    if s <= _LN_BWD_BLOCK_WARPS:
        seg = max(1, -(-nvec // s))
        g = _LN_BWD_BLOCK_WARPS // s
        grid = max(1, min(-(-n // (g * _LN_BWD_GROUP_ROWS)), sms))
        period = 16 // math.gcd(h * xb, 16)
        step = period // math.gcd(period, g)
        grid = -(-grid // step) * step
        wide = False
    else:
        warps = 16
        while warps > 1 and 8 * warps * h > _LN_BWD_SMEM:
            warps //= 2
        if 8 * warps * h > _LN_BWD_SMEM:
            raise ValueError(f"hidden size {h} exceeds the LayerNorm "
                             f"backward kernel's shared memory")
        grid = max(1, min(-(-n // warps), _LN_BWD_WIDE_GRID))
        s, g, seg, wide = 1, warps, 0, True
    k = grid if grid <= _LN_BWD_ONE_LEVEL else math.isqrt(grid - 1) + 1
    return LnBwdPlan(grid, s * g, s, seg, k, wide)


def fused_layernorm_bwd(x2, w, mu, rs, dy, b_dtype=None):
    """LayerNorm backward of [n, H] -> (dx, dw, db), the counterpart of
    `_ln_vjp_bwd`.  On a CUDA tensor this launches ``csrc/
    fused_layernorm_bwd.cu`` (x and w each float32, bfloat16 or float16,
    ``b_dtype`` w's, dy in ``promote(x, w)``, made contiguous here) and
    raises on anything it does not take; on a CPU tensor it computes
    `fused_layernorm_bwd_reference`."""
    if not x2.is_cuda:
        return fused_layernorm_bwd_reference(x2, w, mu, rs, dy, b_dtype)
    return _ln_bwd_launch(x2, w, mu, rs, dy, b_dtype)


def _ln_bwd_launch(x2, w, mu, rs, dy, b_dtype):
    n, h = x2.shape
    if (b_dtype or w.dtype) != w.dtype:
        raise ValueError(f"kernel takes w and b of one dtype, got {w.dtype}, "
                         f"{b_dtype}")
    codes = _build.dtype_code(x2.dtype), _build.dtype_code(w.dtype)
    dt = _out_dtype(x2, w)
    if tuple(dy.shape) != (n, h) or dy.dtype != dt:
        raise ValueError(f"dy must be a {dt} {(n, h)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    if tuple(w.shape) != (h,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({h},)")
    for name, t in (("mu", mu), ("rstd", rs)):
        if (tuple(t.shape) != (n, 1) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {(n, 1)}")
    if any(t.device != x2.device for t in (w, mu, rs, dy)):
        raise ValueError(f"every input must be on {x2.device}")
    dx = torch.empty((n, h), dtype=x2.dtype, device=x2.device)
    if n == 0:
        zeros = torch.zeros(h, dtype=w.dtype, device=x2.device)
        return dx, zeros, zeros.clone()
    plan = ln_bwd_plan(n, h, x2.dtype, _build.sms(x2.device))
    x2, dy = x2.contiguous(), dy.contiguous()
    dw = torch.empty(h, dtype=w.dtype, device=x2.device)
    db = torch.empty(h, dtype=w.dtype, device=x2.device)
    # the blocks' partial rows, then the first level's group rows (fp32,
    # 2h rounded up to 4 floats each)
    part = _build.scratch(ln_bwd.SOURCE, x2.device,
                          (plan.grid + plan.groups) * (-(-2 * h // 4) * 4) * 4)
    tickets = _build.tickets(x2.device, plan.groups + 1)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = ln_bwd.fn([vp] * 10 + [i] * 10 + [vp])
    err = fn(x2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
             dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
             part, tickets.data_ptr(), n, h, plan.grid, plan.warps, plan.s,
             plan.seg, plan.k, int(plan.wide), *codes,
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, ln_bwd.KERNEL)
    _count(ln_bwd, x2, w)
    return dx, dw, db


class LayerNormFunction(torch.autograd.Function):
    """Differentiable row LayerNorm, the custom VJP of
    `fused_layernorm_2d`: ``apply(x2, w, b, eps)`` -> ``(y, mu, rstd)``,
    mu and rstd not differentiable.  Saves ``(x2, w, mu, rstd)`` as the JAX
    VJP does; the backward is `fused_layernorm_bwd`."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        if x2.is_cuda:
            y, mu, rs = _ln_launch(x2, w, b, eps)
        else:
            y, mu, rs = fused_layernorm_reference(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mu, rs)
        ctx.b_dtype = b.dtype
        ctx.mark_non_differentiable(mu, rs)
        return y, mu, rs

    @staticmethod
    def backward(ctx, dy, _dmu, _drs):
        x2, w, mu, rs = ctx.saved_tensors
        dx, dw, db = fused_layernorm_bwd(x2, w, mu, rs, dy, ctx.b_dtype)
        return dx, dw, db, None


def fused_layernorm_arrays(x, w, b, eps=1e-5, return_stats=False):
    """LayerNorm over the last axis.  Returns y in ``promote(x, w, b)``
    and, with ``return_stats``, also the fp32 mu and rstd [n, 1] of the
    rows of ``x.reshape(-1, H)``.  Differentiable in x, w and b
    (`LayerNormFunction`).

    On a CUDA tensor this launches the kernels (x, w, b float32, bfloat16
    or float16, w and b of one dtype) and raises on anything they do not
    take; on a CPU tensor it computes the plain versions.  Callers gate on
    `ln_geometry_ok` first, as the JAX package's do."""
    h = x.shape[-1]
    y, mu, rs = LayerNormFunction.apply(x.reshape(-1, h), w, b, float(eps))
    y = y.reshape(x.shape)
    return (y, mu, rs) if return_stats else y


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def _act(u, act):
    if act == "gelu":
        return F.gelu(u)                      # erf, jax approximate=False
    if act == "gelu_tanh":
        return F.gelu(u, approximate="tanh")
    if act == "relu":
        return torch.clamp_min(u, 0.0)
    raise ValueError(f"fused_ffn: unsupported activation {act!r}")


def fused_ffn_reference(x2, w1, b1, w2, act="gelu"):
    """Plain ``act(x W1 + b1) W2`` of [n, H] -> [n, H2] in x's dtype: the
    first product accumulated in fp32 plus the fp32 b1, the activation in
    fp32, h rounded to x's dtype, the second product accumulated in fp32
    (`pallas_ops.py:1559-1564`)."""
    u = x2.float() @ w1.float() + b1.float()
    h = _act(u, act).to(x2.dtype)
    return (h.float() @ w2.float()).to(x2.dtype)


def _ffn_vjp_ref(x2, w1, b1, w2, act):
    """The function the FFN's backward differentiates (`_ffn_vjp_bwd`,
    `pallas_ops.py:1612-1616`): the first product and the activation in
    fp32, h cast to x's dtype, then ``h @ w2`` in the promoted dtype (not
    the forward kernel's fp32-accumulated product), cast to x's dtype."""
    u = x2.float() @ w1.float() + b1.float()
    h = _act(u, act).to(x2.dtype)
    dt = _out_dtype(h, w2)
    return (h.to(dt) @ w2.to(dt)).to(x2.dtype)


class FusedFFNFunction(torch.autograd.Function):
    """Differentiable ``act(x2 @ w1 + b1) @ w2``, the custom VJP of
    `fused_ffn_2d`: ``apply(x2, w1, b1, w2, act)`` -> y.  Saves only its
    inputs; the backward recomputes the [n, I] intermediate and
    differentiates `_ffn_vjp_ref` with ``torch.autograd.grad`` — plain
    PyTorch (cuBLAS on the card), as the JAX backward is plain XLA."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, act):
        if x2.is_cuda:
            y = _ffn_launch(x2, w1, b1, w2, act)
        else:
            y = fused_ffn_reference(x2, w1, b1, w2, act)
        ctx.save_for_backward(x2, w1, b1, w2)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _ffn_vjp_ref(*ins, ctx.act)
            grads = torch.autograd.grad(y, ins, dy)
        return (*grads, None)


def fused_ffn_arrays(x, w1, b1, w2, act="gelu"):
    """``act(x @ w1 + b1) @ w2`` over the last axis (the caller adds the
    second bias and the residual); ``act`` is ``gelu`` (erf),
    ``gelu_tanh`` or ``relu``.  Differentiable in every tensor
    (`FusedFFNFunction`).

    On a CUDA tensor this launches the kernel (x, w1, b1, w2 of one dtype,
    float32, bfloat16 or float16) and raises on anything it does not take;
    on a CPU tensor it computes `fused_ffn_reference`."""
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    h = x.shape[-1]
    y = FusedFFNFunction.apply(x.reshape(-1, h), w1, b1, w2, act)
    return y.reshape(x.shape[:-1] + (w2.shape[1],))


def maybe_fused_ffn(x, w1, b1, w2, act):
    """The fused FFN where the JAX package takes it (`maybe_fused_ffn`,
    `pallas_ops.py:1635`), else None and the caller runs its own
    formulation: ``PTPU_PALLAS_FFN == "1"``, ``b1`` given, x, w1 and w2 of
    one dtype, and `ffn_geometry_ok` for the rows of x.  Its inputs are
    cast as the op ``linear`` (`amp.cast_inputs`), the name JAX dispatches
    the kernel under (`pallas_ops.py:1656`), after the gate."""
    if os.environ.get("PTPU_PALLAS_FFN") != "1" or b1 is None:
        return None
    if not x.dtype == w1.dtype == w2.dtype:
        return None
    if not ffn_geometry_ok(math.prod(x.shape[:-1]), x.shape[-1],
                           w1.shape[-1], w2.shape[-1]):
        return None
    x, w1, b1, w2 = cast_inputs("linear", x, w1, b1, w2)
    return fused_ffn_arrays(x, w1, b1, w2, act=act)


# -- which design ------------------------------------------------------------

# Measured on an H100 at GPT-2 width (PERF.md, `chip_smoke.py --probe`):
# in bf16 the decode design wins at 8 and 16 rows, the tensor cores from
# 24 (fp16, the same designs in the other 2-byte type, takes the same
# crossover); in fp32 the decode design wins up to 64 rows (0.0916 ms
# against the split-TF32 tensor cores' 0.1116), the tensor cores from 128
# (0.1119 against 0.1588), and the CUDA-core kernel at no row count.
FFN_TC_MIN_ROWS = 24         # 2-byte rows from which the tensor cores win
FFN_DECODE_MAX_ROWS = 64     # fp32 rows up to which the decode design wins
_TC_TILES = ((2, 256), (2, 128), (1, 256), (1, 128))   # (warpgroups, BN)
# fp32's: BN at most 128, the output and each k-tile's sum both in
# registers (csrc/fused_ffn_tc32.cu)
_TC32_TILES = ((2, 128), (2, 64), (1, 128), (1, 64))


def ffn_design(n, h, i, dtype, h2=None):
    """The FFN design for ``n`` rows of width ``h`` through an ``i``-wide
    intermediate to ``h2`` (default ``h``) columns in ``dtype``:
    ``"tc"`` (``csrc/fused_ffn_tc.cu``, bf16 and fp16 from
    `FFN_TC_MIN_ROWS` rows), ``"tc32"`` (``csrc/fused_ffn_tc32.cu``, fp32
    only, above `FFN_DECODE_MAX_ROWS` rows, on the tensor cores in split
    TF32, as accurate as fp32 products), ``"decode"``
    (``csrc/fused_ffn_decode.cu``, bf16 and fp16 below `FFN_TC_MIN_ROWS`
    and fp32 up to `FFN_DECODE_MAX_ROWS` rows) or ``"cuda_core"``
    (``csrc/fused_ffn.cu``: any width that is not a multiple of 128, which
    the other three do not take)."""
    if any(d % 128 for d in (h, i, h if h2 is None else h2)):
        return "cuda_core"
    if dtype in (torch.bfloat16, torch.float16):
        return "tc" if n >= FFN_TC_MIN_ROWS else "decode"
    return "decode" if n <= FFN_DECODE_MAX_ROWS else "tc32"


def ffn_tc_tiles(n, i, h2, sms=H100_SMS, tiles=_TC_TILES):
    """((warpgroups, BN), (warpgroups, BN)) of a tensor-core design's two
    products, [n, i] and [n, h2], on a card of ``sms`` SMs: for each, of
    the BM = 64·warpgroups by BN ``tiles`` (bf16's by default, fp32's
    `_TC32_TILES`) whose BN divides its width, the one
    with the least ``waves × (BM + BN)`` -- whole waves of ``sms`` blocks
    times a tile's time per unit of work (its area over its operand
    traffic, BM·BN / (BM + BN)) -- and on a tie the one with more blocks.
    On the H100 this picks the fastest tile of each product at 256, 512,
    1024 and 8192 rows of GPT-2's MLP as measured in bf16, and in fp32
    one within 5 % of the fastest (PERF.md, `chip_smoke.py --probe`)."""
    def pick(m, width):
        best = None
        for wgs, bn in tiles:
            if width % bn:
                continue
            blocks = -(-m // (64 * wgs)) * (width // bn)
            key = (-(-blocks // sms) * (64 * wgs + bn), -blocks)
            if best is None or key < best[0]:
                best = (key, (wgs, bn))
        return best[1]
    return pick(n, i), pick(n, h2)


def ffn_decode_loads(n, k, cols, dtype, sms=H100_SMS):
    """16-byte loads per thread (4, 8 or 16) of one product of the decode
    design, [n, k] by [k, cols]: a block takes 32 of them per k-chunk of
    32·loads rows of the weights and 128 bytes of its columns; the most
    loads that divide ``k`` and still leave a full wave of ``sms`` blocks,
    else the fewest."""
    cw = 128 // dtype.itemsize
    tiles = -(-n // 8)
    fits = [l for l in (4, 8, 16) if k % (32 * l) == 0]
    if not fits:
        raise ValueError(f"width {k} is not a multiple of 128")
    full = [l for l in fits if tiles * (cols // cw) * (k // (32 * l)) >= sms]
    return max(full) if full else min(fits)


# -- the CUDA-core design (csrc/fused_ffn.cu) --------------------------------

_ROWS = 8            # rows per tile of csrc/fused_ffn.cu
_GROUP = 16          # slices per group of its reduction tree
_BLOCKS = 264        # aim: two blocks per SM of an H100


def ffn_slice(n_rows, i):
    """Columns of the intermediate each block of ``csrc/fused_ffn.cu``
    takes: the widest power of two from 16 up that divides ``i`` and still
    leaves about `_BLOCKS` blocks for ``ceil(n_rows / 8)`` row tiles."""
    tiles = -(-n_rows // _ROWS)
    bi = 16
    while i % (2 * bi) == 0 and 2 * bi <= 512 \
            and tiles * (i // (2 * bi)) >= _BLOCKS:
        bi *= 2
    return bi


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_core_launch(x2, w1, b1, w2, act):
    n, h = x2.shape
    i, h2 = w1.shape[1], w2.shape[1]
    bi = ffn_slice(n, i)
    if i % bi:
        raise ValueError(f"intermediate size {i} is not a multiple of 16")
    smem = (_ROWS * h + _ROWS * bi + 256 * _ROWS) * 4
    if smem > 232448:
        raise ValueError(f"hidden size {h} exceeds the kernel's shared "
                         f"memory")
    tiles, slices = -(-n // _ROWS), i // bi
    groups = -(-slices // _GROUP)
    y = torch.empty((n, h2), dtype=x2.dtype, device=x2.device)
    # fp32 partials of each slice, then of each group of slices (freed on
    # return, reused only by work queued later on this stream)
    part = torch.empty((slices + groups, n, h2), dtype=torch.float32,
                       device=x2.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ffn_fwd.fn([vp] * 7 + [ci] * 7 + [vp])
    err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             y.data_ptr(), part.data_ptr(),
             _build.tickets(x2.device, tiles * (groups + 1)).data_ptr(), n, h,
             i, h2, bi,
             _ACTS.index(act), _build.dtype_code(x2.dtype), _stream(x2))
    _build.check(err, ffn_fwd.KERNEL)
    _count(ffn_fwd, x2)
    return y


def _tc32_launch(x2, w1, b1, w2, act):
    n, h = x2.shape
    i, h2 = w1.shape[1], w2.shape[1]
    (g1, n1), (g2, n2) = ffn_tc_tiles(n, i, h2, _build.sms(x2.device),
                                      _TC32_TILES)
    # the kept scratch: h [n, i], then W1^T and W2^T split ([2, i, h],
    # [2, h2, i]), each from a 256-byte boundary
    off1 = -(-n * i * 4 // 256) * 256
    off2 = off1 + -(-2 * i * h * 4 // 256) * 256
    base = _scratch(x2.device, off2 + 2 * h2 * i * 4)
    y = torch.empty((n, h2), dtype=x2.dtype, device=x2.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ffn_tc32.fn([vp] * 8 + [ci] * 9 + [vp])
    err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             base, base + off1, base + off2, y.data_ptr(), n, h, i, h2,
             _ACTS.index(act), g1, n1, g2, n2, _stream(x2))
    _build.check(err, ffn_tc32.KERNEL)
    ffn_tc32.launches += 1
    return y


def _tc_launch(x2, w1, b1, w2, act):
    n, h = x2.shape
    i, h2 = w1.shape[1], w2.shape[1]
    (g1, n1), (g2, n2) = ffn_tc_tiles(n, i, h2, _build.sms(x2.device))
    hbuf = torch.empty((n, i), dtype=x2.dtype, device=x2.device)
    y = torch.empty((n, h2), dtype=x2.dtype, device=x2.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ffn_tc.fn([vp] * 6 + [ci] * 10 + [vp])
    err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             hbuf.data_ptr(), y.data_ptr(), n, h, i, h2, _ACTS.index(act),
             g1, n1, g2, n2, _build.dtype_code(x2.dtype), _stream(x2))
    _build.check(err, ffn_tc.KERNEL)
    _count(ffn_tc, x2)
    return y


@functools.lru_cache(maxsize=None)
def _decode_plan(n, h, i, h2, dtype, sms):
    """(loads a thread of each product, byte offsets of part1 and part2 in
    the scratch, its bytes, tickets) of a decode-design call: h [n, i] in
    ``dtype``, then the fp32 partials of each k-chunk of each product,
    each from a 256-byte boundary."""
    l1 = ffn_decode_loads(n, h, i, dtype, sms)
    l2 = ffn_decode_loads(n, i, h2, dtype, sms)
    item = dtype.itemsize

    def pad(nbytes):
        return -(-nbytes // 256) * 256

    off1 = pad(n * i * item)
    off2 = off1 + pad(h // (32 * l1) * n * i * 4)
    size = off2 + pad(i // (32 * l2) * n * h2 * 4)
    return l1, l2, off1, off2, size, -(-n // 8) * (i + h2) * item // 128


def _scratch(device, nbytes):
    """The address of the FFN's kept per-device scratch (the decode
    design's h and partials: at GPT-2 width 0.6 MB at 8 bf16 rows; the
    fp32 tensor-core design's h and split weights: 138 MB at 8192 rows)."""
    return _build.scratch("fused_ffn", device, nbytes)


def _decode_launch(x2, w1, b1, w2, act):
    n, h = x2.shape
    i, h2 = w1.shape[1], w2.shape[1]
    dt, dev = x2.dtype, x2.device
    l1, l2, off1, off2, size, n_tickets = _decode_plan(n, h, i, h2, dt,
                                                       _build.sms(dev))
    base = _scratch(dev, size)
    y = torch.empty((n, h2), dtype=dt, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = ffn_decode.fn([vp] * 9 + [ci] * 8 + [vp])
    err = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
             base, y.data_ptr(), base + off1, base + off2,
             _build.tickets(dev, n_tickets).data_ptr(), n, h, i, h2, l1, l2,
             _ACTS.index(act), _build.dtype_code(dt), _stream(x2))
    _build.check(err, ffn_decode.KERNEL)
    _count(ffn_decode, x2)
    return y


_FFN_LAUNCH = {"tc": _tc_launch, "tc32": _tc32_launch,
               "decode": _decode_launch, "cuda_core": _cuda_core_launch}


def _ffn_launch(x2, w1, b1, w2, act):
    n, h = x2.shape
    i = w1.shape[1] if w1.dim() == 2 else -1
    h2 = w2.shape[1] if w2.dim() == 2 else -1
    shapes = (("w1", w1, (h, i)), ("b1", b1, (i,)), ("w2", w2, (i, h2)))
    for name, t, shape in shapes:
        if (tuple(t.shape) != shape or not t.is_contiguous()
                or t.dtype != x2.dtype or t.device != x2.device):
            raise ValueError(f"{name} must be a contiguous {x2.dtype} "
                             f"{shape} on {x2.device}")
    _build.dtype_code(x2.dtype)          # float32, bfloat16 or float16
    x2 = x2.contiguous()
    design = ffn_design(n, h, i, x2.dtype, h2)
    if design != "cuda_core":
        # 16-byte loads (and, on the tensor cores, copies) of every operand
        for name, t in (("x", x2), ("w1", w1), ("b1", b1), ("w2", w2)):
            if t.data_ptr() % 16:
                raise ValueError(f"fused_ffn ({design} design): {name} "
                                 f"must start on 16 bytes")
    return _FFN_LAUNCH[design](x2, w1, b1, w2, act)
