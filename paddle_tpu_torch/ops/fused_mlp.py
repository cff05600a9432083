"""Fused LayerNorm and fused FFN with their autograd — the port of
`fused_layernorm_arrays` / `fused_layernorm_2d` (`paddle_tpu/ops/
pallas_ops.py:1443-1526`), `fused_ffn_arrays` / `fused_ffn_2d`
(`:1537-1632`), their gates `ln_geometry_ok` / `ffn_geometry_ok` and
`maybe_fused_ffn` (`:1635-1656`).

On a CUDA tensor each launches its kernels (``csrc/fused_layernorm.cu``,
the port of `_ln_fwd_kernel` `:1391`; ``csrc/fused_layernorm_bwd.cu``, of
`_ln_bwd_kernel` `:1404`; ``csrc/fused_ffn.cu``, of `_ffn_fwd_kernel`
`:1548`); on a CPU tensor each computes its plain version.  Both are
differentiable, as the JAX custom VJPs are: the LayerNorm's backward is the
backward kernel (`LayerNormFunction`), the FFN's recomputes the intermediate
in plain PyTorch (`FusedFFNFunction`, `_ffn_vjp_bwd` `:1607`).  Under
``torch.no_grad()`` (the decode step) nothing is recorded.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_layernorm_arrays", "fused_layernorm_reference",
           "fused_layernorm_bwd", "fused_layernorm_bwd_reference",
           "LayerNormFunction", "fused_ffn_arrays", "fused_ffn_reference",
           "FusedFFNFunction", "maybe_fused_ffn", "ln_geometry_ok",
           "ffn_geometry_ok", "ln_fwd", "ln_bwd", "ffn_fwd", "ln_block_rows"]

_ACTS = ("gelu", "gelu_tanh", "relu")


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
ffn_fwd = _Launcher("fused_ffn")


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
    kinds = (torch.float32, torch.bfloat16)
    if x2.dtype not in kinds or w.dtype not in kinds or w.dtype != b.dtype:
        raise ValueError(f"kernel takes float32 / bfloat16 x and one such "
                         f"dtype for w and b, got {x2.dtype}, {w.dtype}, "
                         f"{b.dtype}")
    x2 = x2.contiguous()
    out_dt = _out_dtype(x2, w, b)
    y = torch.empty((n, h), dtype=out_dt, device=x2.device)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    rs = torch.empty((n, 1), dtype=torch.float32, device=x2.device)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = ln_fwd.fn([vp] * 6 + [i] * 4 + [ctypes.c_float, vp])
    err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
             mu.data_ptr(), rs.data_ptr(), n, h,
             int(x2.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
             eps, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, ln_fwd.KERNEL)
    ln_fwd.launches += 1
    return y, mu, rs


_LN_BWD_SMEM = 232448     # shared memory a block may take on an H100
_LN_BWD_GRID = 264        # partial rows of dw and db: two blocks per SM


def ln_bwd_geometry(n, h):
    """(blocks, warps per block) of the backward kernel for [n, H]: up to
    16 warps, as many as leave each its fp32 row of both partial sums in
    shared memory, and at most `_LN_BWD_GRID` blocks.  Raises ValueError
    for an H that leaves no room for one warp."""
    warps = 16
    while warps > 1 and 8 * warps * h > _LN_BWD_SMEM:
        warps //= 2
    if 8 * warps * h > _LN_BWD_SMEM:
        raise ValueError(f"hidden size {h} exceeds the LayerNorm backward "
                         f"kernel's shared memory")
    return max(1, min(-(-n // warps), _LN_BWD_GRID)), warps


def fused_layernorm_bwd(x2, w, mu, rs, dy, b_dtype=None):
    """LayerNorm backward of [n, H] -> (dx, dw, db), the counterpart of
    `_ln_vjp_bwd`.  On a CUDA tensor this launches ``csrc/
    fused_layernorm_bwd.cu`` (x float32 or bfloat16, w float32 or bfloat16
    with ``b_dtype`` the same, dy in ``promote(x, w)``, made contiguous
    here) and raises on anything it does not take; on a CPU tensor it
    computes `fused_layernorm_bwd_reference`."""
    if not x2.is_cuda:
        return fused_layernorm_bwd_reference(x2, w, mu, rs, dy, b_dtype)
    n, h = x2.shape
    kinds = (torch.float32, torch.bfloat16)
    if x2.dtype not in kinds or w.dtype not in kinds \
            or (b_dtype or w.dtype) != w.dtype:
        raise ValueError(f"kernel takes float32 / bfloat16 x and one such "
                         f"dtype for w and b, got {x2.dtype}, {w.dtype}, "
                         f"{b_dtype}")
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
    grid, warps = ln_bwd_geometry(n, h)
    x2, dy = x2.contiguous(), dy.contiguous()
    dw = torch.empty(h, dtype=w.dtype, device=x2.device)
    db = torch.empty(h, dtype=w.dtype, device=x2.device)
    part = torch.empty((2, grid, h), dtype=torch.float32, device=x2.device)
    # four elements a load where every row starts on 16 bytes
    vec = h % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x2, w, dy, dx))
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = ln_bwd.fn([vp] * 9 + [i] * 7 + [vp])
    err = fn(x2.data_ptr(), w.data_ptr(), mu.data_ptr(), rs.data_ptr(),
             dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
             part.data_ptr(), n, h, grid, warps, int(vec),
             int(x2.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, ln_bwd.KERNEL)
    ln_bwd.launches += 1
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

    On a CUDA tensor this launches the kernels (x, w, b float32 or
    bfloat16, w and b of one dtype) and raises on anything they do not
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
    float32 or bfloat16) and raises on anything it does not take; on a
    CPU tensor it computes `fused_ffn_reference`."""
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    h = x.shape[-1]
    y = FusedFFNFunction.apply(x.reshape(-1, h), w1, b1, w2, act)
    return y.reshape(x.shape[:-1] + (w2.shape[1],))


def maybe_fused_ffn(x, w1, b1, w2, act):
    """The fused FFN where the JAX package takes it (`maybe_fused_ffn`,
    `pallas_ops.py:1635`), else None and the caller runs its own
    formulation: ``PTPU_PALLAS_FFN == "1"``, ``b1`` given, x, w1 and w2 of
    one dtype, and `ffn_geometry_ok` for the rows of x."""
    if os.environ.get("PTPU_PALLAS_FFN") != "1" or b1 is None:
        return None
    if not x.dtype == w1.dtype == w2.dtype:
        return None
    if not ffn_geometry_ok(math.prod(x.shape[:-1]), x.shape[-1],
                           w1.shape[-1], w2.shape[-1]):
        return None
    return fused_ffn_arrays(x, w1, b1, w2, act=act)


# per-device int32 tickets of the FFN kernel's reduction tree, zero between
# launches (the block that takes the last ticket of a group resets it)
_TICKETS: dict = {}
_ROWS = 8            # rows per tile of csrc/fused_ffn.cu
_GROUP = 16          # slices per group of its reduction tree
_BLOCKS = 264        # aim: two blocks per SM of an H100


def _tickets(device, n):
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def ffn_slice(n_rows, i):
    """Columns of the intermediate each block takes: the widest power of
    two from 16 up that divides ``i`` and still leaves about `_BLOCKS`
    blocks for ``ceil(n_rows / 8)`` row tiles."""
    tiles = -(-n_rows // _ROWS)
    bi = 16
    while i % (2 * bi) == 0 and 2 * bi <= 512 \
            and tiles * (i // (2 * bi)) >= _BLOCKS:
        bi *= 2
    return bi


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
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got "
                         f"{x2.dtype}")
    bi = ffn_slice(n, i)
    if i % bi:
        raise ValueError(f"intermediate size {i} is not a multiple of 16")
    smem = (_ROWS * h + _ROWS * bi + 256 * _ROWS) * 4
    if smem > 232448:
        raise ValueError(f"hidden size {h} exceeds the kernel's shared "
                         f"memory")
    x2 = x2.contiguous()
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
             _tickets(x2.device, tiles * (groups + 1)).data_ptr(), n, h,
             i, h2, bi,
             _ACTS.index(act), int(x2.dtype == torch.bfloat16),
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, ffn_fwd.KERNEL)
    ffn_fwd.launches += 1
    return y
