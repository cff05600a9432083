"""Fused LayerNorm and fused FFN, forward only — the port of
`fused_layernorm_arrays` / `_ln_fwd` (`paddle_tpu/ops/pallas_ops.py:1443-
1526`) and `fused_ffn_arrays` / `fused_ffn_2d` (`:1537-1632`).

On a CUDA tensor each launches its kernel (``csrc/fused_layernorm.cu``,
the port of `_ln_fwd_kernel` `:1391`; ``csrc/fused_ffn.cu``, the port of
`_ffn_fwd_kernel` `:1548`); on a CPU tensor each computes its plain
version.  The decode step's MLP half (`models/gpt.py`
`_stacked_mlp_fused_decode`) runs them under ``PTPU_PALLAS_FFN=1``.

Their autograd (`_ln_bwd_kernel`, `:1404`, and the FFN's recompute VJP)
is not ported yet: called with an input that requires grad while grad is
enabled, both raise `NotImplementedError`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_layernorm_arrays", "fused_layernorm_reference",
           "fused_ffn_arrays", "fused_ffn_reference", "ln_fwd", "ffn_fwd",
           "ln_block_rows"]

_ACTS = ("gelu", "gelu_tanh", "relu")
_NO_GRAD = ("the backward of the fused {} is ROADMAP Queue 2 item 1 "
            "(`_ln_bwd_kernel` and the LN/FFN autograd); call it under "
            "torch.no_grad()")


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
ffn_fwd = _Launcher("fused_ffn")


def ln_block_rows(n):
    """The JAX row block of the LN and FFN kernels (`_ln_block_rows`,
    `pallas_ops.py:1422`): None where no block divides ``n``.  It decides
    whether the decode MLP takes the fused kernels, so it is kept."""
    for bm in (256, 128, 8):
        if n % bm == 0:
            return bm
    return None


def _no_grad(what, *ts):
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(_NO_GRAD.format(what))


def _out_dtype(*ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


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


def fused_layernorm_arrays(x, w, b, eps=1e-5, return_stats=False):
    """LayerNorm over the last axis.  Returns y in ``promote(x, w, b)``
    and, with ``return_stats``, also the fp32 mu and rstd [n, 1] of the
    rows of ``x.reshape(-1, H)``.

    On a CUDA tensor this launches the kernel (x, w, b float32 or
    bfloat16, w and b of one dtype) and raises on anything it does not
    take; on a CPU tensor it computes `fused_layernorm_reference`."""
    _no_grad("LayerNorm", x, w, b)
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    if x.is_cuda:
        y, mu, rs = _ln_launch(x2, w, b, float(eps))
    else:
        y, mu, rs = fused_layernorm_reference(x2, w, b, eps)
    y = y.reshape(x.shape)
    return (y, mu, rs) if return_stats else y


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


def fused_ffn_arrays(x, w1, b1, w2, act="gelu"):
    """``act(x @ w1 + b1) @ w2`` over the last axis (the caller adds the
    second bias and the residual); ``act`` is ``gelu`` (erf),
    ``gelu_tanh`` or ``relu``.

    On a CUDA tensor this launches the kernel (x, w1, b1, w2 of one dtype,
    float32 or bfloat16) and raises on anything it does not take; on a
    CPU tensor it computes `fused_ffn_reference`."""
    _no_grad("FFN", x, w1, b1, w2)
    if act not in _ACTS:
        raise ValueError(f"fused_ffn: unsupported activation {act!r}")
    h = x.shape[-1]
    x2 = x.reshape(-1, h)
    if x.is_cuda:
        y = _ffn_launch(x2, w1, b1, w2, act)
    else:
        y = fused_ffn_reference(x2, w1, b1, w2, act)
    return y.reshape(x.shape[:-1] + (w2.shape[1],))


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
