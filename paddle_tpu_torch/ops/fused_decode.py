"""One transformer layer's decode step in one launch — the port of
`fused_decode_layer_arrays` (`paddle_tpu/ops/pallas_ops.py:1261-1345`)
and its gate `_fused_decode_layer_ok` (`:1348`).

LN1 -> qkv -> ring write at row t -> attention over the t cached keys
plus the current one -> out-proj -> residual.  On a CUDA tensor
`fused_decode_layer_arrays` launches the cooperative kernel of
``csrc/fused_decode_layer.cu`` (the port of `_fused_decode_layer_kernel`,
`:1186`); on a CPU tensor it computes `fused_decode_layer_reference`.
`fused_plan` lays the launch out from host-known shapes (CPU-testable):
the loads a thread of the two weight products (`fused_loads`), the
split-K attention's splits (`fused_split`), the grid, and the fp32
partials in the kernel's one kept per-device scratch buffer.

The JAX gate's VMEM budget (resident weights above 8 MiB go unfused) and
its tile and backend conditions state TPU limits and are not ported:
`fused_decode_ok` keeps only the flag and the dtype agreement, which
choose the arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import NamedTuple

import torch

from . import _build

__all__ = ["fused_decode_layer_arrays", "fused_decode_layer_reference",
           "fused_decode_plain", "fused_decode_ok", "fused_plan",
           "fused_loads", "fused_split"]

KERNEL = "fused_decode_layer"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
launches = 0          # kernel launches since the last reset

# shared memory a block may hold on sm_90 (232,448 bytes)
_SMEM_LIMIT = 232448
# the kernel's static shared memory at most (bf16): the weight products'
# cross-warp sums
_SMEM_FIXED = 16400
RUN = 32              # keys a warp task of the attention phase walks at once
_ROWS = 32            # weight rows a unit loads at once (256 threads / 8)
_WARPS = 8            # warps a block


def fused_decode_ok(x, wqkv, k_cache, v_cache) -> bool:
    """``PTPU_FUSED_DECODE == "1"``, and x, the weights and the rings share
    one dtype, float32 or bfloat16 (`pallas_ops.py:1354`, `:1367-1374`)."""
    if os.environ.get("PTPU_FUSED_DECODE") != "1":
        return False
    return (x.dtype == wqkv.dtype == k_cache.dtype == v_cache.dtype
            and x.dtype in (torch.float32, torch.bfloat16))


def fused_loads(k, cols, dtype, blocks):
    """16-byte loads a thread per unit of one weight product, [B, k] by
    [k, cols]: a unit is 128 bytes of columns by 32 * loads rows.  The
    fewest loads whose units fit in one wave of ``blocks`` (each unit one
    round trip to memory, on as many SMs as possible), else the most the
    kernel holds (4 bf16, 8 fp32); loads must cut ``k`` into whole chunks
    of 32 rows."""
    item = 2 if dtype == torch.bfloat16 else 4
    cw = 128 // item
    fits = [l for l in (1, 2, 4, 8)
            if l <= 2 * item and k % (_ROWS * l) == 0]
    if not fits or cols % cw:
        raise ValueError(f"widths {k} x {cols} are not multiples of "
                         f"{_ROWS} rows and {cw} columns")
    for l in fits:
        if cols // cw * (k // (_ROWS * l)) <= blocks:
            return l
    return fits[-1]


def fused_split(t, bh, warps):
    """(keys a split, splits) of the attention phase for ``bh`` (row,
    head) pairs at prefix length ``t`` on ``warps`` co-resident warps: a
    split is one warp's task, whole runs of `RUN` keys, and as many
    splits as let every task run in one round of the warps."""
    splits = max(1, min(-(-t // RUN), warps // bh))
    chunk = -(-(-(-t // splits)) // RUN) * RUN
    return chunk, -(-t // chunk)


class FusedPlan(NamedTuple):
    """A launch of the fused layer: loads a thread of the qkv (l1) and
    out-proj (l3) products, keys per split and splits of the attention,
    the grid, byte offsets of the scratch's parts (part1, attn, part2,
    part3, each from a 256-byte boundary), its bytes, and the tickets."""
    l1: int
    l3: int
    chunk: int
    splits: int
    grid: int
    offsets: tuple
    nbytes: int
    tickets: int


@functools.lru_cache(maxsize=None)
def fused_plan(b, h, d, t, dtype, blocks):
    """The launch of one fused layer of ``b`` rows, ``h`` heads of ``d``
    at prefix length ``t`` in ``dtype``, on a card that holds ``blocks``
    co-resident blocks of the kernel (eight warps each): the grid is
    every block that has work in some phase, the attention one split a
    warp (`fused_split`)."""
    hd = h * d
    l1 = fused_loads(hd, 3 * hd, dtype, blocks)
    l3 = fused_loads(hd, hd, dtype, blocks)
    chunk, splits = fused_split(t, b * h, _WARPS * blocks)
    cw = 128 // (2 if dtype == torch.bfloat16 else 4)
    units1 = 3 * hd // cw * (hd // (_ROWS * l1))
    units3 = hd // cw * (hd // (_ROWS * l3))
    grid = min(blocks, max(units1, -(-b * h * splits // _WARPS), units3))

    def pad(nbytes):
        return -(-nbytes // 256) * 256

    sizes = (hd // (_ROWS * l1) * b * 3 * hd * 4,       # part1
             b * hd * 4,                                 # attn
             b * h * splits * (d + 2) * 4,               # part2
             hd // (_ROWS * l3) * b * hd * 4)            # part3
    offsets, at = [], 0
    for n in sizes:
        offsets.append(at)
        at += pad(n)
    return FusedPlan(l1, l3, chunk, splits, grid, tuple(offsets), at,
                     b * h + hd // cw)


def _mask2d(cache_mask, b, s_max):
    if cache_mask is None:
        return None
    return cache_mask.reshape(b, s_max).float()


def fused_decode_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache,
                       t, n_heads, eps=1e-5, scale=None, cache_mask=None):
    """The plain layer, without writing the rings.  Returns a dict of
    y [B, hd] (x's dtype) and the fp32 intermediates the tolerance needs:
    ``xn32`` and ``xn`` (LN1's output before and after rounding to the
    weights' dtype), q, k_new, v_new, ``a32`` and ``a`` (the attention
    output before and after that rounding), ``y32`` (y before its cast),
    ``p`` [B, H, t+1] (the normalised probabilities, the current token
    last) and ``pv_abs`` = P|V| [B, hd]."""
    b, hd = x.shape
    h = n_heads
    d = hd // h
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    wdt = wqkv.dtype
    cdt = k_cache.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rs = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xn32 = xc * rs * ln_w.float() + ln_b.float()
    xn = xn32.to(wdt).float()
    qkv = xn @ wqkv.float() + bqkv.float()
    q, k_new, v_new = qkv[:, :hd], qkv[:, hd:2 * hd], qkv[:, 2 * hd:]
    kp = k_cache[:, :t].reshape(b, t, h, d).float()
    vp = v_cache[:, :t].reshape(b, t, h, d).float()
    qh = q.reshape(b, h, d)
    s = torch.einsum("bhd,bkhd->bhk", qh, kp) * scale
    mask = _mask2d(cache_mask, b, k_cache.shape[1])
    if mask is not None:
        s = s + mask[:, None, :t]
    s_self = (qh * k_new.reshape(b, h, d)).sum(-1, keepdim=True) * scale
    s = torch.cat([s, s_self], -1)                          # [B, H, t+1]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    v_all = torch.cat([vp, v_new.reshape(b, 1, h, d)], 1)   # fp32 v_new
    acc = torch.einsum("bhk,bkhd->bhd", p.to(cdt).float(), v_all)
    a32 = (acc / l.clamp(min=1e-30)).reshape(b, hd)
    a = a32.to(wdt).float()
    y32 = x32 + (a @ wo.float() + bo.float())
    pn = p / l
    pv_abs = torch.einsum("bhk,bkhd->bhd", pn, v_all.abs()).reshape(b, hd)
    return dict(y=y32.to(x.dtype), y32=y32, xn32=xn32, xn=xn, q=q,
                k_new=k_new, v_new=v_new, a32=a32, a=a, p=pn, pv_abs=pv_abs)


def fused_decode_layer_reference(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache,
                                 v_cache, t, n_heads, eps=1e-5, scale=None,
                                 cache_mask=None):
    """Plain version of the fused layer, with the kernel's rounding points
    (`pallas_ops.py:1208-1256`): LN1 in fp32; xn rounded to the weights'
    dtype before the qkv product (fp32 accumulation, fp32 bias); q, k_new
    and v_new kept in fp32; the prefix attended from the rings and the
    current token from the fp32 k_new / v_new, each probability rounded to
    the cache dtype before the value product; the attention output
    rounded to the weights' dtype before the out-proj; ``y = x + (proj +
    bo)`` in fp32, then cast.  Writes k_new / v_new, rounded to the cache
    dtype, at row t in place.  Returns ``(y, k_cache, v_cache)``."""
    r = fused_decode_plain(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache,
                           v_cache, t, n_heads, eps, scale, cache_mask)
    k_cache[:, t] = r["k_new"].to(k_cache.dtype)
    v_cache[:, t] = r["v_new"].to(v_cache.dtype)
    return r["y"], k_cache, v_cache


def _check(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache, t, n_heads,
           mask):
    if x.dim() != 2:
        raise ValueError(f"x must be [B, hd], got {tuple(x.shape)}")
    b, hd = x.shape
    if hd % n_heads:
        raise ValueError(f"hidden {hd} is not a multiple of {n_heads} heads")
    d = hd // n_heads
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    shapes = (("ln_w", ln_w, (hd,)), ("ln_b", ln_b, (hd,)),
              ("wqkv", wqkv, (hd, 3 * hd)), ("bqkv", bqkv, (3 * hd,)),
              ("wo", wo, (hd, hd)), ("bo", bo, (hd,)))
    for name, a, shape in shapes + (("x", x, (b, hd)),):
        if tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(a.shape)}")
        if a.dtype != x.dtype or a.device != x.device:
            raise ValueError(f"{name} must be {x.dtype} on {x.device}")
    s_max = k_cache.shape[1] if k_cache.dim() == 3 else -1
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if (tuple(c.shape) != (b, s_max, hd) or not c.is_contiguous()
                or c.dtype != x.dtype or c.device != x.device):
            raise ValueError(f"{name} must be a contiguous {x.dtype} "
                             f"[{b}, S_max, {hd}] ring on {x.device}")
    if not 1 <= t < s_max:
        raise ValueError(f"t {t} outside [1, {s_max - 1}]")
    if mask is not None and (tuple(mask.shape) != (b, s_max)
                             or not mask.is_contiguous()):
        raise ValueError(f"cache_mask must be [B, S_max] = {(b, s_max)}")
    for name, a in (("wqkv", wqkv), ("wo", wo), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes for the "
                             f"kernel's 16-byte loads")
    # the kernel stages all B rows in fp32, 8 rows at a time, beside its
    # fixed buffers
    if -(-b // 8) * 8 * hd * 4 + _SMEM_FIXED > _SMEM_LIMIT:
        raise ValueError(f"B * hidden = {b * hd} activations exceed the "
                         f"kernel's shared memory")


def _lib():
    lib = _build.load(SOURCE)
    fn = lib.fused_decode_layer
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 16 + [i] * 10
                       + [ctypes.c_float, ctypes.c_float, vp])
        fn.restype = ctypes.c_int
        lib.fused_decode_layer_blocks.argtypes = [i] * 4
        lib.fused_decode_layer_blocks.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _blocks(device, rows8, h, d, bf16):
    """Co-resident blocks of the kernel for ``rows8`` row chunks of 8 (its
    shared memory) on ``device`` (the current one when first asked)."""
    n = _lib().fused_decode_layer_blocks(8 * rows8, h, d, bf16)
    if n < 1:
        raise RuntimeError(f"{KERNEL}: no co-resident block ({n})")
    return n


def fused_decode_layer_arrays(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache,
                              v_cache, t, n_heads, eps=1e-5, scale=None,
                              cache_mask=None):
    """One decode layer: x [B, hd] -> ``(y [B, hd], k_cache, v_cache)``,
    the flat [B, S_max, hd] rings written in place at row ``t`` (>= 1, the
    prefix length).  ``cache_mask``: optional additive [B, S_max] (or
    [B, 1, 1, S_max]) over the prefix rows; the current token is always
    attended.

    On a CUDA tensor this launches the kernel (one launch; float32 /
    bfloat16, head dims 64 and 128, everything of one dtype) and raises on
    anything it does not take; it never falls back.  On a CPU tensor it
    computes `fused_decode_layer_reference`."""
    global launches
    b, hd = x.shape
    d = hd // n_heads
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    t = int(t)
    if not x.is_cuda:
        return fused_decode_layer_reference(
            x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache, t, n_heads,
            eps, scale, cache_mask)
    y = _launch(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache, t,
                n_heads, eps, scale, cache_mask)
    launches += 1
    return y, k_cache, v_cache


def _launch(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache, t, n_heads,
            eps, scale, cache_mask):
    """Checks, plans and launches the kernel; returns y."""
    b, hd = x.shape
    d = hd // n_heads
    mask = _mask2d(cache_mask, b, k_cache.shape[1])
    if mask is not None:
        mask = mask.contiguous()
    _check(x, ln_w, ln_b, wqkv, bqkv, wo, bo, k_cache, v_cache, t, n_heads,
           mask)
    bf16 = int(x.dtype == torch.bfloat16)
    dev = x.device
    plan = fused_plan(b, n_heads, d, t, x.dtype,
                      _blocks(dev, -(-b // 8), n_heads, d, bf16))
    y = torch.empty_like(x)
    base = _build.scratch(KERNEL, dev, plan.nbytes)
    err = _lib().fused_decode_layer(
        x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), 0 if mask is None else mask.data_ptr(),
        *(base + off for off in plan.offsets),
        _build.tickets(dev, plan.tickets).data_ptr(), y.data_ptr(), b,
        n_heads, d, k_cache.shape[1], t, bf16, plan.l1, plan.l3, plan.chunk,
        plan.grid, float(eps), float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, KERNEL)
    return y
