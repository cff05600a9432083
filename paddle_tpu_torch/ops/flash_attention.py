"""Causal flash attention — the port of the flash part of
`paddle_tpu/ops/pallas_ops.py`, forward and backward.

`flash_attention_arrays` launches the CUDA kernel ``csrc/flash_fwd_causal.cu``
on a CUDA tensor and computes `mha_reference` (the plain version,
`pallas_ops.py:73`) on a CPU tensor.  Under autograd it goes through
`FlashAttention`, the counterpart of `_flash_attn_core`'s custom_vjp
(`pallas_ops.py:678-732`): the forward saves the logsumexp, and the
backward launches the two kernels of ``csrc/flash_bwd_causal.cu``
(`flash_bwd_dq`, then `flash_bwd_dkv`, as `_flash_bwd` does) on CUDA
tensors, or computes `flash_attention_bwd_reference` on CPU tensors.
Layout ``[batch, seq, heads, head_dim]``, as in the JAX package.

With an additive (or bool) ``attn_mask`` and / or ``kv_lens`` the forward
on a CUDA tensor launches the masked entry of the same source,
``flash_fwd_masked`` (counted apart, as `masked`); it is forward only.

Left out for later slices: packed ``segment_ids``, non-causal attention on
the card, and the backward of the mask and ``kv_lens`` variants.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_arrays", "mha_reference", "FlashAttention",
           "flash_attention_bwd_reference", "attention_delta",
           "flash_bwd_dq", "flash_bwd_dkv", "masked", "normalize_mask"]

KERNEL = "flash_fwd_causal"
SOURCE = KERNEL       # csrc/<SOURCE>.cu
launches = 0          # unmasked kernel launches since the last reset

_NEG_INF = -1e30


class _MaskedKernel:
    """Launch counter of the mask / kv_lens entry of the same source."""
    KERNEL = "flash_fwd_causal:mask"
    SOURCE = SOURCE
    launches = 0


masked = _MaskedKernel()


def mha_reference(q, k, v, is_causal=False, scale=None, return_lse=False,
                  mask=None, kv_lens=None):
    """q, k, v: [B, S, H, D] -> [B, Sq, H, D] in v's dtype.  fp32 logits
    (einsum of the operands widened to fp32, as JAX's
    ``preferred_element_type=float32``), additive -1e30 causal mask aligned
    at the end (query i sees keys <= i + Sk - Sq), fp32 softmax, probs cast
    to v's dtype.  With ``return_lse`` also the fp32 logsumexp [B, H, Sq].

    ``mask``: additive float or bool (True attends) [Sq, Sk], [B, Sq, Sk]
    or [Bm, Hm, Sq, Sk]; ``kv_lens``: [B] valid key counts (>= 1).  In the
    JAX order (`pallas_ops.py:73-103`): the scaled logits plus the mask
    (fp32; a bool mask as 0 / -1e30); keys that causal or ``kv_lens``
    exclude carry no weight.  Wherever a row keeps a key the mask leaves
    open this is the JAX reference's arithmetic bit for bit.  A row whose
    every allowed key the mask closes (a left-pad query) takes the uniform
    softmax over its allowed keys, as the kernel computes it; JAX's
    reference spreads such a row over the excluded keys too and its TPU
    kernel over whole key tiles.  No real token reads such a row."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if mask is None and kv_lens is None:
        logits = _masked_logits(q, k, scale, is_causal)
    else:
        logits = _variant_logits(q, k, scale, is_causal, mask, kv_lens)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _masked_logits(q, k, scale, is_causal):
    """fp32 [B, H, Sq, Sk] logits times scale, -1e30 where masked."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, _NEG_INF)
    return logits


def normalize_mask(attn_mask, b, h, sq, sk):
    """A 2-, 3- or 4-D bool or additive mask as an additive fp32
    [B, H, Sq, Sk] view (`_normalize_mask`, `pallas_ops.py:735-748`):
    broadcast dims keep stride 0, so nothing is copied but a bool or
    non-fp32 mask's conversion.  Raises unless the mask is [Bm, Hm, Sq, Sk]
    with Bm in {1, B}, Hm in {1, H} (`_mask_shape_ok`, `:628-637`)."""
    m = attn_mask
    if m.dim() == 2:
        m = m[None, None]
    elif m.dim() == 3:
        m = m[:, None]
    if m.dim() != 4 or tuple(m.shape[2:]) != (sq, sk) \
            or m.shape[0] not in (1, b) or m.shape[1] not in (1, h):
        raise ValueError(f"attn_mask must be [Sq, Sk], [B, Sq, Sk] or "
                         f"[Bm, Hm, Sq, Sk] with Bm in (1, {b}), Hm in "
                         f"(1, {h}), Sq={sq}, Sk={sk}; got "
                         f"{tuple(attn_mask.shape)}")
    if m.dtype == torch.bool:
        m = torch.where(m, 0.0, _NEG_INF)
    elif m.dtype != torch.float32:
        m = m.float()
    return m.expand(b, h, sq, sk)


def _variant_logits(q, k, scale, is_causal, mask, kv_lens):
    """fp32 [B, H, Sq, Sk]: scaled logits plus the mask, -inf at the keys
    causal or kv_lens exclude."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits + normalize_mask(mask, b, h, sq, sk)
    allowed = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if is_causal:
        allowed = allowed.tril(sk - sq)
    if kv_lens is not None:
        lens = torch.as_tensor(kv_lens, device=q.device).reshape(b, 1, 1, 1)
        allowed = allowed & (torch.arange(sk, device=q.device) < lens)
    return logits.masked_fill(~allowed, float("-inf"))


def attention_delta(out, do):
    """``rowsum(float(dO) * float(out))`` as a contiguous fp32 [B, H, Sq]:
    the ``delta`` of `_flash_bwd` (`pallas_ops.py:548-549`), formed from
    the STORED output (bf16 in a bf16 run)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(),
                        out.float()).contiguous()


def _bwd_plain(q, k, v, do, lse, delta, scale):
    """The explicit recompute formula of the two backward kernels, with
    their rounding points: p rounded to dO's dtype before the dV product,
    ds to q's dtype before the dK product and to k's before the dQ product
    (`pallas_ops.py:251`, `:313-316`); all products accumulate in fp32."""
    p = torch.exp(_masked_logits(q, k, scale, True) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, do, scale):
    """Plain causal flash backward: (dq, dk, dv) in the inputs' dtypes from
    q, k, v [B, S, H, D], the forward's stored ``out`` and fp32 ``lse``
    [B, H, Sq], and the output gradient ``do``.  Recomputes
    ``p = exp(s * scale - lse)`` rather than differentiating the forward,
    as `_flash_bwd` does (`pallas_ops.py:524-625`)."""
    return _bwd_plain(q, k, v, do, lse, attention_delta(out, do), scale)


def _check_qkv(q, k, v):
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
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in (64, 128):
        raise ValueError(f"kernel takes head_dim 64 or 128, got {d}")
    if k.shape[1] < sq:
        raise ValueError("causal attention needs Sk >= Sq")


def _head_layout(t):
    """Unit stride in D and stride D between heads: the layout the kernels
    index with only batch and sequence strides."""
    return t.stride(3) == 1 and (t.shape[2] == 1 or t.stride(2) == t.shape[3])


def _launch(q, k, v, scale):
    global launches
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.flash_fwd_causal(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, int(q.dtype == torch.bfloat16),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, KERNEL)
    launches += 1
    return out, lse


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.flash_fwd_causal
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [i] * 6 + [ll] * 6 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return lib


def _launch_masked(q, k, v, mask, lens, scale):
    """The masked entry: ``mask`` an fp32 [B, H, Sq, Sk] view or None,
    ``lens`` a contiguous int32 [B] or None, both on q's device."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t in (("attn_mask", mask), ("kv_lens", lens)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.load(SOURCE).flash_fwd_masked
    if fn.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 7 + [i] * 6 + [ll] * 10 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    mstrides = mask.stride() if mask is not None else (0, 0, 0, 0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), 0 if mask is None else mask.data_ptr(),
             0 if lens is None else lens.data_ptr(), b, h, sq, sk, d,
             int(q.dtype == torch.bfloat16), q.stride(0), q.stride(1),
             k.stride(0), k.stride(1), v.stride(0), v.stride(1), *mstrides,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd_masked")
    masked.launches += 1
    return out, lse


class _BwdKernel:
    """Launch wrapper of one kernel of ``csrc/flash_bwd_causal.cu``, with
    its own launch counter.  ``(q, k, v, do, lse, delta, scale)`` ->
    ``dq`` (the dQ kernel, one output) or ``(dk, dv)`` (the dK/dV kernel,
    two), each a contiguous [B, S, H, D] in the inputs' dtype.  On a CUDA
    tensor it launches the kernel and raises on anything the kernel does
    not take; on a CPU tensor it computes the same outputs of the plain
    backward."""

    SOURCE = "flash_bwd_causal"

    def __init__(self, kernel, n_out):
        self.KERNEL = kernel
        self.launches = 0          # kernel launches since the last reset
        self._n_out = n_out

    def __call__(self, q, k, v, do, lse, delta, scale):
        if not q.is_cuda:
            dq, dk, dv = _bwd_plain(q, k, v, do, lse, delta, scale)
            return dq if self._n_out == 1 else (dk, dv)
        _check_qkv(q, k, v)
        if do.shape != q.shape or do.dtype != q.dtype \
                or do.device != q.device or not _head_layout(do):
            raise ValueError(f"do must match q in shape, dtype, device and "
                             f"head layout: {tuple(do.shape)} {do.dtype} on "
                             f"{do.device}, strides {do.stride()}")
        b, sq, h, d = q.shape
        sk = k.shape[1]
        for name, t in (("lse", lse), ("delta", delta)):
            if (tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"{(b, h, sq)} on {q.device}")
        rows = sq if self._n_out == 1 else sk
        outs = [torch.empty((b, rows, h, d), dtype=q.dtype, device=q.device)
                for _ in range(self._n_out)]
        err = self._fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, h, sq, sk, d, int(q.dtype == torch.bfloat16), q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, self.KERNEL)
        self.launches += 1
        return outs[0] if self._n_out == 1 else tuple(outs)

    def _fn(self):
        fn = getattr(_build.load(self.SOURCE), self.KERNEL)
        if fn.argtypes is None:
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = ([vp] * (6 + self._n_out) + [i] * 6 + [ll] * 8
                           + [ctypes.c_float, vp])
            fn.restype = ctypes.c_int
        return fn


flash_bwd_dq = _BwdKernel("flash_bwd_dq_causal", 1)
flash_bwd_dkv = _BwdKernel("flash_bwd_dkv_causal", 2)


class FlashAttention(torch.autograd.Function):
    """Differentiable causal attention: ``apply(q, k, v, scale)`` ->
    ``(out, lse)``, lse not differentiable.  Saves ``(q, k, v, out, lse)``
    — q, k, v are the caller's tensors (views of the fused qkv projection
    in the GPT block), so nothing but out and lse is added to what the
    graph keeps, as in the JAX custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            out, lse = _launch(q, k, v, scale)
        else:
            out, lse = mha_reference(q, k, v, is_causal=True, scale=scale,
                                     return_lse=True)
            out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if not q.is_cuda:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                       ctx.scale)
            return dq, dk, dv, None
        if not _head_layout(do):
            # autograd gives no layout guarantee; one copy of [B, S, H, D]
            do = do.contiguous()
        delta = attention_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention_arrays(q, k, v, attn_mask=None, is_causal=True,
                           scale=None, kv_lens=None, return_lse=False):
    """Attention over [B, S, H, D], causal by default.  Returns ``out`` (in
    q's dtype) and, with ``return_lse``, the fp32 logsumexp [B, H, Sq].

    ``attn_mask``: bool (True attends) or additive, [Sq, Sk], [B, Sq, Sk]
    or [Bm, Hm, Sq, Sk] (Bm in {1, B}, Hm in {1, H}); ``kv_lens``: [B]
    valid key counts (>= 1).  Both compose with causal as in
    `mha_reference`.

    On a CUDA tensor this launches the hand-written kernels — any S, head
    dims 64 and 128, float32 or bfloat16, causal — and raises on anything
    they do not take; it never falls back.  On a CPU tensor it computes
    `mha_reference`.  When grad is enabled and an input requires it, the
    unmasked causal call goes through `FlashAttention`, whose backward is
    the two backward kernels (CUDA) or the plain backward (CPU); a mask or
    ``kv_lens`` under grad is differentiated through `mha_reference` on
    the CPU (the JAX fallback's VJP) and raises on the card."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.is_cuda and not is_causal:
        raise NotImplementedError(
            "the CUDA flash kernel is the causal variant only")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if attn_mask is not None or kv_lens is not None:
        b, sq, h, _ = q.shape
        mask = None if attn_mask is None else normalize_mask(
            attn_mask, b, h, sq, k.shape[1])
        lens = None if kv_lens is None else torch.as_tensor(
            kv_lens, dtype=torch.int32, device=q.device).reshape(-1)
        if lens is not None and lens.shape != (b,):
            raise ValueError(f"kv_lens must be [{b}], got "
                             f"{tuple(torch.as_tensor(kv_lens).shape)}")
        if q.is_cuda:
            if grad:
                raise NotImplementedError(
                    "the backward of the masked / kv_lens flash attention "
                    "is ROADMAP Queue 2 item 2 (the next slice): on the "
                    "card the mask and kv_lens variants are forward only")
            out, lse = _launch_masked(q, k, v, mask, lens, scale)
            return (out, lse) if return_lse else out
        out = mha_reference(q, k, v, is_causal=is_causal, scale=scale,
                            return_lse=return_lse, mask=mask, kv_lens=lens)
    elif is_causal and grad:
        out, lse = FlashAttention.apply(q, k, v, scale)
        return (out, lse) if return_lse else out
    elif q.is_cuda:
        out, lse = _launch(q, k, v, scale)
        return (out, lse) if return_lse else out
    else:
        out = mha_reference(q, k, v, is_causal=is_causal, scale=scale,
                            return_lse=return_lse)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)
