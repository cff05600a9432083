"""Limits for holding a CUDA kernel against its plain version on the card,
shared by the card-only tests and ``chip_smoke.py``.

float32: both sides accumulate in fp32 and differ only in summation order,
so a flat or max-relative limit holds.

bfloat16: a flat limit is too weak where outputs are small (long rows), so
the limit is per element and scales with the values it bounds:

    |out - ref| <= 2^-7 * max(|out|, |ref|) + coef * mag

The first term is one bf16 step of the output: each side rounds its fp32
result to bf16 once, each by at most 2^-8 of it (the bf16 unit roundoff).
The second bounds the rounding of an intermediate to bf16 inside a sum,
with ``mag`` that sum taken over magnitudes in fp32:

- attention forward, kernels that do not round p (``coef = FWD_COEF =
  2^-8``: the ragged kernels): the plain version rounds each probability
  to bf16 (by at most 2^-8 of it) before the value product and the kernel
  does not, which moves ``sum_k p_k v_k`` by at most 2^-8 P|V|.
- flash forward (``coef = FLASH_FWD_COEF = 2^-7``): the tensor-core
  kernel rounds p to bf16 for its PV product, as the TPU kernel does
  (`pallas_ops.py:181`): ``exp(s - m)`` at the running max m of its key
  tile, later scaled in fp32 by ``exp(m - m_final) / l``, with l the sum
  of the unrounded p.  The plain version rounds the normalised
  probability, at the row's final max.  Each rounds every product's
  weight by at most 2^-8 of it, so each is within 2^-8 P|V| of the exact
  ``sum_k p_k v_k`` and the two within 2^-7 P|V|
  (`flash_fwd_magnitude`), the argument that ``DECODE_COEF`` makes.  The
  TPU kernel rounds at the same points as the tensor-core one, so the
  same limit holds between it and the plain version.
- attention backward (``coef = BWD_COEF = 2^-7``): both sides round p (for
  dV) and ds (for dK, dQ) to bf16 at the same points, but from fp32 values
  that differ in their last bits (summation order); where such a value
  sits at a bf16 rounding boundary the two round it apart, by at most
  2^-8 of it each, 2^-7 together.  ds = p (dp - delta) is a difference:
  where it cancels (a query's first key, where out equals v) it is fp32
  noise of either side's sums, so it is bounded by the size of its terms,
  w = p (|dO|.|v| + |dO|.|out|), not by |ds|.  If every term of the sum
  rounded apart, the gradients would differ by 2^-7 times P^T|dO| (dV),
  scale W^T|Q| (dK) and scale W|K| (dQ) (`flash_bwd_magnitudes`).
- decode (``coef = DECODE_COEF = 2^-7``): both sides round each
  probability to bf16, the plain version ``exp(s - m)`` at the row's
  final max, the kernel at the running max of its key tile (then scaled
  in fp32), so each is within 2^-8 of the exact product and the two
  within 2^-7 P|V| (`decode_magnitude`).
- LayerNorm (``coef = LN_COEF = 2^-20``): one bf16 step of the output,
  plus the fp32 noise of what cancels in it.  The two sides sum the mean
  in other orders (mu may differ by an ulp, a few 2^-24 of mean|x|) and
  the kernel fuses the last multiply-add, so where x is close to mu, or
  ``(x - mu) rstd w`` close to ``-b``, y's error is a few fp32 ulps of
  those terms, not of y: `ln_magnitude` = ``(|x - mu| + mean|x|) rstd
  |w| + |b|``, with 2^-20 leaving room for the error of the statistics.

- LayerNorm backward (``coef = LN_BWD_COEF = 1e-5``): both sides compute
  in fp32 from the same inputs and differ only in summation order (the
  kernel sums a row in 32 lanes, dw and db in per-warp, per-block and
  per-stride partials; at most ~100 terms in sequence for 8192 rows), so
  each output is within 1e-5 of its sum over term magnitudes
  (`ln_bwd_magnitudes`): ``rstd (|g| + mean|g| + |x^| mean|g x^|)`` for
  dx, the column sums of ``|dy x^|`` and ``|dy|`` for dw and db.  An
  output in bf16 adds one bf16 step (each side rounds it once).

Chains of rounded intermediates (the fused decode layer and the FFN,
`fused_decode_limits`, `ffn_limit`) are bounded stage by stage through
the plain version.  Where both sides round to bf16 fp32 values that are
within ``e`` of each other, the rounded values differ by at most
``rounding_spread(v, e) = |round(v + e) - round(v - e)|``: one bf16 step
where v lies within e of a rounding boundary, 0 elsewhere (rounding is
monotonic).  Two fp32 sums of the same terms in other orders differ by
at most ``FP32_SUM = 2^-16`` of the sum of the terms' magnitudes (about
sqrt(n) 2^-24 is typical for the n <= 3072 terms here), and an input
that may differ by d moves a product by d times the magnitudes it
multiplies.

- FFN: ``u = x W1 + b1`` within ``FP32_SUM (|x| |W1| + |b1|)``; h =
  act(u) within 1.2 times that (the slope of gelu is at most 1.13, of
  relu 1); h rounded differs by ``dh``, its spread; ``y32 = h W2`` within
  ``dh |W2| + FP32_SUM |h| |W2|``; the limit of y is the spread of y32.
- fused decode layer: xn (LN1) within ``LN_COEF`` of its LN terms (as
  the LayerNorm limit), rounded to ``dxn``; q, k, v within ``e_qkv = dxn |Wqkv| +
  FP32_SUM (|xn| |Wqkv| + |bqkv|)`` -- the written K and V rows' limit is
  their spread; the score of key j within ``ds_j = scale (e_q . |k_j| +
  FP32_SUM |q| . |k_j|)``, plus ``scale |q| . e_k`` for the current
  token's key; shifts ds_j of the scores move the normalised
  probabilities by ``p_j (ds_j + P ds)`` at most, so the attention output
  is within ``P (ds |V|) + (P ds) P|V|``, plus ``2^-7 P|V|`` (each side
  rounds p, at its final or running max, within 2^-8), ``p_self e_v`` and
  ``FP32_SUM P|V|``, rounded to ``da``; ``y32 = x + (a Wo + bo)`` within
  ``da |Wo| + FP32_SUM (|a| |Wo| + |bo| + |x|)``; the limit of y is the
  spread of y32.

A kernel whose partner rounds each ``q_d k_d`` product to bf16 before the
per-head sum (the TPU decode kernels) moves each score by up to
``qk_rounding * scale * sum_d |q_d k_d|`` more; the decode and fused-layer
helpers take that as ``qk_rounding`` (2^-8 there, 0 against the port's
plain versions).
"""
from __future__ import annotations

import torch

from .flash_attention import attention_delta, mha_reference, recompute_probs
from .flash_decode import flash_decode_reference
from .fused_mlp import _act, fused_layernorm_reference

__all__ = ["BF16_STEP", "FWD_COEF", "FLASH_FWD_COEF", "BWD_COEF", "DECODE_COEF", "LN_COEF",
           "LN_BWD_COEF", "FP32_SUM", "bf16_limit", "compare",
           "flash_fwd_magnitude", "flash_bwd_magnitudes", "decode_magnitude",
           "decode_limit", "ln_magnitude", "ln_bwd_magnitudes",
           "ln_bwd_limits", "rounding_spread", "fused_decode_limits",
           "ffn_limit"]

BF16_STEP = 2.0 ** -7
FWD_COEF = 2.0 ** -8
FLASH_FWD_COEF = 2.0 ** -7
BWD_COEF = 2.0 ** -7
DECODE_COEF = 2.0 ** -7
LN_COEF = 2.0 ** -20
LN_BWD_COEF = 1e-5
FP32_SUM = 2.0 ** -16


def bf16_limit(out, want, mag, coef):
    """Per-element bf16 limit of the module docstring."""
    return BF16_STEP * torch.maximum(out.float().abs(), want.float().abs()) \
        + coef * mag


def compare(out, want, limit):
    """(max absolute error, largest ratio of error to limit, every element
    within its limit).  ``limit`` is a number or a tensor broadcast against
    the outputs; a NaN anywhere fails."""
    diff = (out.float() - want.float()).abs()
    within = bool((diff <= limit).all())
    ratio = (diff / limit).nan_to_num(nan=0.0)     # 0 / 0: exact and 0
    return diff.max().item(), ratio.max().item(), within


def flash_fwd_magnitude(q, k, v, is_causal=True, mask=None, kv_lens=None,
                        segment_ids=None):
    """P|V| in fp32: the attention of the widened inputs with |V|, causal
    unless ``is_causal=False``, with the branches given."""
    return mha_reference(q.float(), k.float(), v.float().abs(), mask,
                         is_causal, kv_lens=kv_lens, segment_ids=segment_ids)


def flash_bwd_magnitudes(q, k, v, out, lse, do, scale, **branches):
    """(mag_dq, mag_dk, mag_dv) in fp32 [B, S, H, D]: scale W|K|,
    scale W^T|Q| and P^T|dO|, with W = P (|dO|.|V|^T + |dO|.|out|), from
    the same recompute as the plain backward (`recompute_probs`, whose
    keywords ``branches`` takes)."""
    p = recompute_probs(q, k, scale, lse, **branches)
    ado = do.float().abs()
    w = p * (torch.einsum("bqhd,bkhd->bhqk", ado, v.float().abs())
             + attention_delta(out.abs(), ado)[..., None])
    mag_dq = torch.einsum("bhqk,bkhd->bqhd", w, k.float().abs()) * scale
    mag_dk = torch.einsum("bhqk,bqhd->bkhd", w, q.float().abs()) * scale
    mag_dv = torch.einsum("bhqk,bqhd->bkhd", p, ado)
    return mag_dq, mag_dk, mag_dv


def decode_magnitude(q, k_cache, v_cache, length, scale=None):
    """P|V| [B, 1, H, D] in fp32: the plain decode of the widened inputs
    with |V| (no rounding of p in fp32)."""
    return flash_decode_reference(q.float(), k_cache.float(),
                                  v_cache.float().abs(), length, scale)


def _qk_abs_max(qa, keys):
    """max over keys of sum_d |q_d| |k_d|: qa [B, H, D], keys [B, K, H, D]
    -> [B, H]."""
    return torch.einsum("bhd,bkhd->bhk", qa, keys.abs()).amax(-1)


def decode_limit(out, want, q, k_cache, v_cache, length, scale,
                 qk_rounding=0.0):
    """Per-element bf16 limit of a decode output against ``want``."""
    mag = decode_magnitude(q, k_cache, v_cache, length, scale)
    limit = bf16_limit(out, want, mag, DECODE_COEF)
    if qk_rounding:
        b, _, h, d = q.shape
        keys = k_cache[:, :length].reshape(b, length, h, d).float()
        ds = qk_rounding * scale * _qk_abs_max(q[:, 0].float().abs(), keys)
        limit = limit + 2 * ds[:, None, :, None] * mag
    return limit


def ln_magnitude(x2, w, b, eps=1e-5):
    """(|x - mu| + mean|x|) rstd |w| + |b| [n, H] in fp32, from the plain
    statistics."""
    _, mu, rs = fused_layernorm_reference(x2, w, b, eps)
    x = x2.float()
    return (((x - mu).abs() + x.abs().mean(-1, keepdim=True)) * rs
            * w.float().abs() + b.float().abs())


def ln_bwd_magnitudes(x2, w, mu, rs, dy):
    """(mag_dx [n, H], mag_dw [H], mag_db [H]) in fp32: each gradient's
    sum over the magnitudes of its terms."""
    xhat = ((x2.float() - mu) * rs).abs()
    ady = dy.float().abs()
    g = ady * w.float().abs()
    mag_dx = rs * (g + g.mean(-1, keepdim=True)
                   + xhat * (g * xhat).mean(-1, keepdim=True))
    return mag_dx, (ady * xhat).sum(0), ady.sum(0)


def ln_bwd_limits(got, want, x2, w, mu, rs, dy):
    """Per-element limits of the LayerNorm backward's (dx, dw, db) ``got``
    against ``want`` (module docstring): ``LN_BWD_COEF`` of each output's
    magnitude, plus one bf16 step for an output in bf16."""
    limits = []
    for g, r, mag in zip(got, want, ln_bwd_magnitudes(x2, w, mu, rs, dy)):
        limits.append(LN_BWD_COEF * mag if g.dtype == torch.float32
                      else bf16_limit(g, r, mag, LN_BWD_COEF))
    return limits


def rounding_spread(v32, e, dtype):
    """|round(v32 + e) - round(v32 - e)| in fp32, rounding to ``dtype``: how
    far apart two values within ``e`` of ``v32`` can round."""
    return ((v32 + e).to(dtype).float() - (v32 - e).to(dtype).float()).abs()


def fused_decode_limits(plain, args, k_cache, v_cache, t, n_heads, scale,
                        eps=1e-5, qk_rounding=0.0):
    """{"y", "k", "v"}: per-element limits of y and of the written K and V
    rows (module docstring), from ``plain`` = `fused_decode_plain` of the
    same inputs ``args = (x, ln_w, ln_b, wqkv, bqkv, wo, bo)`` and rings."""
    x, ln_w, ln_b, wqkv, bqkv, wo, bo = args
    b, hd = x.shape
    h, d = n_heads, hd // n_heads
    wdt, cdt = wqkv.dtype, k_cache.dtype
    e_xn = LN_COEF * ln_magnitude(x, ln_w, ln_b, eps)
    dxn = rounding_spread(plain["xn32"], e_xn, wdt)
    aw = wqkv.float().abs()
    e_qkv = dxn @ aw + FP32_SUM * (plain["xn"].abs() @ aw
                                   + bqkv.float().abs())
    e_q, e_k, e_v = (e_qkv[:, i * hd:(i + 1) * hd].reshape(b, h, d)
                     for i in range(3))
    keys = torch.cat([k_cache[:, :t].reshape(b, t, h, d).float(),
                      plain["k_new"].reshape(b, 1, h, d)], 1).abs()
    vals = torch.cat([v_cache[:, :t].reshape(b, t, h, d).float(),
                      plain["v_new"].reshape(b, 1, h, d)], 1).abs()
    qa = plain["q"].abs().reshape(b, h, d)
    ds = scale * torch.einsum("bhd,bkhd->bhk",
                              e_q + (FP32_SUM + qk_rounding) * qa, keys)
    ds[..., -1] += scale * (qa * e_k).sum(-1)
    p = plain["p"]
    pv = plain["pv_abs"].reshape(b, h, d)
    e_a = (torch.einsum("bhk,bkhd->bhd", p * ds, vals)
           + ((p * ds).sum(-1, keepdim=True) + DECODE_COEF + FP32_SUM) * pv
           + p[..., -1:] * e_v).reshape(b, hd)
    da = rounding_spread(plain["a32"], e_a, wdt)
    awo = wo.float().abs()
    e_y = da @ awo + FP32_SUM * (plain["a"].abs() @ awo + bo.float().abs()
                                 + x.float().abs())
    return {"y": rounding_spread(plain["y32"], e_y, x.dtype),
            "k": rounding_spread(plain["k_new"], e_k.reshape(b, hd), cdt),
            "v": rounding_spread(plain["v_new"], e_v.reshape(b, hd), cdt)}


def ffn_limit(x2, w1, b1, w2, act):
    """Per-element limit of the FFN's output against the plain version's
    (module docstring)."""
    xa, aw1, aw2 = x2.float().abs(), w1.float().abs(), w2.float().abs()
    u = x2.float() @ w1.float() + b1.float()
    e_h = 1.2 * FP32_SUM * (xa @ aw1 + b1.float().abs())
    h32 = _act(u, act)
    dh = rounding_spread(h32, e_h, x2.dtype)
    h = h32.to(x2.dtype).float()
    e_y = dh @ aw2 + FP32_SUM * (h.abs() @ aw2)
    return rounding_spread(h @ w2.float(), e_y, x2.dtype)
