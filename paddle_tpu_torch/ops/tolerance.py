"""Limits for holding a CUDA kernel against its plain version on the card,
shared by the card-only tests and ``chip_smoke.py``.

float32: both sides accumulate in fp32 and differ only in summation order,
so a flat or max-relative limit holds.  The attention forward kernels
(flash, ragged, decode, the fused layer's attention) are held to
``FP32_FWD = 2e-5`` absolute on inputs of unit scale (N(0, 1) q, k, v).
That limit was set at head dims 64 and 128; at 256 (the CUDA-core flash
forward, the split-K decode loop with rows of two loads a lane) its
derivation, from the three places where the two sides round apart:

- the score ``scale sum_d q_d k_d``: two fp32 sums of D terms in other
  orders differ by about sqrt(D) roundings of partial sums of about
  sqrt(D) in size, ~D 2^-24, times scale = D^-1/2: ~sqrt(D) 2^-24, 1e-6
  at D = 256 (6.7e-7 at 128);
- a shift e of the scores moves the output by at most e max|v - out|, ~4e
  for unit-scale v: 4e-6 at D = 256;
- the value sum over n keys (and the online rescaling of a flash row, a
  multiply a tile) in other orders: ~sqrt(n) 2^-24 of P|V| (< 1): 2.7e-6
  at n = 2048, the longest row the D = 256 cases run.

Together under 1e-5 at D = 256 and 2048 keys, half the limit, where the
same argument gives 7e-6 at D = 128 and S = 512, and the card measured
3.9e-6 there; so the limit stands at D = 256.  A worst case that adds
every rounding in one direction (n 2^-24 = 1.2e-4 at n = 2048) is not
reached by random inputs, as at D <= 128.

The attention backward in float32 (dQ, dK, dV of the flash kernels) is
held to ``1e-4 max|ref|`` of each output (the card tests and
``chip_smoke.py``, ``BWD_REL_FP32``), set at head dims 64 and 128.  At
256 the sums over D that the two sides take in other orders, the score
q.k and dP = dO.v, are twice as long; for unit-scale inputs:

- the score moves by ~sqrt(D) 2^-24 (1e-6, as above), so p = exp(s -
  lse) by that relative; dP, unscaled, by ~D 2^-24 (1.5e-5 at D = 256,
  7.6e-6 at 128), so ds = p (dP - delta) by p 1.5e-5 (delta is the same
  tensor on both sides);
- dQ = scale sum_k ds_k k_k and dK = scale sum_q ds_q q_q then move by
  ~scale D 2^-24 P|k| ~ sqrt(D) 2^-24 ~ 1e-6 (dV = sum_q p_q dO_q by ~1e-6
  P|dO|), and their own sums over the n keys of a row (or queries of a
  key) in other orders by ~sqrt(n) 2^-24 of the sum of term magnitudes:
  ~3e-6 of it at n = 2048;
- against max|ref| (at least the typical row's magnitude: dQ and dK
  grow with sqrt(D) as dP does) these come to a few 1e-6 of max|ref|,
  under a tenth of the limit at D = 256, as at D = 128 (the split-TF32
  kernels measured 1e-6 to 1e-5 of max|ref| there).

The CUDA-core kernels that take fp32 at D = 256 sum each q.k and dO.v
over d in order in one fp32 accumulator (256 terms in sequence: a bound
of 255 2^-24 = 1.5e-5 of the sum of term magnitudes, ~sqrt(256) 2^-24 =
1e-6 typical for random signs), and dQ, dK, dV over the row's tiles of 32
in order, one accumulator across the tiles (n terms in sequence:
~sqrt(n) 2^-24 typical, n 2^-24 = 1.2e-4 of the magnitude sum as the
bound at n = 2048).  The plain version's einsums sum in blocks, so the
sequential order costs a few 1e-6 of max|ref| more on random inputs; the
sequential bound, which could pass the limit on a long row whose terms
all round one way, is not reached by random signs.  The limit stands at
D = 256.

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
  kernel sums a row in a lane's at most 18 columns, a 32-lane shuffle
  tree and up to 16 warps: at most ~40 terms in sequence; dw and db in
  per-lane partials over a group's rows, the block's groups, a merge
  group's blocks and the merge groups (`fused_mlp.ln_bwd_plan`): 41
  terms in sequence for 8192 bf16 rows of H = 768, 128 for 65536), and
  n terms in sequence add at most (n - 1) 2^-24 of their magnitudes
  (7.6e-6 for 128), so each output is within 1e-5 of its sum over term
  magnitudes
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

float16: the bf16 argument with fp16's unit roundoff, 2^-11 (a 10-bit
mantissa), and its narrow range: values below 2^-14 are subnormal, spaced
2^-24 apart, so rounding one moves it by up to 2^-25 absolute, not
relative; scores, softmax statistics and sums stay fp32 (65504, fp16's
largest value, bounds nothing but the stored values).  Per element

    |out - ref| <= 2^-10 max(|out|, |ref|) + (coef + 2^-16) mag
                   + 2^-24 (1 + sub)

(`fp16_limit`): one fp16 step of the output (each side rounds once, by at
most 2^-11, or 2^-25 absolute below 2^-14: the 2^-24); the intermediates
each side rounds, ``coef`` times the same magnitudes as in bf16; the fp32
sums in other orders (``FP32_SUM`` = 2^-16 of the magnitudes); and where a
rounded intermediate can be subnormal, 2^-24 times ``sub``, the sum of
the magnitudes it multiplies:

- flash forward (``FP16_FLASH_FWD_COEF = 2^-10``): both sides round p to
  fp16 (the kernel at its tile's running max, the plain version
  normalised), 2^-11 each; a subnormal p, 2^-25 absolute each, weights
  one |v|: ``sub = sum over the row's allowed keys of |v|``
  (`flash_fwd_subnormal`).
- flash backward (``FP16_BWD_COEF = 2^-10``): p and ds rounded at the
  same points from fp32 values apart in their last bits, as in bf16, one
  step apart at most; a subnormal p or ds adds 2^-24 times what it
  multiplies: sum of |dO| over the key's allowed queries (dV), scale sum
  of |Q| (dK), scale sum of |K| over the query's allowed keys (dQ)
  (`flash_bwd_subnormal`).  Under a loss scale an fp16 ds may overflow to
  inf; both sides then give a non-finite gradient, which a loss scaler
  skips (a NaN still fails `compare`).
- ragged (``FP16_FWD_COEF = 2^-11``): the kernel keeps p in fp32, as the
  TPU kernel computes fp16 pools in fp32 (`ragged_paged_attention.py:174`);
  the plain version (the JAX fallback) rounds the normalised p to fp16:
  2^-11 P|V|, ``sub`` the sum of |v| over the row's keys.
- decode (``FP16_DECODE_COEF = 0``): neither rounds p (the TPU kernel's
  ``fast`` type is fp32 for an fp16 cache, `pallas_ops.py:1038`, and the
  plain version mirrors it), so the fp32 limit plus the output's step.
- LayerNorm (`ln_limit`): y is computed in fp32 from the fp16 inputs and
  rounded once, no intermediate is rounded: one fp16 step of the output,
  the bf16 argument's ``LN_COEF`` of the LN terms for the fp32 noise, and
  2^-24 for a subnormal output -- ``2^-10 max(|out|, |ref|) + LN_COEF
  mag + 2^-24``.
- LayerNorm backward (`ln_bwd_limits`): fp32 throughout from the same
  fp16 x and dy, each output rounded once: ``2^-10 max(|out|, |ref|) +
  LN_BWD_COEF mag + 2^-24``.
- FFN (`ffn_limit`, ``FP16_FFN_COEF = 2^-10``): ``u = x W1 + b1`` and h =
  act(u) in fp32 within ``e_h = 1.2 FP32_SUM (|x| |W1| + |b1|)`` (as in
  bf16); each side rounds h to fp16, within 2^-11 of it each, so the two
  h are within ``2^-10 |h| + e_h`` (a subnormal h: 2^-25 absolute each);
  ``y32 = h W2`` within ``e_y = 2^-10 |h| |W2| + e_h |W2| + FP32_SUM |h|
  |W2| + 2^-24 sum_i |W2_ij|`` (the last for subnormal h); each side
  rounds y once: ``2^-10 |y32| + (1 + 2^-10) e_y + 2^-24``.  An
  h past 65504 becomes inf on both sides, as in the TPU kernel (nothing
  clamps it); the limit holds only where y is finite.

A kernel whose partner rounds each ``q_d k_d`` product to bf16 before the
per-head sum (the TPU decode kernels) moves each score by up to
``qk_rounding * scale * sum_d |q_d k_d|`` more; the decode and fused-layer
helpers take that as ``qk_rounding`` (2^-8 there, 0 against the port's
plain versions).
"""
from __future__ import annotations

import torch

from .flash_attention import (_logits, attention_delta, mha_reference,
                              recompute_probs)
from .flash_decode import flash_decode_reference
from .fused_mlp import _act, fused_layernorm_reference

__all__ = ["FP32_FWD", "BF16_STEP", "FWD_COEF", "FLASH_FWD_COEF", "BWD_COEF", "DECODE_COEF", "LN_COEF",
           "LN_BWD_COEF", "FP32_SUM", "FP16_STEP", "FP16_TINY",
           "FP16_FLASH_FWD_COEF", "FP16_BWD_COEF", "FP16_FWD_COEF",
           "FP16_DECODE_COEF", "FP16_FFN_COEF", "bf16_limit", "fp16_limit",
           "half_limit", "ln_limit",
           "flash_fwd_subnormal", "flash_bwd_subnormal", "flash_fwd_limit",
           "flash_bwd_limits", "compare",
           "flash_fwd_magnitude", "flash_bwd_magnitudes", "decode_magnitude",
           "decode_limit", "ln_magnitude", "ln_bwd_magnitudes",
           "ln_bwd_limits", "rounding_spread", "fused_decode_limits",
           "ffn_limit"]

FP32_FWD = 2e-5
BF16_STEP = 2.0 ** -7
FWD_COEF = 2.0 ** -8
FLASH_FWD_COEF = 2.0 ** -7
BWD_COEF = 2.0 ** -7
DECODE_COEF = 2.0 ** -7
LN_COEF = 2.0 ** -20
LN_BWD_COEF = 1e-5
FP32_SUM = 2.0 ** -16
FP16_STEP = 2.0 ** -10
FP16_TINY = 2.0 ** -24
FP16_FLASH_FWD_COEF = 2.0 ** -10
FP16_BWD_COEF = 2.0 ** -10
FP16_FWD_COEF = 2.0 ** -11
FP16_DECODE_COEF = 0.0
FP16_FFN_COEF = 2.0 ** -10
# the bf16 coefficient of each kind of kernel and its fp16 counterpart
_COEFS = {"flash_fwd": (FLASH_FWD_COEF, FP16_FLASH_FWD_COEF),
          "bwd": (BWD_COEF, FP16_BWD_COEF), "fwd": (FWD_COEF, FP16_FWD_COEF),
          "decode": (DECODE_COEF, FP16_DECODE_COEF)}


def bf16_limit(out, want, mag, coef):
    """Per-element bf16 limit of the module docstring."""
    return BF16_STEP * torch.maximum(out.float().abs(), want.float().abs()) \
        + coef * mag


def fp16_limit(out, want, mag, coef, sub=None):
    """Per-element fp16 limit of the module docstring; ``sub`` the sum of
    the magnitudes a subnormal intermediate multiplies (None: none can
    be)."""
    limit = (FP16_STEP * torch.maximum(out.float().abs(), want.float().abs())
             + (coef + FP32_SUM) * mag + FP16_TINY)
    return limit if sub is None else limit + FP16_TINY * sub


def half_limit(out, want, mag, kind, sub=None):
    """The limit of a bf16 or fp16 output (by ``out``'s dtype) of a kernel
    of ``kind``: "flash_fwd", "bwd", "fwd" (kernels that keep p in fp32
    against a plain version that rounds it) or "decode"."""
    bf16, fp16 = _COEFS[kind]
    if out.dtype == torch.float16:
        return fp16_limit(out, want, mag, fp16, sub)
    return bf16_limit(out, want, mag, bf16)


def _allowed(q, k, is_causal, mask, kv_lens, segment_ids):
    """fp32 [B, H, Sq, Sk]: 1 where a key can carry weight (its logit is
    not excluded), else 0."""
    logits = _logits(q, k, 1.0, is_causal, mask, kv_lens, segment_ids)
    return (logits > -1e29).float()


def flash_fwd_subnormal(q, k, v, is_causal=True, mask=None, kv_lens=None,
                        segment_ids=None):
    """[B, Sq, H, D]: the sum of |v| over each row's allowed keys, which a
    subnormal fp16 p may weight (module docstring)."""
    allowed = _allowed(q, k, is_causal, mask, kv_lens, segment_ids)
    return torch.einsum("bhqk,bkhd->bqhd", allowed, v.float().abs())


def flash_bwd_subnormal(q, k, do, scale, causal=True, mask=None, lens=None,
                        segs=None):
    """(sub_dq, sub_dk, sub_dv) [B, S, H, D]: what a subnormal fp16 ds or p
    multiplies (module docstring)."""
    allowed = _allowed(q, k, causal, mask, lens, segs)
    sub_dq = torch.einsum("bhqk,bkhd->bqhd", allowed, k.float().abs())
    sub_dk = torch.einsum("bhqk,bqhd->bkhd", allowed, q.float().abs())
    sub_dv = torch.einsum("bhqk,bqhd->bkhd", allowed, do.float().abs())
    return sub_dq * scale, sub_dk * scale, sub_dv


def flash_fwd_limit(out, want, q, k, v, is_causal=True, mask=None,
                    kv_lens=None, segment_ids=None):
    """Per-element limit of a bf16 or fp16 flash forward output against
    the plain version."""
    branches = (is_causal, mask, kv_lens, segment_ids)
    mag = flash_fwd_magnitude(q, k, v, *branches)
    sub = (flash_fwd_subnormal(q, k, v, *branches)
           if out.dtype == torch.float16 else None)
    return half_limit(out, want, mag, "flash_fwd", sub)


def flash_bwd_limits(got, want, q, k, v, out, lse, do, scale, **branches):
    """Per-element limits of a bf16 or fp16 backward's (dq, dk, dv)
    ``got`` against ``want``; ``branches`` the keywords of
    `recompute_probs`."""
    mags = flash_bwd_magnitudes(q, k, v, out, lse, do, scale, **branches)
    subs = (None,) * 3
    if q.dtype == torch.float16:
        subs = flash_bwd_subnormal(q, k, do, scale, **{
            n: branches[n] for n in ("causal", "mask", "lens", "segs")
            if n in branches})
    return [half_limit(g, w, m, "bwd", s)
            for g, w, m, s in zip(got, want, mags, subs)]


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
    """Per-element bf16 or fp16 limit of a decode output against
    ``want``."""
    mag = decode_magnitude(q, k_cache, v_cache, length, scale)
    limit = half_limit(out, want, mag, "decode")
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


def _fp16_step_limit(out, want, noise):
    """One fp16 step of the larger of ``out`` and ``want``, the fp32
    ``noise`` before the rounding, and 2^-24 for a subnormal output."""
    return (FP16_STEP * torch.maximum(out.float().abs(), want.float().abs())
            + noise + FP16_TINY)


def ln_limit(out, want, x2, w, b, eps=1e-5):
    """Per-element limit of a bf16 or fp16 LayerNorm output (by
    ``out``'s dtype) against the plain version (module docstring)."""
    mag = ln_magnitude(x2, w, b, eps)
    if out.dtype == torch.float16:
        return _fp16_step_limit(out, want, LN_COEF * mag)
    return bf16_limit(out, want, mag, LN_COEF)


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
    magnitude, plus one bf16 step for an output in bf16, one fp16 step
    and 2^-24 for an output in fp16."""
    limits = []
    for g, r, mag in zip(got, want, ln_bwd_magnitudes(x2, w, mu, rs, dy)):
        if g.dtype == torch.float32:
            limits.append(LN_BWD_COEF * mag)
        elif g.dtype == torch.float16:
            limits.append(_fp16_step_limit(g, r, LN_BWD_COEF * mag))
        else:
            limits.append(bf16_limit(g, r, mag, LN_BWD_COEF))
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
    """Per-element limit of the FFN's bf16 or fp16 output against the
    plain version's (module docstring): bf16 by the spreads of the
    rounded values, fp16 in `fp16_limit`'s form."""
    xa, aw1, aw2 = x2.float().abs(), w1.float().abs(), w2.float().abs()
    u = x2.float() @ w1.float() + b1.float()
    e_h = 1.2 * FP32_SUM * (xa @ aw1 + b1.float().abs())
    h32 = _act(u, act)
    if x2.dtype == torch.float16:
        h = h32.half().float()
        e_y = ((FP16_FFN_COEF + FP32_SUM) * (h.abs() @ aw2) + e_h @ aw2
               + FP16_TINY * aw2.sum(0))
        # each side rounds its y32 (within e_y of the plain one) once
        return (FP16_STEP * (h @ w2.float()).abs() + (1 + FP16_STEP) * e_y
                + FP16_TINY)
    dh = rounding_spread(h32, e_h, x2.dtype)
    h = h32.to(x2.dtype).float()
    e_y = dh @ aw2 + FP32_SUM * (h.abs() @ aw2)
    return rounding_spread(h @ w2.float(), e_y, x2.dtype)
