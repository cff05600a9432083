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

- attention forward (``coef = FWD_COEF = 2^-8``): the plain version rounds
  each probability to bf16 (by at most 2^-8 of it) before the value
  product and the kernel does not, which moves ``sum_k p_k v_k`` by at
  most 2^-8 P|V| (`flash_fwd_magnitude`).
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
"""
from __future__ import annotations

import torch

from .flash_attention import _masked_logits, attention_delta, mha_reference

__all__ = ["BF16_STEP", "FWD_COEF", "BWD_COEF", "bf16_limit", "compare",
           "flash_fwd_magnitude", "flash_bwd_magnitudes"]

BF16_STEP = 2.0 ** -7
FWD_COEF = 2.0 ** -8
BWD_COEF = 2.0 ** -7


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


def flash_fwd_magnitude(q, k, v):
    """P|V| in fp32: the causal attention of the widened inputs with |V|."""
    return mha_reference(q.float(), k.float(), v.float().abs(),
                         is_causal=True)


def flash_bwd_magnitudes(q, k, v, out, lse, do, scale):
    """(mag_dq, mag_dk, mag_dv) in fp32 [B, S, H, D]: scale W|K|,
    scale W^T|Q| and P^T|dO|, with W = P (|dO|.|V|^T + |dO|.|out|), from
    the same recompute as the plain backward."""
    p = torch.exp(_masked_logits(q, k, scale, True) - lse[..., None])
    ado = do.float().abs()
    w = p * (torch.einsum("bqhd,bkhd->bhqk", ado, v.float().abs())
             + attention_delta(out.abs(), ado)[..., None])
    mag_dq = torch.einsum("bhqk,bkhd->bqhd", w, k.float().abs()) * scale
    mag_dk = torch.einsum("bhqk,bqhd->bkhd", w, q.float().abs()) * scale
    mag_dv = torch.einsum("bhqk,bqhd->bkhd", p, ado)
    return mag_dq, mag_dk, mag_dv
