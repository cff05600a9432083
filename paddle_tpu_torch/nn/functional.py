"""Array-level functional ops — the counterparts of
`paddle_tpu/nn/functional/__init__.py` that the serving path needs."""
from __future__ import annotations

import torch

__all__ = ["layer_norm_arrays"]


def layer_norm_arrays(a, w, b, epsilon=1e-5):
    """LayerNorm over the last axis with fp32 statistics — the arithmetic
    of `paddle_tpu.nn.functional.layer_norm_arrays` (mean, biased variance,
    ``(a - mu) * rsqrt(var + eps)`` cast back to a's dtype, then ``* w``
    and ``+ b``).  The final LN of the GPT model; not the block's
    `_stacked_ln`, which orders its operations differently."""
    a32 = a.float()
    mu = a32.mean(-1, keepdim=True)
    var = a32.var(-1, unbiased=False, keepdim=True)
    out = ((a32 - mu) * torch.rsqrt(var + epsilon)).to(a.dtype)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out
