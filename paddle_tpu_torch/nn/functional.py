"""Array-level functional ops — the counterparts of
`paddle_tpu/nn/functional/__init__.py` that the serving and training
paths need."""
from __future__ import annotations

import torch

__all__ = ["layer_norm_arrays", "cross_entropy"]


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


def cross_entropy(logits, labels, ignore_index=-100, reduction="mean"):
    """Hard-label softmax cross entropy over the last axis, in fp32 — the
    hard-label branch of `paddle_tpu.nn.functional.cross_entropy`:
    ``logsumexp(float(logits)) - float(logits[label])``, the label clipped
    into range for the gather, and 0 where the label is ``ignore_index``.
    ``reduction="none"`` returns the per-position loss, ``"mean"`` its sum
    over the count of valid labels (at least 1).  No fp32 log-prob tensor
    is formed beyond what `torch.logsumexp` needs."""
    if reduction not in ("none", "mean"):
        raise ValueError(f"reduction must be 'none' or 'mean', got "
                         f"{reduction!r}")
    lbl = torch.as_tensor(labels, device=logits.device).long()
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(-1)
    clipped = lbl.clamp(0, logits.shape[-1] - 1)
    picked = logits.gather(-1, clipped.unsqueeze(-1)).squeeze(-1).float()
    nll = torch.logsumexp(logits.float(), dim=-1) - picked
    valid = lbl != ignore_index
    loss = torch.where(valid, nll, torch.zeros((), device=nll.device))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    return loss
