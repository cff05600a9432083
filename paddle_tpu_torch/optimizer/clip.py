"""Gradient clipping — the port of `paddle_tpu/optimizer/clip.py`:
`ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm`.

``apply(grads)`` takes the gradients in parameter order and returns a new
list; the inputs are left as they are.  Norms are taken over squares
summed in float32 (``torch._foreach_norm(..., dtype=float32)``: one
multi-tensor launch for the whole list), the scaling is done in float32
and each result is cast back to its gradient's dtype, as in the JAX
classes."""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]

# elements a group of tensors updated together holds at the most: bounds
# the float32 temporaries of a clip or an optimizer step to a few of this
# size, whatever the model's (a larger tensor is a group of its own)
CHUNK_ELEMS = 1 << 27


def chunks(tensors, limit=None):
    """``(lo, hi)`` bounds of consecutive groups of ``tensors`` of at most
    ``limit`` (default `CHUNK_ELEMS`) elements each (one tensor at
    least)."""
    limit = CHUNK_ELEMS if limit is None else limit
    lo, size = 0, 0
    for i, t in enumerate(tensors):
        if i > lo and size + t.numel() > limit:
            yield lo, i
            lo, size = i, 0
        size += t.numel()
    if lo < len(tensors):
        yield lo, len(tensors)


def _norms(grads):
    """The float32 L2 norm of each gradient."""
    return torch._foreach_norm(grads, 2, dtype=torch.float32)


def _scaled(grads, scales):
    """``(g.float() * scale).to(g.dtype)`` for each gradient, as new
    tensors, a group (`chunks`) at a time; ``scales`` one 0-dim float32
    tensor for all, or one per gradient."""
    out = []
    for lo, hi in chunks(grads):
        wide = [g.to(torch.float32, copy=True) for g in grads[lo:hi]]
        if isinstance(scales, torch.Tensor):
            torch._foreach_mul_(wide, scales)
        else:
            for w, s in zip(wide, scales[lo:hi]):
                w.mul_(s)
        out += [w.to(g.dtype) for w, g in zip(wide, grads[lo:hi])]
    return out


class ClipGradBase:
    def apply(self, grads):
        """grads: list of tensors (aligned with params). Returns a new
        list."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def apply(self, grads):
        return [torch.clamp(g, self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, grads):
        if not grads:
            return []
        norms = torch.stack(_norms(grads))
        scales = torch.clamp(self.clip_norm / torch.clamp(norms, min=1e-12),
                             max=1.0)
        return _scaled(grads, scales.unbind())


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm over all of them.  ``group_name`` and
    ``auto_skip_clip`` are accepted and unused, as in the JAX class."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads):
        """sqrt of the sum over gradients of their fp32 sums of squares,
        a 0-dim float32 tensor on the gradients' device."""
        return torch.stack(_norms(grads)).square().sum().sqrt()

    def apply(self, grads):
        if not grads:
            return []
        norm = self.global_norm(grads)
        scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
        return _scaled(grads, scale)
