"""Activation recompute — the port of
`paddle_tpu/distributed/fleet/utils/recompute.py`.

JAX wraps the function in ``jax.checkpoint``; here it goes through
`torch.utils.checkpoint.checkpoint` with ``use_reentrant=False``: the
forward keeps none of the function's intermediates, and the backward runs
the function again to rebuild them.  With ``preserve_rng_state`` (the
default) the CPU generator and the default CUDA generators of the inputs'
devices are put back for the second run, so dropout drawn from them (the
port's default, `nn.functional.dropout`) keeps the same mask, as JAX's
replay under the same key does.  ``use_reentrant`` is accepted and
ignored: the port always takes the non-reentrant form, which needs no
input that requires grad and passes keyword arguments through."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``functions`` applied in turn, in ``ctx["segments"]`` segments
    (default 1), each one `recompute`."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    if not isinstance(functions, (list, tuple)):
        functions = list(functions)
    n = len(functions)
    seg_size = max(n // max(segments, 1), 1)
    x = args[0] if len(args) == 1 else args

    def run_segment(fs):
        def seg_fn(inp):
            out = inp
            for f in fs:
                out = f(out)
            return out

        return seg_fn

    out = x
    for i in range(0, n, seg_size):
        out = recompute(run_segment(functions[i:i + seg_size]), out)
    return out
