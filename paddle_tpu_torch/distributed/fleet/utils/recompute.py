"""Activation recompute — the port of
`paddle_tpu/distributed/fleet/utils/recompute.py`.

JAX wraps the function in ``jax.checkpoint``; here it goes through
`torch.utils.checkpoint.checkpoint` with ``use_reentrant=False``: the
forward keeps none of the function's intermediates, and the backward runs
the function again to rebuild them.  With ``preserve_rng_state`` (the
default) the `core.random` key stack, the CPU generator and the default
CUDA generators of the inputs' devices are put back for the second run, so
dropout keeps the same mask (drawn on the key stack, the port's default,
`nn.functional.dropout`, or from a generator), as JAX's replay under the
same key does; the key stack is left after the second run as the first
run left it.  ``use_reentrant`` is accepted and
ignored: the port always takes the non-reentrant form, which needs no
input that requires grad and passes keyword arguments through."""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from ....core import random as _random

__all__ = ["recompute", "recompute_sequential"]


def _replaying_keys(function):
    """``function``, whose second and later calls (the backward's reruns)
    start from the key stack's state at its first call and leave the
    stack as they found it."""
    first = []

    def run(*args, **kwargs):
        if not first:
            first.append(_random.get_state())
            return function(*args, **kwargs)
        now = _random.get_state()
        _random.set_state(first[0])
        try:
            return function(*args, **kwargs)
        finally:
            _random.set_state(now)

    return run


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if preserve:
        function = _replaying_keys(function)
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
