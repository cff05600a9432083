"""Automatic mixed precision — the port of `paddle_tpu/amp/__init__.py`:
`auto_cast` / `amp_guard` (O1 white and black lists, O2), `decorate`,
`GradScaler` (dynamic loss scaling), `is_auto_cast_enabled`,
`get_amp_dtype`, and the lists and `cast_plan` the JAX dispatch layer
reads.

This is not `torch.autocast`, whose op lists differ.  The JAX package
casts at its dispatch layer, per named op (`core/dispatch.py:48-63`), and
so does the port: each op of the port that JAX dispatches under a name in
these decisions calls `cast_inputs(name, *tensors)` on its inputs, in the
same place as the JAX op:

- ``linear``: `nn.functional.linear`, and the fused FFN through
  `ops.maybe_fused_ffn` (JAX dispatches it as ``linear``);
- ``flash_attention``: `nn.functional.flash_attention`;
- ``layer_norm``, ``cross_entropy``, ``softmax``, ``embedding``: the
  `nn.functional` ops of those names;
- ``lm_head`` (in neither list) and ``gpt_stacked_blocks`` (the whole
  stacked block stack is one op: O1 leaves it in its own dtype, O2 casts
  it): `models.gpt`.

The casts are ``Tensor.to``, inside autograd, so a cotangent comes back in
its input's dtype, as through JAX's cast inside the op function.

`GradScaler.unscale_` leaves float32 gradients, as JAX does, also for a
bf16 / fp16 parameter; torch keeps a ``.grad`` in its parameter's dtype,
so those are handed to the optimizer beside ``.grad``
(``Optimizer._unscaled_grads``), which updates from them and never rounds
them back.  The jit-traced branches of the JAX scaler (the masked step)
have no counterpart: the port has no traced step.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "cast_plan",
           "cast_inputs", "WHITE_LIST", "BLACK_LIST"]

# O1 lists, as the JAX package's (python/paddle/amp/auto_cast.py:28-92)
WHITE_LIST = {"matmul", "linear", "conv2d", "conv1d", "conv3d", "einsum",
              "flash_attention", "mm", "bmm"}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "layer_norm", "batch_norm", "group_norm",
}

_LOW = (torch.bfloat16, torch.float16)
_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "half": torch.float16, "float32": torch.float32,
           "fp32": torch.float32}


def _dtype(d):
    return d if isinstance(d, torch.dtype) else _DTYPES[str(d)]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_state = _AmpState()


def is_auto_cast_enabled():
    return _state.enabled


def get_amp_dtype():
    return _state.dtype


def cast_plan(name, tensors):
    """The autocast decision for one op: per input, the dtype to cast it
    to, or None; None for the whole op when nothing is cast.  The black
    list wins over O2 (bf16 / fp16 inputs to float32), then O2 or the
    white list casts float32 inputs to the amp dtype."""
    if not _state.enabled:
        return None
    if name in BLACK_LIST:
        plan = tuple(torch.float32 if isinstance(t, torch.Tensor)
                     and t.dtype in _LOW else None for t in tensors)
    elif _state.level == "O2" or name in WHITE_LIST:
        plan = tuple(_state.dtype if isinstance(t, torch.Tensor)
                     and t.dtype == torch.float32 else None for t in tensors)
    else:
        return None
    return plan if any(p is not None for p in plan) else None


def cast_inputs(name, *tensors):
    """``tensors`` cast as `cast_plan` decides for the op ``name`` (None
    entries pass through); unchanged outside `auto_cast`."""
    plan = cast_plan(name, tensors)
    if plan is None:
        return tensors
    return tuple(t if d is None else t.to(d) for t, d in zip(tensors, plan))


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    prev = (_state.enabled, _state.dtype, _state.level)
    added_w = set(custom_white_list or [])
    added_b = set(custom_black_list or [])
    WHITE_LIST.update(added_w)
    BLACK_LIST.update(added_b)
    _state.enabled = enable
    _state.dtype = (torch.bfloat16 if _dtype(dtype) == torch.bfloat16
                    else torch.float16)
    _state.level = level
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = prev
        WHITE_LIST.difference_update(added_w)
        BLACK_LIST.difference_update(added_b)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to bf16 / fp16 (in place, so an
    optimizer made before keeps them); the optimizers keep fp32 masters
    (``multi_precision``, on by default)."""
    dt = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (`paddle_tpu/amp/__init__.py:112-335`, its
    eager branch): ``scale(loss)`` multiplies by the scale; `unscale_`
    turns the gradients into float32 times ``1 / scale`` and notes
    whether any is not finite (one sync with the host); `step` runs the
    optimizer unless one was, then `update` advances the recurrence: a
    finite step counts good (``incr_every_n_steps`` good steps in a row
    multiply the scale by ``incr_ratio``), a non-finite one bad
    (``decr_every_n_nan_or_inf`` of them multiply it by ``decr_ratio``,
    not below 1)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient of ``optimizer`` as float32 times ``1 / scale``:
        in place in ``.grad`` for a float32 parameter, beside it for a
        bf16 / fp16 one (module docstring)."""
        if not self._enable:
            return
        params = [p for p in optimizer._parameter_list if p.grad is not None]
        self._unscaled = True
        if not params:
            self._found_inf = False
            return
        grads = [p.grad.float() for p in params]  # .grad itself if fp32
        found = torch.zeros(1, device=grads[0].device)
        inv = torch.full((1,), 1.0 / self._scale, device=found.device)
        torch._amp_foreach_non_finite_check_and_unscale_(grads, found, inv)
        optimizer._unscaled_grads = {id(p): g for p, g in zip(params, grads)}
        self._found_inf = bool(found.item())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def update(self):
        self._unscaled = False
        if not (self._enable and self._dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._apply_backoff()
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale = self._scale * self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def _apply_backoff(self):
        self._bad_steps += 1
        self._good_steps = 0
        if self._bad_steps >= self._decr_every:
            self._scale = max(self._scale * self._decr_ratio, 1.0)
            self._bad_steps = 0

    def backoff(self):
        """The found-inf recurrence once, from outside the scaler's own
        unscale path."""
        if self._enable and self._dynamic:
            self._apply_backoff()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.full((1,), self._scale)

    def state_dict(self):
        return {"scale": float(self._scale), "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": int(self._good_steps),
                "decr_count": int(self._bad_steps)}

    def load_state_dict(self, state_dict):
        self._scale = state_dict.get("scale", self._scale)
        self._good_steps = state_dict.get("incr_count", 0)
        self._bad_steps = state_dict.get("decr_count", 0)
