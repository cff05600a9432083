"""Optimizers — the port of `paddle_tpu/optimizer/optimizer.py`: the
`Optimizer` base (multi-precision master weights, one whole-list update
per step) and the `Adam` / `AdamW` families.

The JAX base jits one update over the parameter pytree; here the update is
a handful of `torch._foreach_*` calls over the parameter list, under
`torch.no_grad()`, so the card sees a few multi-tensor kernels per step
instead of one small kernel per parameter and operation.  Scalars that JAX
holds as float32 arrays (the learning rate, the bias corrections, the
decay factor) are rounded to float32 here too, so the two agree to the
last few ulps.

Left out for later slices: ``grad_clip``, LR schedulers, the other
optimizer families, ZeRO state placement and the training telemetry.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class Optimizer:
    """Base optimizer.  Subclasses define `_state_spec(work)` (slot
    tensors) and `_update(works, grads, states, lr, step)`, which updates
    ``works`` (the fp32 masters, or the parameters themselves) in place.

    With ``multi_precision`` a bf16/fp16 parameter gets an fp32 master
    copy at its first step; the update runs on the master and the result
    is cast back into the parameter, as `Optimizer._fused_update` does.
    A number given as ``weight_decay`` is coupled L2 decay, added to the
    gradient before the update."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, multi_precision=True):
        if parameters is None:
            raise ValueError("parameters required (pass model.parameters())")
        self._parameter_list = [p for p in parameters
                                if isinstance(p, torch.Tensor)]
        self._learning_rate = float(learning_rate)
        self._coupled_wd = (float(weight_decay)
                            if isinstance(weight_decay, (int, float))
                            and not isinstance(weight_decay, bool) else 0.0)
        self._multi_precision = multi_precision
        self._states: dict = {}            # id(param) -> {slot: tensor}
        self._master_weights: dict = {}    # id(param) -> fp32 tensor
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    # -- state ------------------------------------------------------------
    def _state_spec(self, work) -> dict:
        return {}

    def _ensure_state(self, p) -> dict:
        key = id(p)
        if key not in self._states:
            if self._multi_precision and p.dtype in _LOW_PRECISION:
                self._master_weights[key] = p.detach().float().clone()
            self._states[key] = self._state_spec(
                self._master_weights.get(key, p.detach()))
        return self._states[key]

    def _update(self, works, grads, states, lr, step):
        raise NotImplementedError

    # -- public API -------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient; the step
        count (1-based, for bias correction) advances even when none has."""
        self._step_count += 1
        params = [p for p in self._parameter_list
                  if p.grad is not None and p.requires_grad]
        if not params:
            return
        states = [self._ensure_state(p) for p in params]
        works = [self._master_weights.get(id(p), p) for p in params]
        # cast to the work dtype; never an alias of p.grad when a master
        # exists, and never written in place below
        grads = [p.grad.to(w.dtype) for p, w in zip(params, works)]
        if self._coupled_wd:
            grads = torch._foreach_add(grads, works, alpha=self._coupled_wd)
        self._update(works, grads, states, self._learning_rate,
                     self._step_count)
        for p, w in zip(params, works):
            if w is not p:
                p.copy_(w)                 # master -> param dtype

    def clear_grad(self, set_to_zero=False) -> None:
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None


class Adam(Optimizer):
    """Adam with bias correction by the 1-based step count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _state_spec(self, work):
        return {"moment1": torch.zeros_like(work),
                "moment2": torch.zeros_like(work)}

    def _scaled_moments(self, grads, states, lr, step):
        """Advance the moments in place; return ``lr * m_hat / (sqrt(v_hat)
        + eps)`` per parameter, in float32 (JAX's lr is a float32 array,
        which promotes a bf16 work's product)."""
        b1, b2 = self._beta1, self._beta2
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        t = _f32(float(step))
        c1 = float(1 - _f32(b1) ** t)
        c2 = float(1 - _f32(b2) ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(v, c2))
        torch._foreach_add_(denom, self._epsilon)
        upd = torch._foreach_mul([x.float() for x in
                                  torch._foreach_div(m, c1)],
                                 float(_f32(lr)))
        torch._foreach_div_(upd, denom)
        return upd

    def _update(self, works, grads, states, lr, step):
        upd = self._scaled_moments(grads, states, lr, step)
        torch._foreach_sub_(works, [u.to(w.dtype)
                                    for u, w in zip(upd, works)])


class AdamW(Adam):
    """Adam with decoupled weight decay, applied to every parameter:
    ``p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps)``, computed in
    float32 (on the master, or on a float32 copy of a low-precision
    parameter kept without one), then cast to the parameter's dtype.  A
    ``weight_decay`` that is not a number means 0.01, as in the JAX class
    (which also reads an int that way; here an int is a number)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 multi_precision=True):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, multi_precision)
        self._wd = (float(weight_decay)
                    if isinstance(weight_decay, (int, float))
                    and not isinstance(weight_decay, bool) else 0.01)

    def _update(self, works, grads, states, lr, step):
        upd = self._scaled_moments(grads, states, lr, step)
        decay = float(1 - _f32(lr) * _f32(self._wd))
        wide = [w.float() for w in works]     # the works themselves if fp32
        torch._foreach_mul_(wide, decay)
        torch._foreach_sub_(wide, upd)
        for w, x in zip(works, wide):
            if x is not w:
                w.copy_(x)
