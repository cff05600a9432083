"""Optimizers — the port of `paddle_tpu/optimizer/optimizer.py`: the
`Optimizer` base (multi-precision master weights, gradient clipping, an LR
scheduler or a fixed rate, checkpointing, one whole-list update per step)
and the ten families `SGD`, `Momentum`, `Adam`, `AdamW`, `Adamax`,
`Adagrad`, `Adadelta`, `RMSProp`, `Lamb` and `Lars`.

The JAX base jits one update over the parameter pytree; here each update
is a handful of `torch._foreach_*` calls over the parameter list, under
`torch.no_grad()`, so the card sees a few multi-tensor kernels per step
instead of one small kernel per parameter and operation.  Scalars that JAX
holds as float32 arrays (the learning rate, the step, the bias
corrections, the decay factor) are rounded to float32 here too, so the two
agree to the last few ulps.

Parameters are named as the JAX optimizer names them in its
``state_dict`` keys (``<name>.<slot>``): pass ``model.named_parameters()``
to give each its name in the model (the port's models use the JAX
``state_dict`` names, or the JAX engine's stacked names); a bare tensor is
``param_<i>`` by its place in the list.  `AdamW`'s
``apply_decay_param_fun`` is given that name.

Left out for later slices: ZeRO state placement and the training
telemetry (``monitor.train``, the sampled grad norm).
"""
from __future__ import annotations

import numpy as np
import torch

from .clip import ClipGradBase, chunks
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _r32(x) -> float:
    """``x`` rounded to float32 (a weak-typed Python scalar of the JAX
    update meeting a float32 array)."""
    return float(_f32(x))


class Optimizer:
    """Base optimizer.  Subclasses define `_state_spec(work)` (slot
    tensors) and `_update(works, grads, states, lr, step, extras)`, which
    updates ``works`` (the fp32 masters, or the parameters themselves) and
    the slot tensors in place; ``extras`` holds `_extra_for` of each
    parameter.

    With ``multi_precision`` a bf16/fp16 parameter gets an fp32 master
    copy at its first step; the update runs on the master and the result
    is cast back into the parameter, as `Optimizer._fused_update` does.
    A number given as ``weight_decay`` is coupled L2 decay, added to the
    gradient before the update.  ``grad_clip`` (a `ClipGradBase`) is
    applied to the gradients first, in their own dtype.
    ``learning_rate`` is a number or an `LRScheduler`, read (and rounded
    to float32) at each step."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if parameters is None:
            raise ValueError("parameters required (pass model.parameters())")
        self._parameter_list, self._names = [], {}
        for item in parameters:
            pname, p = item if isinstance(item, tuple) else (None, item)
            if isinstance(p, torch.Tensor):
                self._names[id(p)] = (
                    pname or f"param_{len(self._parameter_list)}")
                self._parameter_list.append(p)
        self._learning_rate = learning_rate
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be a ClipGradBase, got "
                            f"{type(grad_clip).__name__}")
        self._grad_clip = grad_clip
        self._coupled_wd = (float(weight_decay)
                            if isinstance(weight_decay, (int, float))
                            and not isinstance(weight_decay, bool) else 0.0)
        self._multi_precision = multi_precision
        self._states: dict = {}            # id(param) -> {slot: tensor}
        self._master_weights: dict = {}    # id(param) -> fp32 tensor
        # id(param) -> float32 gradient that replaces p.grad at the next
        # step: what `amp.GradScaler.unscale_` leaves for a bf16 / fp16
        # parameter, whose .grad torch keeps in the parameter's dtype
        self._unscaled_grads: dict = {}
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler

    @property
    def _lr_scheduler(self):
        return (self._learning_rate
                if isinstance(self._learning_rate, LRScheduler) else None)

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

    def _update(self, works, grads, states, lr, step, extras):
        raise NotImplementedError

    def _extra_for(self, p):
        """A per-parameter value for `_update` (AdamW: its decay); None by
        default."""
        return None

    def _grad(self, p):
        g = self._unscaled_grads.get(id(p))
        return p.grad if g is None else g

    # -- public API -------------------------------------------------------
    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient; the step
        count (1-based, for bias correction) advances even when none has."""
        self._step_count += 1
        params = [p for p in self._parameter_list
                  if p.grad is not None and p.requires_grad]
        grads = [self._grad(p) for p in params]
        self._unscaled_grads = {}
        if not params:
            return
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        states = [self._ensure_state(p) for p in params]
        works = [self._master_weights.get(id(p), p) for p in params]
        extras = [self._extra_for(p) for p in params]
        lr = self.get_lr()
        # a group at a time, so the update's temporaries stay a few groups'
        # size (every family updates each tensor on its own)
        for lo, hi in chunks(works):
            w = works[lo:hi]
            # cast to the work dtype; never an alias of p.grad when a
            # master exists, and never written in place below
            g = [x.to(y.dtype) for x, y in zip(grads[lo:hi], w)]
            if self._coupled_wd:
                g = torch._foreach_add(g, w, alpha=self._coupled_wd)
            self._update(w, g, states[lo:hi], lr, self._step_count,
                         extras[lo:hi])
            del g
        for p, w in zip(params, works):
            if w is not p:
                p.copy_(w)                 # master -> param dtype

    def clear_grad(self, set_to_zero=False) -> None:
        self._unscaled_grads = {}
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then `step` (the JAX eager branch)."""
        loss.backward()
        self.step()
        return None, None

    # -- checkpointing ----------------------------------------------------
    def _param_names(self) -> dict:
        return self._names

    def state_dict(self) -> dict:
        """The JAX keys: ``<param name>.<slot>`` and ``<param
        name>.master_weight`` (copies of the tensors), ``LR_Scheduler``
        (the scheduler's own state dict) and ``@step``."""
        out = {}
        name_of = self._param_names()
        for key, slots in self._states.items():
            pname = name_of.get(key, str(key))
            for sname, t in slots.items():
                out[f"{pname}.{sname}"] = t.detach().clone()
        for key, t in self._master_weights.items():
            out[f"{name_of.get(key, key)}.master_weight"] = \
                t.detach().clone()
        if self._lr_scheduler is not None:
            out["LR_Scheduler"] = self._lr_scheduler.state_dict()
        out["@step"] = self._step_count
        return out

    @torch.no_grad()
    def set_state_dict(self, state) -> None:
        """Load what `state_dict` returned (tensors or numpy arrays): every
        parameter's slots are made first, then the named ones are copied
        in; keys of unknown parameters are skipped, as in JAX."""
        name_of = self._param_names()
        key_of = {v: k for k, v in name_of.items()}
        param_of = {id(p): p for p in self._parameter_list}
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        for p in self._parameter_list:
            self._ensure_state(p)
        for k, v in state.items():
            if k in ("LR_Scheduler", "@step"):
                continue
            pname, sname = k.rsplit(".", 1)
            key = key_of.get(pname)
            if key is None:
                continue
            t = torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v)
            dev = param_of[key].device
            if sname == "master_weight":
                self._master_weights[key] = t.to(dev, torch.float32).clone()
            else:
                slot = self._states[key].get(sname)
                dt = slot.dtype if slot is not None else t.dtype
                self._states[key][sname] = t.to(dev, dt).clone()


def _sub_wide(works, upd):
    """``w - u`` computed in float32 and cast back to each work's dtype
    (JAX's float32 lr promotes a bf16 work's update); in place."""
    wide = [w.float() for w in works]     # the works themselves if fp32
    torch._foreach_sub_(wide, upd)
    for w, x in zip(works, wide):
        if x is not w:
            w.copy_(x)


class SGD(Optimizer):
    """``p - lr * g``, lr cast to the work's dtype."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update(self, works, grads, states, lr, step, extras):
        lrs = [_f32(lr).to(w.dtype).item() for w in works]
        torch._foreach_sub_(works, torch._foreach_mul(grads, lrs))


class Momentum(Optimizer):
    """``v = mu v + g``; ``p - lr v`` (Nesterov: ``p - lr (g + mu v)``),
    lr cast to the work's dtype."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _state_spec(self, work):
        return {"velocity": torch.zeros_like(work)}

    def _update(self, works, grads, states, lr, step, extras):
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        torch._foreach_add_(v, grads)
        d = (torch._foreach_add(grads, torch._foreach_mul(v, self._momentum))
             if self._nesterov else v)
        lrs = [_f32(lr).to(w.dtype).item() for w in works]
        torch._foreach_sub_(works, torch._foreach_mul(d, lrs))


class Adam(Optimizer):
    """Adam with bias correction by the 1-based step count."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _state_spec(self, work):
        return {"moment1": torch.zeros_like(work),
                "moment2": torch.zeros_like(work)}

    def _moments(self, grads, states, step):
        """Advance the moments in place; return ``(m_hat, v_hat)``."""
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
        return torch._foreach_div(m, c1), torch._foreach_div(v, c2)

    def _scaled_moments(self, grads, states, lr, step):
        """Advance the moments in place; return ``lr * m_hat / (sqrt(v_hat)
        + eps)`` per parameter, in float32 (JAX's lr is a float32 array,
        which promotes a bf16 work's product)."""
        mhat, vhat = self._moments(grads, states, step)
        torch._foreach_sqrt_(vhat)               # fresh tensors: in place
        torch._foreach_add_(vhat, self._epsilon)
        upd = [x.float() for x in mhat]          # mhat itself if fp32
        del mhat
        torch._foreach_mul_(upd, _r32(lr))
        torch._foreach_div_(upd, vhat)
        return upd

    def _update(self, works, grads, states, lr, step, extras):
        upd = self._scaled_moments(grads, states, lr, step)
        torch._foreach_sub_(works, [u.to(w.dtype)
                                    for u, w in zip(upd, works)])


class AdamW(Adam):
    """Adam with decoupled weight decay:
    ``p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps)``, computed in
    float32 (on the master, or on a float32 copy of a low-precision
    parameter kept without one), then cast to the parameter's dtype.  A
    ``weight_decay`` that is not a number means 0.01, as in the JAX class
    (which also reads an int that way; here an int is a number).  A
    parameter whose name (module docstring) ``apply_decay_param_fun``
    refuses gets wd 0; ``lr_ratio`` is accepted and unused, as in JAX."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = (float(weight_decay)
                    if isinstance(weight_decay, (int, float))
                    and not isinstance(weight_decay, bool) else 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_for(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(self._param_names()[id(p)]):
            return 0.0
        return self._wd

    def _update(self, works, grads, states, lr, step, extras):
        upd = self._scaled_moments(grads, states, lr, step)
        decay_of = {wd: float(1 - _f32(lr) * _f32(wd)) for wd in set(extras)}
        decays = [decay_of[wd] for wd in extras]
        wide = [w.float() for w in works]     # the works themselves if fp32
        torch._foreach_mul_(wide, decays)
        torch._foreach_sub_(wide, upd)
        for w, x in zip(works, wide):
            if x is not w:
                w.copy_(x)


class Adamax(Optimizer):
    """``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``;
    ``p - lr / (1 - b1^t) * m / (u + eps)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _state_spec(self, work):
        return {"moment": torch.zeros_like(work),
                "inf_norm": torch.zeros_like(work)}

    def _update(self, works, grads, states, lr, step, extras):
        b1, b2 = self._beta1, self._beta2
        m = [s["moment"] for s in states]
        u = [s["inf_norm"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_abs(grads))
        t = _f32(float(step))
        scale = float(_f32(lr) / (1 - _f32(b1) ** t))
        upd = torch._foreach_mul([x.float() for x in m], scale)
        torch._foreach_div_(upd, torch._foreach_add(u, self._epsilon))
        _sub_wide(works, upd)


class Adagrad(Optimizer):
    """``acc = acc + g^2``; ``p - lr g / (sqrt(acc) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 initial_accumulator_value=0.0, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _state_spec(self, work):
        return {"moment": torch.full_like(work, self._init_acc)}

    def _update(self, works, grads, states, lr, step, extras):
        acc = [s["moment"] for s in states]
        torch._foreach_addcmul_(acc, grads, grads)
        upd = torch._foreach_mul([g.float() for g in grads], _r32(lr))
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_div_(upd, denom)
        _sub_wide(works, upd)


class Adadelta(Optimizer):
    """``E[g^2] = rho E[g^2] + (1 - rho) g^2``, ``d = sqrt(E[d^2] + eps)
    / sqrt(E[g^2] + eps) g``, ``E[d^2] = rho E[d^2] + (1 - rho) d^2``;
    ``p - lr d``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._epsilon, self._rho = epsilon, rho

    def _state_spec(self, work):
        return {"avg_sq_grad": torch.zeros_like(work),
                "avg_sq_update": torch.zeros_like(work)}

    def _update(self, works, grads, states, lr, step, extras):
        rho, eps = self._rho, self._epsilon
        asg = [s["avg_sq_grad"] for s in states]
        asu = [s["avg_sq_update"] for s in states]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, grads, grads, value=1 - rho)
        upd = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        torch._foreach_div_(upd, torch._foreach_sqrt(
            torch._foreach_add(asg, eps)))
        torch._foreach_mul_(upd, grads)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1 - rho)
        _sub_wide(works, torch._foreach_mul([d.float() for d in upd],
                                            _r32(lr)))


class RMSProp(Optimizer):
    """``ms = rho ms + (1 - rho) g^2`` (centered: also ``mg = rho mg +
    (1 - rho) g`` and ``ms - mg^2`` under the root); ``mom = momentum mom
    + lr g / sqrt(ms + eps)``; ``p - mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _state_spec(self, work):
        spec = {"mean_square": torch.zeros_like(work),
                "momentum": torch.zeros_like(work)}
        if self._centered:
            spec["mean_grad"] = torch.zeros_like(work)
        return spec

    def _update(self, works, grads, states, lr, step, extras):
        rho = self._rho
        ms = [s["mean_square"] for s in states]
        mom = [s["momentum"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, grads, grads, value=1 - rho)
        if self._centered:
            mg = [s["mean_grad"] for s in states]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(grads, 1 - rho))
            inner = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
        else:
            inner = ms
        denom = torch._foreach_sqrt(torch._foreach_add(inner, self._epsilon))
        step_ = torch._foreach_mul([g.float() for g in grads], _r32(lr))
        torch._foreach_div_(step_, denom)
        torch._foreach_mul_(mom, self._momentum)
        torch._foreach_add_(mom, [x.to(m.dtype) for x, m in zip(step_, mom)])
        _sub_wide(works, mom)


class Lamb(Optimizer):
    """Adam's normalised step plus ``wd p``, scaled by the trust ratio
    ``||p|| / ||r||`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn`` is kept and unused, as in JAX."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    _state_spec = Adam._state_spec
    _moments = Adam._moments

    def _update(self, works, grads, states, lr, step, extras):
        mhat, vhat = self._moments(grads, states, step)
        r = torch._foreach_sqrt(vhat)
        torch._foreach_add_(r, self._epsilon)
        r = torch._foreach_div(mhat, r)
        torch._foreach_add_(r, torch._foreach_mul(works, self._wd))
        w_norm = torch._foreach_norm(works)
        r_norm = torch._foreach_norm(r)
        upd = []
        for x, wn, rn in zip(r, w_norm, r_norm):
            trust = torch.where((wn > 0) & (rn > 0), wn / rn,
                                torch.ones_like(wn))
            upd.append((_f32(lr).to(trust.device) * trust) * x)
        _sub_wide(works, upd)


class Lars(Momentum):
    """LARS: a local rate ``coeff ||p|| / (||g|| + wd ||p|| + 1e-12)``
    (1 where either norm is 0) on ``g + wd p``, into the velocity;
    ``p - v``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 name=None, multi_precision=True):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, name, multi_precision)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _update(self, works, grads, states, lr, step, extras):
        wd = self._lars_wd
        w_norm = torch._foreach_norm(works)
        g_norm = torch._foreach_norm(grads)
        eff = torch._foreach_add(grads, torch._foreach_mul(works, wd))
        v = [s["velocity"] for s in states]
        torch._foreach_mul_(v, self._momentum)
        for vi, e, wn, gn in zip(v, eff, w_norm, g_norm):
            local = torch.where(
                (wn > 0) & (gn > 0),
                self._lars_coeff * wn / (gn + wd * wn + 1e-12),
                torch.ones_like(wn))
            vi.add_(((_f32(lr).to(local.device) * local) * e).to(vi.dtype))
        _sub_wide(works, v)
