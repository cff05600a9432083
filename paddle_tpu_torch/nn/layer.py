"""The layer base — the port of `paddle_tpu/nn/layer.py` (`Layer`,
`Parameter`, `ParamAttr`).

`Layer` is a `torch.nn.Module` with Paddle's names on top, so a layer of
the port is a module to everything in torch (autograd, `state_dict`,
``.to``, hooks, `torch.utils.checkpoint`) and a Paddle layer to code
written against the JAX package:

- construction: `create_parameter` (a `ParamAttr`'s initializer, else the
  global one of `initializer.set_global_initializer`, else the layer's
  default, else XavierNormal for weights and zeros for biases, as JAX
  chooses), `add_parameter`, `add_sublayer`, ``register_buffer(name,
  tensor, persistable=True)``;
- traversal: `named_sublayers`, `sublayers`, ``parameters(
  include_sublayers)`` (a list, as in JAX), `named_parameters`,
  `children`, `named_children`, `buffers`;
- state: `state_dict` / `set_state_dict` (``load_dict``) under JAX's
  structured names (``encoder.layers.0.self_attn.q_proj.weight``);
  `set_state_dict` takes tensors or numpy arrays (the JAX model's
  ``state_dict()`` as numpy), copies them into the parameters in their
  own dtype and device, and returns ``(missing, unexpected)``;
- ``train`` / ``eval``, ``to(device, dtype)`` with Paddle dtype names,
  ``astype`` / ``float`` / ``bfloat16`` / ``half``,
  `register_forward_pre_hook` / `register_forward_post_hook`,
  `clear_gradients`, `full_name`, ``extra_repr``.

A parameter is created on ``device`` (keyword-only; None means ``cuda``,
as every entry point of the port) in ``dtype`` (the layer's, float32
unless given).  ``ParamAttr(trainable=False)`` gives ``requires_grad``
False.  ``ParamAttr.learning_rate`` is kept in the parameter's
``optimize_attr``, which the JAX optimizer does not read, so neither does
the port's.
"""
from __future__ import annotations

import collections
import copy

import numpy as np
import torch
from torch import nn

from .initializer import (Constant, Initializer, XavierNormal,
                          _global_init_for, to_dtype)

__all__ = ["Layer", "Parameter", "ParamAttr"]


class Parameter(nn.Parameter):
    """A `torch.nn.Parameter` with Paddle's attributes: ``trainable``
    (``requires_grad``), ``optimize_attr`` (``{"learning_rate": ...}``),
    ``regularizer``, ``is_distributed`` and ``name``.  A deep copy keeps
    them (`TransformerEncoder` copies its layer)."""

    def __new__(cls, data=None, requires_grad=True):
        return super().__new__(cls, data, requires_grad)

    def __init__(self, data=None, requires_grad=True):
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.is_distributed = False

    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __repr__(self):
        return (f"Parameter(name={self.name}, shape={list(self.shape)}, "
                f"dtype={self.dtype}, trainable={self.trainable})\n"
                f"       {self.data!r}")


class ParamAttr:
    """Mirror of paddle.ParamAttr (subset: name / initializer / lr / trainable)."""

    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        need_clip=True,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"invalid ParamAttr: {attr!r}")


_name_counter = collections.defaultdict(int)


def _unique_name(prefix):
    n = _name_counter[prefix]
    _name_counter[prefix] += 1
    return f"{prefix}_{n}"


def _as_tensor(value):
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.array(value))


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = to_dtype(dtype) or torch.float32
        self._full_name = _unique_name(
            name_scope or self.__class__.__name__.lower())

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None):
        """A new `Parameter` of ``shape`` on ``device`` (None: ``cuda``),
        drawn by the initializer JAX picks (module docstring); ``generator``
        reaches the normal initializers (`initializer`).  None where
        ``attr`` is False."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = to_dtype(dtype) or self._dtype
        init = (attr.initializer or _global_init_for(is_bias)
                or default_initializer
                or (Constant(0.0) if is_bias else XavierNormal()))
        data = init(tuple(int(s) for s in shape), dtype, device=device,
                    generator=generator)
        p = Parameter(data, requires_grad=attr.trainable)
        p.name = attr.name or _unique_name(self._full_name + ".w")
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        """torch's `register_buffer`; ``persistable`` is Paddle's name for
        ``persistent``.  Returns the tensor, as JAX does."""
        super().register_buffer(name, tensor, persistable)
        return tensor

    # -- traversal ---------------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            if id(layer) in layers_set:
                continue
            layers_set.add(id(layer))
            yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix=prefix, recurse=recurse,
                                        remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        """A list, as in JAX."""
        recurse = include_sublayers if recurse is None else recurse
        return list(super().parameters(recurse=recurse))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix=prefix, recurse=recurse,
                                     remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        recurse = include_sublayers if recurse is None else recurse
        return list(super().buffers(recurse=recurse))

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   use_hook=True, *, prefix="", keep_vars=False):
        """JAX's structured names -> tensors (detached unless
        ``keep_vars``), as JAX orders them: the parameters (a parameter
        held under two names once, under the first), then the persistable
        buffers.  A torch parent's recursive call (``destination`` given)
        gets torch's own form."""
        if destination is not None:
            return super().state_dict(destination=destination, prefix=prefix,
                                      keep_vars=keep_vars)
        dest = collections.OrderedDict()
        own = lambda t: t if keep_vars else t.detach()      # noqa: E731
        for name, p in self.named_parameters(
                include_sublayers=include_sublayers):
            dest[prefix + name] = own(p)
        layers = (self.named_modules() if include_sublayers
                  else [("", self)])
        for pfx, layer in layers:
            for name, b in layer._buffers.items():
                if b is not None and \
                        name not in layer._non_persistent_buffers_set:
                    dest[prefix + (f"{pfx}.{name}" if pfx else name)] = \
                        own(b)
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into the
        parameters and buffers of the same names, each in its own dtype
        and device; a shape that differs raises.  Returns ``(missing,
        unexpected)`` names."""
        own = self.state_dict(keep_vars=True)
        missing, unexpected = [], []
        with torch.no_grad():
            for name, t in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                src = _as_tensor(state_dict[name])
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: ckpt "
                        f"{tuple(src.shape)} vs model {tuple(t.shape)}")
                t.copy_(src.to(device=t.device, dtype=t.dtype))
        unexpected = [k for k in state_dict if k not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype / device ----------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's ``to``; a Paddle dtype name (``"bfloat16"``) is taken as
        a dtype, ``blocking`` is accepted and unused.  New parameters take
        the dtype too, as in JAX."""
        kwargs.pop("blocking", None)
        args = tuple(to_dtype(a) if isinstance(a, str) and _is_dtype(a)
                     else a for a in args)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = to_dtype(kwargs["dtype"])
        dtype = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dtype is not None:
            for l in self.sublayers(include_self=True):
                if isinstance(l, Layer):
                    l._dtype = dtype
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def half(self):
        return self.to(dtype=torch.float16)

    # -- hooks -------------------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``, after the forward; a result
        other than None replaces the outputs."""
        return self.register_forward_hook(hook)

    # -- misc --------------------------------------------------------------
    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None


def _is_dtype(name):
    try:
        to_dtype(name)
    except KeyError:
        return False
    return True
