"""Serialization: paddle.save / paddle.load — the port of
`paddle_tpu/framework/io_.py` (reference: python/paddle/framework/io.py:
637,879), in the JAX package's on-disk format: the ``PTPU1`` magic, then a
pickle of nested dicts, lists and ``{"__tuple__": [...]}`` with numpy
leaves ``{"__tensor__": array}``, bfloat16 stored as its ``uint16`` bits
``{"__tensor_bf16__": array}``.  A file written by either package loads in
the other, bit for bit; the pickle holds only numpy arrays and Python
values, so neither package's types are needed to read it.

`load` returns host tensors, as ``torch.load(map_location="cpu")``
would; the caller copies them to the card (``load_state_dict``,
``GPTForCausalLM.load_params`` and ``Optimizer.set_state_dict`` do).
With ``return_numpy=True`` a bfloat16 leaf comes back as float32 values
(exact: numpy has no bfloat16 without ml_dtypes), where the JAX package
returns an ml_dtypes bfloat16 array.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["save", "load"]

_MAGIC = b"PTPU1"


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"__tensor_bf16__": t.view(torch.int16).numpy()
                    .view(np.uint16)}
        return {"__tensor__": t.numpy()}
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else {"__tuple__": packed}
    return obj


def _unpack(obj, return_numpy=False):
    if isinstance(obj, dict):
        if "__tensor__" in obj and len(obj) == 1:
            arr = obj["__tensor__"]
            return arr if return_numpy else torch.from_numpy(np.array(arr))
        if "__tensor_bf16__" in obj and len(obj) == 1:
            bits = np.ascontiguousarray(obj["__tensor_bf16__"])
            t = torch.from_numpy(bits.view(np.int16).copy()).view(
                torch.bfloat16)
            return t.float().numpy() if return_numpy else t
        if "__tuple__" in obj and len(obj) == 1:
            return tuple(_unpack(v, return_numpy) for v in obj["__tuple__"])
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    return obj


def save(obj, path, protocol=4):
    """Write ``obj`` (tensors, numpy arrays and Python values in nested
    dicts, lists and tuples) to ``path``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **kwargs):
    """What `save` wrote (or the JAX package's ``save``): tensors on the
    host, or numpy arrays with ``return_numpy``."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            f.seek(0)
        obj = pickle.load(f)
    return _unpack(obj, return_numpy=return_numpy)
