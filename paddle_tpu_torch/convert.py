"""Carry weights across from the JAX package as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(d: dict, device=None, dtype=torch.float32) -> dict:
    """{name: np.ndarray} keyed like the JAX ``LLMEngine._param_arrays()``
    (the stacked block weights plus ``wte``, ``wpe``, ``lnf_w``,
    ``lnf_b``) -> {name: tensor} on ``device`` in ``dtype``, ready for
    `GPTForCausalLM.load_params`."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(a)).to(
        device=dev, dtype=dtype) for name, a in d.items()}


def params_to_numpy(model) -> dict:
    """The inverse of `params_from_numpy`: {name: float32 np.ndarray} of
    ``model.param_arrays()``, keyed the same way, copied to the host."""
    return {name: t.detach().float().cpu().numpy().copy()
            for name, t in model.param_arrays().items()}
