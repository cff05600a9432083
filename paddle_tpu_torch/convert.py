"""Carry weights across from the JAX package as numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]

# the buffers of a quantized model (`lowbit.WeightOnlyLinear`): int8 or
# uint8 codes and float32 scales, carried in their own dtype
_OWN_DTYPE = (".qweight", ".scale")


def params_from_numpy(d: dict, device=None, dtype=torch.float32) -> dict:
    """{name: np.ndarray} keyed like `GPTForCausalLM.param_arrays` ->
    {name: tensor} on ``device`` in ``dtype``, ready for
    `GPTForCausalLM.load_params`: for the stacked layout the JAX
    ``LLMEngine._param_arrays()`` (the stacked block weights plus ``wte``,
    ``wpe``, ``lnf_w``, ``lnf_b``), for the per-layer layout the JAX
    model's ``state_dict()``; for a model built of `nn.Layer`s (BERT, the
    transformer layers) the JAX model's ``state_dict()`` too, for
    `Layer.set_state_dict`.  A quantized model's ``...qweight`` and
    ``...scale`` keep their own dtype."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(a)).to(
        device=dev, dtype=(None if name.endswith(_OWN_DTYPE) else dtype))
        for name, a in d.items()}


def params_to_numpy(model) -> dict:
    """The inverse of `params_from_numpy`: {name: np.ndarray} of
    ``model.param_arrays()``, keyed the same way, copied to the host;
    float32, but a quantized model's codes and scales in their own
    dtype."""
    return {name: (t.detach() if name.endswith(_OWN_DTYPE)
                   else t.detach().float()).cpu().numpy().copy()
            for name, t in model.param_arrays().items()}
