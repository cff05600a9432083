"""Array-level ops of the port: each module pairs a CUDA kernel wrapper
with its plain PyTorch version (`*_reference`)."""
from .flash_attention import flash_attention_arrays, mha_reference
from .paged_attention import (paged_attention_arrays,
                              paged_cache_update_arrays,
                              paged_gather_kv_arrays, slot_mapping)
from .ragged_paged_attention import (ragged_paged_attention_arrays,
                                     ragged_paged_attention_reference)
from . import flash_attention, ragged_paged_attention

__all__ = ["flash_attention_arrays", "mha_reference",
           "paged_attention_arrays", "paged_cache_update_arrays",
           "paged_gather_kv_arrays", "slot_mapping",
           "ragged_paged_attention_arrays",
           "ragged_paged_attention_reference", "launch_counts",
           "reset_launch_counts"]

_KERNELS = (flash_attention, ragged_paged_attention)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} for every wrapper."""
    return {m.KERNEL: m.launches for m in _KERNELS}


def reset_launch_counts() -> None:
    for m in _KERNELS:
        m.launches = 0
