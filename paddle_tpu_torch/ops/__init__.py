"""Array-level ops of the port: each module pairs a CUDA kernel wrapper
with its plain PyTorch version (`*_reference`)."""
from .flash_attention import (FlashAttention, flash_attention_arrays,
                              flash_attention_bwd_reference, mha_reference)
from .flash_decode import (cached_attention_arrays, flash_decode_arrays,
                           flash_decode_reference)
from .fused_decode import (fused_decode_layer_arrays,
                           fused_decode_layer_reference)
from .fused_mlp import (fused_ffn_arrays, fused_ffn_reference,
                        fused_layernorm_arrays, fused_layernorm_bwd,
                        fused_layernorm_bwd_reference,
                        fused_layernorm_reference, maybe_fused_ffn)
from .paged_attention import (paged_attention_arrays,
                              paged_cache_update_arrays,
                              paged_gather_kv_arrays,
                              quantized_cache_update_arrays,
                              quantized_gather_kv_arrays, slot_mapping)
from .ragged_paged_attention import (ragged_paged_attention_arrays,
                                     ragged_paged_attention_reference)
from . import (flash_attention, flash_decode, fused_decode, fused_mlp,
               ragged_paged_attention, threefry)

__all__ = ["flash_attention_arrays", "mha_reference", "FlashAttention",
           "flash_attention_bwd_reference",
           "cached_attention_arrays", "flash_decode_arrays",
           "flash_decode_reference", "fused_decode_layer_arrays",
           "fused_decode_layer_reference", "fused_layernorm_arrays",
           "fused_layernorm_reference", "fused_layernorm_bwd",
           "fused_layernorm_bwd_reference", "fused_ffn_arrays",
           "fused_ffn_reference", "maybe_fused_ffn",
           "paged_attention_arrays", "paged_cache_update_arrays",
           "paged_gather_kv_arrays", "quantized_cache_update_arrays",
           "quantized_gather_kv_arrays", "slot_mapping",
           "ragged_paged_attention_arrays",
           "ragged_paged_attention_reference", "launch_counts",
           "reset_launch_counts", "add_launches"]

# every launch wrapper: a module or object with KERNEL and launches
_KERNELS = (flash_attention, flash_attention.masked, flash_attention.segs,
            flash_attention.noncausal, flash_attention.tc,
            flash_attention.tc16, flash_attention.tc32,
            flash_attention.d256, flash_attention.simt,
            flash_attention.wide, flash_attention.wide_tc,
            flash_attention.flash_bwd_dq,
            *flash_attention.flash_bwd_dq.variants.values(),
            *flash_attention.flash_bwd_dq.types.values(),
            flash_attention.flash_bwd_dq.d256,
            flash_attention.flash_bwd_dq.simt,
            flash_attention.flash_bwd_dq.wide,
            flash_attention.flash_bwd_dkv,
            *flash_attention.flash_bwd_dkv.variants.values(),
            *flash_attention.flash_bwd_dkv.types.values(),
            flash_attention.flash_bwd_dkv.d256,
            flash_attention.flash_bwd_dkv.simt,
            flash_attention.flash_bwd_dkv.wide,
            flash_attention.flash_bwd_dkv.wide_tc,
            ragged_paged_attention, ragged_paged_attention.int8,
            ragged_paged_attention.fp16, ragged_paged_attention.int8_fp16,
            ragged_paged_attention.d256, ragged_paged_attention.int8_d256,
            flash_decode, flash_decode.fp16, flash_decode.d256, fused_decode,
            fused_decode.d256, fused_mlp.ln_fwd,
            fused_mlp.ln_bwd, fused_mlp.ffn_fwd, fused_mlp.ffn_tc,
            fused_mlp.ffn_tc32, fused_mlp.ffn_decode, fused_mlp.ln_fwd16,
            fused_mlp.ln_bwd16, fused_mlp.ffn_fwd16, fused_mlp.ffn_tc16,
            fused_mlp.ffn_decode16, threefry)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} for every wrapper."""
    return {m.KERNEL: m.launches for m in _KERNELS}


def reset_launch_counts() -> None:
    for m in _KERNELS:
        m.launches = 0


def add_launches(counts: dict) -> None:
    """Add ``{kernel name: launches}`` to the wrappers' counts: the
    launches a CUDA-graph replay runs, which no wrapper counts
    (`paddle_tpu_torch.graphs`)."""
    for m in _KERNELS:
        m.launches += counts.get(m.KERNEL, 0)
