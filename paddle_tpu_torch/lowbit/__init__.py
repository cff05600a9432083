"""paddle_tpu_torch.lowbit — the port of `paddle_tpu.lowbit`'s weight-only
wing.  One storage convention (`ops.lowbit`: symmetric abs-max,
``dequant = codes * scale``):

- **weight-only quantized inference** (`weight_only.py`) —
  `quantize_for_inference(model, weight_dtype="int8" | "int4")` swaps
  every `nn.Linear` for a `WeightOnlyLinear` (packed codes and
  per-channel scales, the product with fp32 accumulation);
- **quantized KV cache**: ``LLMEngine(EngineConfig(kv_cache_dtype=
  "int8"))`` (`serving`, `ops.paged_attention`).

The quantized collectives of the JAX package's ``comm.py`` are not
ported: they need the distributed runtime.

Monitor series: ``lowbit/bytes_saved{wing}``, ``lowbit/weight_layers``,
``lowbit/kv_blocks{dtype}``, ``lowbit/dequant_calls{site}``.
"""
from .weight_only import WeightOnlyLinear, quantize_for_inference
from ..ops.lowbit import (dequantize_arrays, pack_int4_arrays,
                          qmax_for_bits, quantize_absmax_arrays,
                          quantized_matmul_arrays, unpack_int4_arrays)

__all__ = [
    "WeightOnlyLinear", "quantize_for_inference",
    "quantize_absmax_arrays", "dequantize_arrays", "quantized_matmul_arrays",
    "pack_int4_arrays", "unpack_int4_arrays", "qmax_for_bits",
]
