"""paddle_tpu_torch.parallel — what the port has of `paddle_tpu.parallel`:
the mixture-of-experts FFN on one device (`moe`).  The mesh, the
tensor-, sequence-, pipeline- and expert-parallel runtimes need the
distributed runtime and are not ported yet."""
from .moe import moe_capacity, moe_mlp_arrays

__all__ = ["moe_capacity", "moe_mlp_arrays"]
