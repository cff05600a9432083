"""`paddle_tpu/distributed/fleet/utils/` of the port."""
from .recompute import recompute, recompute_sequential

__all__ = ["recompute", "recompute_sequential"]
