"""High-level training API — the port of `paddle_tpu/hapi/` (reference:
python/paddle/hapi/)."""
from .model import Model, summary
from . import callbacks

__all__ = ["Model", "summary", "callbacks"]
