"""Framework utilities of the port (`paddle_tpu/framework/`): `io_`'s
`save` / `load`."""
from .io_ import load, save

__all__ = ["save", "load"]
