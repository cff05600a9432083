"""Neural-network functions of the port."""
from . import functional

__all__ = ["functional"]
