"""Neural-network functions and layers of the port."""
from . import functional
from .layer import Embedding, LayerNorm, Linear

__all__ = ["functional", "Embedding", "LayerNorm", "Linear"]
