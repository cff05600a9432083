"""Neural-network functions and layers of the port."""
from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear"]
