"""Core runtime pieces of the port: the PRNG (`random`)."""
from . import random

__all__ = ["random"]
