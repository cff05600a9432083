"""Resilience helpers of the port: the shared `Deadline` budget
(`retry`).  The JAX package's retry policy, checkpoint manager, step
guard and fault injection are not ported yet."""
from .retry import Deadline

__all__ = ["Deadline"]
