"""The `Deadline` of `paddle_tpu/resilience/retry.py` (stdlib only), which
the serving engine reads for ``SamplingParams.deadline_s``.  The module's
``retry`` policy and ``PreemptionHandler`` are not ported yet."""
from __future__ import annotations

import time
from typing import Optional

__all__ = ["Deadline"]


class Deadline:
    """A wall-clock budget that several operations can share.

    `Deadline(None)` never expires — call sites can thread an optional
    deadline without branching.  Monotonic clock: a host NTP step must
    not spuriously expire every holder at once.
    """

    __slots__ = ("seconds", "_expires")

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._expires = None if seconds is None else time.monotonic() + seconds

    @classmethod
    def after(cls, seconds: Optional[float]) -> "Deadline":
        return cls(seconds)

    @property
    def expired(self) -> bool:
        return self._expires is not None and time.monotonic() >= self._expires

    def remaining(self) -> Optional[float]:
        """Seconds left (>= 0), or None for an infinite deadline."""
        if self._expires is None:
            return None
        return max(0.0, self._expires - time.monotonic())

    def remaining_ms(self, cap: int = 2**31 - 1) -> Optional[int]:
        r = self.remaining()
        return None if r is None else min(cap, max(0, int(r * 1000)))

    def check(self, what: str = "operation") -> None:
        if self.expired:
            raise TimeoutError(f"deadline exceeded ({self.seconds}s) in {what}")

    def __repr__(self):
        return f"Deadline(remaining={self.remaining()})"
