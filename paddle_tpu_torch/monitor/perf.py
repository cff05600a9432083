"""Performance attribution, the step-segment half — the port of the
segment timers of `paddle_tpu/monitor/perf.py`.

Named, properly-synced sub-step timers: ``hapi.Model`` splits the eager
train step into forward/backward/optimizer segments.  A segment's
``sync(*tensors)`` names what must be finished on the card when it ends;
its exit waits for the CUDA device of each of them, so the recorded time
is the segment's synced wall time, not its dispatch time.  Each call
lands in a `FnPerf` record (calls, total, best and last wall seconds)
and in the ``perf/segment_time{step,segment}`` and
``perf/step_time{fn}`` histograms.

Gate: ``PTPU_PERF=1`` (default OFF — perf mode syncs at every segment's
end, which perturbs the overlap of host and card; it is a diagnostic
mode, not an always-on tax).  With the gate off every hook is one
module-global read and a shared no-op segment.

The JAX module's other half — XLA cost and memory analyses (``capture``,
``ChipSpec``, MFU, roofline ratios, ``measure``, the report) — comes
with the rest of ``monitor`` (ROADMAP Queue 1 item 8), re-derived from
CUDA events and ``torch.profiler``.

Import constraints (shared with flight/train): importing this module
never imports torch; `_block_until_ready` imports it when a segment
with targets ends.

Exported metrics (the JAX package's names): ``perf/step_time{fn}``
(histogram), ``perf/segment_time{step,segment}`` (histogram).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

__all__ = [
    "enabled", "enable", "refresh", "FnPerf", "observe", "observe_segment",
    "segment", "records", "get", "reset",
]


def _env_enabled() -> bool:
    return os.environ.get("PTPU_PERF", "0").strip().lower() not in (
        "0", "false", "off", "")


_enabled = _env_enabled()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip perf accounting on/off at runtime (overrides PTPU_PERF)."""
    global _enabled
    _enabled = bool(on)


def refresh():
    """Re-read PTPU_PERF from the environment."""
    global _enabled
    _enabled = _env_enabled()


def _registry():
    from . import get_registry

    return get_registry()


class FnPerf:
    """One named segment's (or program's) synced wall times."""

    __slots__ = ("label", "calls", "total_s", "min_s", "last_s")

    def __init__(self, label):
        self.label = label
        self.calls = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.last_s = 0.0

    def add_wall(self, wall_s: float):
        self.calls += 1
        self.total_s += wall_s
        self.min_s = min(self.min_s, wall_s)
        self.last_s = wall_s

    @property
    def best_s(self):
        return self.min_s if self.calls else None


_records: "OrderedDict[str, FnPerf]" = OrderedDict()
_rec_lock = threading.Lock()


def _get_record(label: str) -> FnPerf:
    with _rec_lock:
        rec = _records.get(label)
        if rec is None:
            rec = _records[label] = FnPerf(label)
        return rec


def records() -> list:
    """Every FnPerf record, insertion-ordered."""
    with _rec_lock:
        return list(_records.values())


def get(label: str):
    with _rec_lock:
        return _records.get(label)


def reset():
    """Drop every record (tests)."""
    with _rec_lock:
        _records.clear()


def observe(label: str, wall_s: float):
    """Record one synced call of `label` taking ``wall_s`` seconds."""
    rec = _get_record(label)
    rec.add_wall(wall_s)
    _registry().histogram(
        "perf/step_time",
        "synced wall seconds per analyzed program").labels(
        fn=label).observe(wall_s)
    return rec


def observe_segment(step: str, name: str, wall_s: float):
    """A named sub-step segment's synced wall time (forward/backward/
    optimizer in the eager train step).  Also lands in the ``step:name``
    record."""
    _registry().histogram(
        "perf/segment_time",
        "synced sub-step segment seconds").labels(
        step=step, segment=name).observe(wall_s)
    return observe(f"{step}:{name}", wall_s)


class _NoopSegment:
    """The shared disabled-mode segment: no allocation, no state."""

    __slots__ = ()

    def sync(self, *objs):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SEGMENT = _NoopSegment()


class segment:
    """Properly-synced segment timer::

        with perf.segment("train", "forward") as s:
            loss = model(x)
            s.sync(loss)            # wait for these tensors at exit

    No-op (one global read + a shared singleton) when perf is disabled.
    ``sync()`` collects tensors (or lists / tuples / dicts of them); exit
    waits until their devices are done, so the recorded time is the
    segment's real wall time, not its dispatch time."""

    __slots__ = ("_step", "_name", "_t0", "_targets", "_on")

    def __new__(cls, step: str, name: str):
        if not _enabled:
            return _NOOP_SEGMENT
        return object.__new__(cls)

    def __init__(self, step: str, name: str):
        self._on = True
        self._step = step
        self._name = name
        self._targets = []
        self._t0 = None

    def sync(self, *objs):
        if self._on:
            self._targets.extend(objs)
        return self

    def __enter__(self):
        if self._on:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        if self._targets:
            _block_until_ready(self._targets)
        observe_segment(self._step, self._name,
                        time.perf_counter() - self._t0)
        return False


def _cuda_devices(obj, out):
    """The CUDA devices of the tensors in ``obj`` (nested lists, tuples
    and dict values), added to the set ``out``."""
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _cuda_devices(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, out)
    else:
        dev = getattr(obj, "device", None)
        if getattr(dev, "type", None) == "cuda":
            out.add(dev)


def _block_until_ready(obj):
    """Wait for the CUDA device of each tensor in ``obj`` (host tensors
    are ready when their op returns)."""
    devices = set()
    _cuda_devices(obj, devices)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)
