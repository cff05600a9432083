"""Decode steps as CUDA graphs — the port's counterpart of the JAX
package's fixed-shape compiled step programs: the engine's
``ragged(max_num_seqs, 1)`` decode program (`_get_ragged_exec`,
`paddle_tpu/serving/engine.py:1704-1738`) and the decode loop that
``generate`` compiles once per shape key (`gpt.py:1188-1192`).

A `StepGraph` wraps a step function that reads and writes only tensors
that outlive it (static inputs, the KV rings or pools, the weights) and
returns its outputs.  On a CUDA device, unless ``PTPU_CUDA_GRAPHS=0``:
the step's first call runs it eagerly, the warm-up that builds and loads
the kernels' libraries and sizes the kernels' kept buffers
(`ops._build`); the next call captures it as one `torch.cuda.CUDAGraph`,
and that call and every later one replays the graph and returns the
captured outputs, overwritten in place.  Elsewhere (the CPU, or the
switch at 0) every call runs the step eagerly: the same code over the
same static buffers.  A failed capture or replay raises; nothing falls
back to the eager step.

Python's garbage collector is held off during a capture.  Callers drop
engines and models that hold captured graphs, and such an object lives
in a reference cycle (its steps refer back to it), so it is freed by a
collection, which can fall at any allocation.  Freeing a graph during
another's capture is a CUDA call the capture forbids: the capture
fails.

The kernel wrappers count their launches in Python, which a replay does
not run: the capture's counts are taken back, and added again at every
replay, so that `ops.launch_counts()` keeps counting launches run.

`tracing()` tells host telemetry that reads device values (the MoE
routing counts) or counts calls (``lowbit/dequant_calls``) whether it
runs where the JAX package runs a traced program: inside ``generate``
(`traced`; JAX compiles it as one program) or a stream capture.  There
it records nothing, as JAX's telemetry sees only tracers.
"""
from __future__ import annotations

import contextlib
import gc
import os
import threading
import time

import torch

from . import ops

__all__ = ["ENV", "graphs_on", "StepGraph", "traced", "tracing"]

ENV = "PTPU_CUDA_GRAPHS"

_traced = threading.local()


@contextlib.contextmanager
def traced():
    """Mark the code inside as one traced program of the JAX package
    (``generate``) for `tracing`."""
    depth = getattr(_traced, "depth", 0)
    _traced.depth = depth + 1
    try:
        yield
    finally:
        _traced.depth = depth


def tracing() -> bool:
    """True inside `traced` or while this thread's CUDA stream captures."""
    return (getattr(_traced, "depth", 0) > 0
            or (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()))


def graphs_on(device) -> bool:
    """True where a step on ``device`` is captured: a CUDA device, and
    ``PTPU_CUDA_GRAPHS`` unset or not ``"0"``."""
    return (torch.device(device).type == "cuda"
            and os.environ.get(ENV, "1") != "0")


class StepGraph:
    """``step()`` run eagerly once, then captured and replayed (module
    docstring).  ``counts``: the owner's ``{kind: captures}``, raised by
    one at each capture; ``on_capture(kind)``, when given, is called
    after each capture (the engine's ``serving/compiles`` counter).
    After a capture, ``launches`` holds the kernel launches of one replay
    and ``capture_ms`` the capture's host time."""

    def __init__(self, step, device, kind, counts, on_capture=None):
        self.step = step
        self.device = torch.device(device)
        self.kind = kind
        self.counts = counts
        self.on_capture = on_capture
        self.warm = False
        self.graph = None
        self.outputs = None
        self.launches: dict = {}
        self.capture_ms = None

    def __call__(self):
        if not (self.warm and graphs_on(self.device)):
            self.warm = True
            return self.step()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.outputs

    def _capture(self):
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.cuda.graph(graph):
                    outputs = self.step()
                torch.cuda.synchronize()
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        after = ops.launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items()
                         if n != before[k]}
        ops.add_launches({k: -n for k, n in self.launches.items()})
        self.graph, self.outputs = graph, outputs
        self.counts[self.kind] = self.counts.get(self.kind, 0) + 1
        if self.on_capture is not None:
            self.on_capture(self.kind)
