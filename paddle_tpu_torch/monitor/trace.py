"""Structured span tracing — the port of `paddle_tpu/monitor/trace.py`:
the *where did the time go* half of the monitor (the registry is the
*how much / how many* half).

A span is one timed operation with identity: ``trace_id`` groups every
span of one logical unit of work (a serving request), ``span_id`` names
the span, ``parent_id`` links it under its parent so a trace renders as
a tree.  Producers:

- ``with trace.span("serving/prefill", chunk_len=64):`` — context-manager
  spans nest through a thread-local, so a span opened inside another
  becomes its child;
- ``trace.start_span(name, parent=...)`` / ``Span.end()`` — manual spans
  for operations that start and finish in different call frames (a
  serving request lives across many engine steps);
- ``trace.attach(span)`` — adopt an existing span as this thread's
  current one, so work on another thread lands in the right trace;
- ``trace.inject()`` / ``trace.extract(header)`` — serialize the current
  span's (trace_id, span_id) into a traceparent-style header and parse
  it back into a :class:`SpanContext` in another process.

Design constraints (shared with the registry):

- **near-zero cost when disabled**: ``span()`` is one module-global read
  and returns a no-op singleton.  Gate: ``PTPU_TRACE=1`` (default OFF).
- **stdlib only**: importing it never imports torch.
- **bounded memory**: finished spans land in the flight-recorder ring
  (`monitor.flight`) and in a per-trace store capped at
  ``PTPU_TRACE_MAX_TRACES`` traces (oldest evicted), which backs
  ``LLMEngine.request_trace(rid)`` and the ``/traces/<id>`` endpoint.
- **tail-based sampling** (``PTPU_TRACE_TAIL=<n>``): the keep decision
  is deferred to the root span's end.  Interesting traces (an errored
  span, a root that finished other than ``"stop"``, or a root stamped
  ``keep=True``, as the engine stamps SLO-violating requests) are always
  kept; the others only while the per-60-s budget of ``n`` lasts.  The
  flight ring still sees every span.  Unset keeps everything; ``0`` keeps
  only interesting traces.
- **liveness**: `heartbeat` marks progress (every span end and every
  engine step); `last_activity_age` feeds ``/healthz`` and the flight
  recorder's stall `watchdog`.

Timestamps use ``time.perf_counter_ns``.  ``export_chrome_trace()``
writes the stored spans as a Chrome / Perfetto trace; the JAX package
merges its profiler's host events there, and the port has no such
tracer yet (``profiler/``, ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict

__all__ = [
    "Span", "SpanContext", "span", "start_span", "current_span", "attach",
    "inject", "extract", "get_trace",
    "trace_ids", "chrome_events", "export_chrome_trace", "enabled",
    "enable", "refresh", "reset", "heartbeat", "last_activity_age",
    "tail_budget", "set_tail_budget",
]


def _env_enabled() -> bool:
    return os.environ.get("PTPU_TRACE", "0").strip().lower() not in (
        "0", "false", "off", "")


_enabled = _env_enabled()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip span collection on/off at runtime (overrides PTPU_TRACE)."""
    global _enabled
    _enabled = bool(on)


def refresh():
    """Re-read PTPU_TRACE (+ PTPU_TRACE_TAIL) from the environment."""
    global _enabled, _tail_budget
    _enabled = _env_enabled()
    _tail_budget = _env_tail()


# -- identity ---------------------------------------------------------------
# ids are "<run>-<n>": unique within the process and cheap to mint (one
# itertools.count() next, no urandom per span); the run prefix keeps ids
# from colliding across processes in one flight dir.
_RUN = f"{os.getpid():x}{time.time_ns() & 0xFFFFFF:06x}"
_ids = itertools.count(1)


def _next_id(prefix: str = "s") -> str:
    return f"{prefix}{_RUN}-{next(_ids):x}"


# -- liveness (the watchdog's signal) ---------------------------------------
_last_beat = [time.monotonic()]


def heartbeat() -> None:
    """Mark forward progress.  Called on every span end and by step loops
    directly (``LLMEngine.step``), so the watchdog sees progress even
    with tracing disabled."""
    _last_beat[0] = time.monotonic()


def last_activity_age() -> float:
    """Seconds since the last heartbeat (span end / step completion)."""
    return time.monotonic() - _last_beat[0]


# -- the span ---------------------------------------------------------------

class Span:
    """One timed operation.  Mutable until ``end()``; recorded (trace
    store + flight ring) exactly once, at end."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "ts_us", "dur_us", "tid", "_done")

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.perf_counter_ns()
        self.ts_us = self._t0 / 1000.0   # RecordEvent's timebase
        self.dur_us = None
        self.tid = threading.get_ident() % 1_000_000
        self._done = False

    def end(self, **attrs) -> "Span":
        """Close the span (idempotent) and record it.  Late attributes
        (token counts, finish reason) merge into ``attrs`` here."""
        if self._done:
            return self
        self._done = True
        self.dur_us = (time.perf_counter_ns() - self._t0) / 1000.0
        if attrs:
            self.attrs.update(attrs)
        _record(self)
        heartbeat()
        return self

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts_us": self.ts_us,
            "dur_us": self.dur_us,
            "tid": self.tid,
            "attrs": dict(self.attrs),
        }

    def __repr__(self):
        state = f"{self.dur_us:.1f}us" if self._done else "open"
        return f"Span({self.name}, {self.span_id}, {state})"


class _NullSpan:
    """The disabled fast path: every producer API returns this singleton,
    whose methods are no-ops (attribute constants keep reads safe)."""

    __slots__ = ()
    name = trace_id = span_id = parent_id = None
    dur_us = ts_us = None

    def end(self, **attrs):
        return self

    def to_dict(self):
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False   # `if req.trace:` guards stay cheap and correct


_NULL = _NullSpan()


# -- storage ----------------------------------------------------------------
_MAX_TRACES = int(os.environ.get("PTPU_TRACE_MAX_TRACES", "256"))
_traces: "OrderedDict[str, list]" = OrderedDict()
_store_lock = threading.Lock()


# -- tail-based sampling ----------------------------------------------------

def _env_tail() -> "int | None":
    raw = os.environ.get("PTPU_TRACE_TAIL", "").strip()
    if not raw or raw.lower() in ("off", "false"):
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        return None


_tail_budget = _env_tail()      # None = sampling off (keep everything)
_TAIL_WINDOW_S = 60.0
# [window start (monotonic), boring traces kept this window]; mutated
# only under _store_lock
_tail_state = [0.0, 0]


def tail_budget() -> "int | None":
    """The boring-traces-kept-per-minute budget (None = sampling off)."""
    return _tail_budget


def set_tail_budget(budget: "int | None") -> None:
    """Set/clear the tail-sampling budget at runtime (overrides
    PTPU_TRACE_TAIL; None disables sampling, 0 keeps only interesting
    traces)."""
    global _tail_budget
    _tail_budget = None if budget is None else max(0, int(budget))


def _interesting(spans, root) -> bool:
    """Always-keep predicate, evaluated with the FULL trace in hand."""
    attrs = root["attrs"]
    if attrs.get("error") or attrs.get("keep"):
        return True
    fin = attrs.get("finish")
    if fin is not None and fin != "stop":
        return True
    for d in spans:
        if d["attrs"].get("error"):
            return True
    return False


def _tail_keep(spans, root) -> bool:
    """Keep decision for one finished root (call under _store_lock)."""
    if _interesting(spans, root):
        return True
    now = time.monotonic()
    if now - _tail_state[0] >= _TAIL_WINDOW_S:
        _tail_state[0] = now
        _tail_state[1] = 0
    if _tail_state[1] < _tail_budget:
        _tail_state[1] += 1
        return True
    return False


def _record(s: Span) -> None:
    d = s.to_dict()
    dropped = False
    with _store_lock:
        spans = _traces.get(s.trace_id)
        if spans is None:
            spans = _traces[s.trace_id] = []
            while len(_traces) > _MAX_TRACES:
                _traces.popitem(last=False)
        spans.append(d)
        # root ended → the trace is complete; with sampling on, decide
        # NOW whether the whole tree stays in the store
        if _tail_budget is not None and s.parent_id is None:
            if not _tail_keep(spans, d):
                _traces.pop(s.trace_id, None)
                dropped = True
    from . import flight

    flight.record_span(d)
    if _tail_budget is not None and s.parent_id is None:
        from . import counter

        if dropped:
            counter("trace/tail_dropped",
                    "boring traces dropped by tail sampling").inc()
        else:
            counter("trace/tail_kept",
                    "traces kept by tail sampling").inc()


def get_trace(trace_id: str) -> list:
    """Every finished span of one trace (start-ordered span dicts);
    [] for an unknown/evicted id."""
    with _store_lock:
        spans = list(_traces.get(trace_id, ()))
    return sorted(spans, key=lambda d: d["ts_us"])


def trace_ids() -> list:
    """Known trace ids, oldest first."""
    with _store_lock:
        return list(_traces)


def reset() -> None:
    """Drop every stored trace (tests)."""
    with _store_lock:
        _traces.clear()


# -- context propagation ----------------------------------------------------

class SpanContext:
    """Span *identity* without the span: what travels on a wire.  An
    ``extract()``-ed context carries only (trace_id, span_id); it can be
    adopted with :class:`attach` or passed as ``parent=`` so work in a
    DIFFERENT process lands as a child in the originating trace.  It is
    never recorded itself — only real spans are."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}, {self.span_id})"


# traceparent-style header: "<version>;<trace_id>;<span_id>".  ";" because
# our ids themselves contain "-" (W3C traceparent's separator).
_CTX_VERSION = "ptpu1"


def inject(span_=None) -> "str | None":
    """Serialize the current (or given) span's context for the wire —
    the client half of cross-process propagation.  Returns None when
    tracing is disabled or there is no open span, so a disabled caller
    attaches nothing (allocation-free, as a disabled ``span()``)."""
    if not _enabled:
        return None
    s = _ctx.span if span_ is None else span_
    if s is None or s.trace_id is None:
        return None
    return f"{_CTX_VERSION};{s.trace_id};{s.span_id}"


def extract(header) -> "SpanContext | None":
    """Parse an :func:`inject`-ed header back into a SpanContext — the
    server half.  None for a missing/foreign/malformed header, and when
    tracing is disabled here (a receiver with PTPU_TRACE=0 must not pay
    for a sender's tracing).  The no-header path is allocation-free."""
    if not _enabled or not header:
        return None
    parts = header.split(";")
    if len(parts) != 3 or parts[0] != _CTX_VERSION \
            or not parts[1] or not parts[2]:
        return None
    return SpanContext(parts[1], parts[2])


class _Ctx(threading.local):
    span = None


_ctx = _Ctx()


def current_span():
    """The innermost open span() on THIS thread (None outside any)."""
    return _ctx.span


class attach:
    """Adopt `parent` — a Span from another thread, or a SpanContext
    ``extract()``-ed from another process — as this thread's current::

        ctx = trace.current_span()          # producer thread
        ...
        with trace.attach(ctx):             # worker thread
            with trace.span("load_batch"):  # lands under ctx's trace
                ...
    """

    __slots__ = ("_span", "_prev")

    def __init__(self, span_):
        self._span = span_ if isinstance(span_, (Span, SpanContext)) \
            else None

    def __enter__(self):
        self._prev = _ctx.span
        if self._span is not None:
            _ctx.span = self._span
        return self._span

    def __exit__(self, *exc):
        _ctx.span = self._prev
        return False


def start_span(name: str, parent=None, trace_id=None, **attrs):
    """Manual span (caller owns ``end()``).  ``parent`` may be a Span or
    a cross-process SpanContext; with neither parent nor trace_id a NEW
    trace is opened (the span is its root).  Returns the no-op singleton
    when tracing is disabled."""
    if not _enabled:
        return _NULL
    parent_id = None
    if isinstance(parent, (Span, SpanContext)):
        parent_id = parent.span_id
        trace_id = trace_id or parent.trace_id
    if trace_id is None:
        trace_id = _next_id("t")
    return Span(name, trace_id, parent_id, attrs)


class _Active:
    """span()'s handle: installs the span as the thread-local current on
    enter, restores the previous on exit, ends with error annotation."""

    __slots__ = ("_span", "_prev")

    def __init__(self, s):
        self._span = s

    def __enter__(self):
        self._prev = _ctx.span
        _ctx.span = self._span
        return self._span

    def __exit__(self, etype, evalue, tb):
        _ctx.span = self._prev
        if etype is not None:
            self._span.end(error=etype.__name__)
        else:
            self._span.end()
        return False


def span(name: str, **attrs):
    """Context-manager span, auto-parented under the thread's current
    span (a new trace when there is none)::

        with trace.span("resilience/ckpt_save", step=10):
            ...
    """
    if not _enabled:
        return _NULL
    return _Active(start_span(name, parent=_ctx.span, **attrs))


# -- chrome/Perfetto export -------------------------------------------------

def chrome_events(trace_id=None) -> list:
    """Finished spans as chrome ``trace_event`` dicts (phase "X").
    Identity rides ``args`` so Perfetto's flow/query UI can group by
    trace_id; ts/dur are in µs on the perf_counter timebase — the SAME
    base as profiler.RecordEvent host events."""
    pid = os.getpid()
    with _store_lock:
        if trace_id is not None:
            groups = [list(_traces.get(trace_id, ()))]
        else:
            groups = [list(v) for v in _traces.values()]
    out = []
    for spans in groups:
        for d in spans:
            args = {"trace_id": d["trace_id"], "span_id": d["span_id"]}
            if d["parent_id"]:
                args["parent_id"] = d["parent_id"]
            args.update(d["attrs"])
            out.append({
                "name": d["name"], "ph": "X", "ts": d["ts_us"],
                "dur": d["dur_us"] or 0.0, "pid": pid, "tid": d["tid"],
                "args": args,
            })
    return out


def export_chrome_trace(path: str, include_host_tracer: bool = True) -> str:
    """Write every stored span as a Chrome/Perfetto-loadable JSON file.
    ``include_host_tracer`` keeps the JAX signature; the port has no host
    tracer to merge yet (module docstring)."""
    events = chrome_events()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path
