"""Wide-event request log — the port of `paddle_tpu/monitor/reqlog.py`:
the *what happened to THIS request* layer.

Metrics aggregate away identity and traces cost a span per operation;
the request log sits between them: ONE structured event per finished
serving request, wide enough to answer routing and debugging questions
without a join — arrival, queue wait, TTFT, TPOT stats, prefill chunks,
prefix-cache hits, speculative accept counts, preemptions, peak KV
blocks and the finish reason, keyed by rid / trace_id / replica_id.

Events land in a bounded in-process ring (served at ``GET
/requests/recent`` by `monitor.serve`) and, when ``PTPU_REQLOG`` names a
file path, in a size-rotated JSONL sink.  The event's keys are
``monitor.wire.REQLOG_EVENT_KEYS``, the JAX package's.

- **default off, near-zero when disabled**: gate ``PTPU_REQLOG``
  (``1``/``on`` = ring only; a path = ring + JSONL).  The engine checks
  :func:`enabled` first — one module-global read; emission happens at
  release time, not per token.
- **stdlib only**, like every sibling.
- **bounded**: the ring holds ``PTPU_REQLOG_RING`` events (default
  256); the JSONL sink rotates at ``PTPU_REQLOG_ROTATE_MB`` (default 16)
  MiB, keeping one ``.1`` predecessor.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .wire import REQLOG_EVENT_KEYS, REQLOG_SCHEMA_VERSION

__all__ = [
    "enabled", "enable", "refresh", "event", "emit", "recent", "reset",
    "sink_path", "REQLOG_EVENT_KEYS", "REQLOG_SCHEMA_VERSION",
]

_DEFAULT_RING = 256
_DEFAULT_ROTATE_MB = 16.0


def _env_value() -> str:
    return os.environ.get("PTPU_REQLOG", "").strip()


def _env_enabled() -> bool:
    return _env_value().lower() not in ("", "0", "false", "off")


def _env_sink() -> "str | None":
    v = _env_value()
    if not _env_enabled():
        return None
    # "1"/"on"/"true" = ring only; anything else is a sink path
    return None if v.lower() in ("1", "true", "on") else v


_enabled = _env_enabled()
_sink_path = _env_sink()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True, sink: "str | None" = None):
    """Flip event collection on/off at runtime (overrides PTPU_REQLOG).
    ``sink`` sets/clears the JSONL path when given (None keeps it)."""
    global _enabled, _sink_path
    _enabled = bool(on)
    if sink is not None:
        _set_sink(sink or None)


def refresh():
    """Re-read PTPU_REQLOG (+ ring/rotation knobs) from the environment."""
    global _enabled
    _enabled = _env_enabled()
    _set_sink(_env_sink())
    _ring_ref[0] = deque(_ring_ref[0], maxlen=_ring_len())


def sink_path() -> "str | None":
    """The active JSONL sink path (None = ring only)."""
    return _sink_path


def _ring_len() -> int:
    try:
        return max(1, int(os.environ.get("PTPU_REQLOG_RING",
                                         str(_DEFAULT_RING))))
    except ValueError:
        return _DEFAULT_RING


def _rotate_bytes() -> int:
    try:
        mb = float(os.environ.get("PTPU_REQLOG_ROTATE_MB",
                                  str(_DEFAULT_ROTATE_MB)))
    except ValueError:
        mb = _DEFAULT_ROTATE_MB
    return max(4096, int(mb * (1 << 20)))


# ring in a one-slot list so refresh() can resize without tearing
# concurrent readers (deque reads/swaps are atomic under the GIL)
_ring_ref = [deque(maxlen=_ring_len())]
_lock = threading.Lock()
_sink_file = None          # lazily-opened file object for _sink_path


def _set_sink(path: "str | None") -> None:
    global _sink_path, _sink_file
    with _lock:
        if path != _sink_path and _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
        _sink_path = path


def _replica_id() -> "str | None":
    return os.environ.get("PTPU_REPLICA_ID") or None


def event(rid, trace_id=None, arrival_ts=None, prompt_tokens=0,
          generated_tokens=0, queue_wait_s=None, ttft_s=None,
          tpot_avg_s=None, tpot_max_s=None, prefill_chunks=0,
          prefix_hit_tokens=0, spec_proposed=0, spec_accepted=0,
          preemptions=0, peak_kv_blocks=0, finish_reason="stop",
          tenant=None, priority=None) -> dict:
    """Build one wide event, with exactly ``wire.REQLOG_EVENT_KEYS``.
    Unmeasured latencies stay ``None`` (a request aborted before its
    first token has no TTFT), never 0 — consumers must not average
    phantom zeros."""
    return {
        "schema_version": REQLOG_SCHEMA_VERSION,
        "rid": rid,
        "trace_id": trace_id,
        "replica_id": _replica_id(),
        "ts": time.time(),
        "arrival_ts": arrival_ts,
        "prompt_tokens": int(prompt_tokens),
        "generated_tokens": int(generated_tokens),
        "queue_wait_s": queue_wait_s,
        "ttft_s": ttft_s,
        "tpot_avg_s": tpot_avg_s,
        "tpot_max_s": tpot_max_s,
        "prefill_chunks": int(prefill_chunks),
        "prefix_hit_tokens": int(prefix_hit_tokens),
        "spec_proposed": int(spec_proposed),
        "spec_accepted": int(spec_accepted),
        "preemptions": int(preemptions),
        "peak_kv_blocks": int(peak_kv_blocks),
        "finish_reason": finish_reason,
        "tenant": tenant,
        "priority": priority,
    }


def emit(ev: dict) -> dict:
    """Append one event to the ring (+ the JSONL sink when configured).
    No-op passthrough when disabled, so callers can emit
    unconditionally; the engine still guards with :func:`enabled` to
    skip even the event build."""
    if not _enabled:
        return ev
    _ring_ref[0].append(ev)
    if _sink_path is not None:
        _write_sink(ev)
    return ev


def _write_sink(ev: dict) -> None:
    """One JSON line, size-rotated.  Sink failures are counted, never
    raised — losing a log line must not abort the request being
    released."""
    global _sink_file
    line = json.dumps(ev, default=str) + "\n"
    with _lock:
        try:
            if _sink_file is None:
                d = os.path.dirname(_sink_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                _sink_file = open(_sink_path, "a")
            _sink_file.write(line)
            _sink_file.flush()
            if _sink_file.tell() >= _rotate_bytes():
                _sink_file.close()
                _sink_file = None
                # one predecessor kept: bounded disk, yesterday's tail
                # still greppable
                os.replace(_sink_path, _sink_path + ".1")
        except OSError as e:
            _sink_file = None
            from . import counter

            counter("reqlog/sink_errors",
                    "reqlog JSONL writes that failed").inc()
            del e


def recent(n: "int | None" = None) -> list:
    """The newest `n` events (default: the whole ring), newest first —
    the ``/requests/recent`` payload."""
    out = list(_ring_ref[0])
    out.reverse()
    return out if n is None else out[:max(0, int(n))]


def reset() -> None:
    """Drop every buffered event and close the sink (tests)."""
    global _sink_file
    with _lock:
        _ring_ref[0].clear()
        if _sink_file is not None:
            try:
                _sink_file.close()
            except OSError:
                pass
            _sink_file = None
