"""Flight recorder — the port of `paddle_tpu/monitor/flight.py`: the
post-mortem story for crashes, preemptions and hangs.

A fixed-size, lock-cheap ring buffer keeps the last N observability
records of this process (the finished spans of ``monitor.trace`` and
explicit ``flight.note(...)`` breadcrumbs, such as
`train.LossSpikeDetector`'s).  On the events below, the
ring — with a monitor snapshot and optionally a py-stack of every live
thread — is dumped as one JSON file into ``PTPU_FLIGHT_DIR``:

- ``install()``-ed signals (SIGTERM/SIGABRT by default; handlers CHAIN
  to whatever was installed before, so the default death still runs
  after the dump);
- an unhandled exception (``sys.excepthook`` wrapper);
- an explicit :func:`maybe_dump` (active whenever ``PTPU_FLIGHT_DIR``
  is set);
- the :func:`watchdog` thread: when no span or engine step has completed
  for ``stall_s`` seconds (``trace.heartbeat()`` is the liveness signal),
  the ring plus a stack snapshot of all threads is dumped.

Ring size: ``PTPU_FLIGHT_RING`` (default 512 records).  Everything here
is stdlib-only; the monitor snapshot is imported lazily at dump time.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

__all__ = [
    "FlightRecorder", "get_recorder", "record_span", "note", "dump",
    "maybe_dump", "dump_from_signal", "install", "uninstall", "watchdog",
    "Watchdog", "flight_dir", "latest_dump",
]

_DEFAULT_RING = 512


def flight_dir():
    """PTPU_FLIGHT_DIR, or None (None disables the automatic dumps —
    explicit ``dump(dir=...)`` still works)."""
    d = os.environ.get("PTPU_FLIGHT_DIR", "").strip()
    return d or None


class FlightRecorder:
    """Bounded ring of observability records.  Append is one deque.append
    under a lock (no allocation beyond the record itself); the ring is
    only serialized at dump time."""

    def __init__(self, maxlen=None):
        if maxlen is None:
            maxlen = int(os.environ.get("PTPU_FLIGHT_RING",
                                        str(_DEFAULT_RING)))
        self.maxlen = int(maxlen)
        self._ring = deque(maxlen=self.maxlen)
        self._lock = threading.Lock()
        self._dumps = 0

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def records(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self):
        with self._lock:
            return len(self._ring)

    # -- dumping ------------------------------------------------------------

    def dump(self, reason: str, dir: str = None, with_stacks: bool = True,
             extra: dict = None) -> str:
        """Write one self-contained post-mortem JSON; returns its path.
        `dir` defaults to PTPU_FLIGHT_DIR, then <tmp>/ptpu_flight."""
        import tempfile

        from . import snapshot, trace

        dir = dir or flight_dir() or os.path.join(tempfile.gettempdir(),
                                                  "ptpu_flight")
        os.makedirs(dir, exist_ok=True)
        self._dumps += 1
        doc = {
            "version": 1,
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "last_activity_age_s": trace.last_activity_age(),
            "ring": self.records(),
            "metrics": _safe_snapshot(snapshot),
        }
        if extra:
            doc["extra"] = extra
        if with_stacks:
            doc["stacks"] = _thread_stacks()
        path = os.path.join(
            dir, f"flight_{os.getpid()}_{reason}_{self._dumps:03d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)   # a reader never sees a half-written dump
        return path


def _safe_snapshot(snapshot_fn) -> dict:
    """A dump must succeed even when a metric holds an unserializable
    lazy value — post-mortems run at the worst moments by definition."""
    try:
        return json.loads(json.dumps(snapshot_fn(), default=str))
    except Exception as e:   # ptpu-check[silent-except]: the flight dump is last-resort
        # diagnostics — a snapshot failure is itself recorded, not raised
        return {"_snapshot_error": repr(e)}


def _thread_stacks() -> dict:
    """Formatted py-stack of every live thread (the faulthandler story,
    but JSON-structured and name-annotated)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        out[f"{tid} ({names.get(tid, '?')})"] = [
            ln.rstrip("\n") for ln in traceback.format_stack(frame)]
    return out


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def record_span(span_dict: dict) -> None:
    """Called by ``trace.Span.end`` for every finished span."""
    _recorder.record({"kind": "span", **span_dict})


def note(event: str, **payload) -> None:
    """Explicit breadcrumb (state transitions that aren't spans)."""
    _recorder.record({"kind": "note", "event": event, "ts": time.time(),
                      **payload})


def dump(reason: str, dir: str = None, with_stacks: bool = True,
         extra: dict = None) -> str:
    return _recorder.dump(reason, dir=dir, with_stacks=with_stacks,
                          extra=extra)


def latest_dump(dir: str = None) -> "str | None":
    """Path of the newest flight dump in `dir` (default PTPU_FLIGHT_DIR),
    or None when the dir is unset/missing/empty — newest by mtime, .tmp
    staging files excluded (the atomic-rename commit means every visible
    flight_*.json is complete)."""
    dir = dir or flight_dir()
    if not dir:
        return None
    try:
        names = [n for n in os.listdir(dir)
                 if n.startswith("flight_") and n.endswith(".json")]
    except OSError:
        return None
    best, best_m = None, None
    for n in names:
        p = os.path.join(dir, n)
        try:
            m = os.path.getmtime(p)
        except OSError:   # raced a cleanup — skip, not fatal
            continue
        if best_m is None or m > best_m:
            best, best_m = p, m
    return best


def maybe_dump(reason: str, extra: dict = None):
    """Dump only when PTPU_FLIGHT_DIR is configured — the opt-in form
    the automatic hooks use."""
    if flight_dir() is None:
        return None
    try:
        return dump(reason, extra=extra)
    except Exception:   # ptpu-check[silent-except]: a failed post-mortem write (disk
        # full, dir gone) must never mask the signal/exception being
        # handled — the process is already dying
        return None


def dump_from_signal(reason: str, extra: dict = None,
                     timeout: float = 5.0):
    """Best-effort dump for SIGNAL handlers.  A handler runs on the main
    thread BETWEEN bytecodes — the interrupted frame may be holding a
    metric/ring `threading.Lock` (non-reentrant), so dumping inline could
    self-deadlock the process instead of letting it die/checkpoint.  The
    dump therefore runs on a helper thread with a bounded join: a held
    lock costs (at most) this dump, never the signal's disposition."""
    if flight_dir() is None:
        return None
    out = []
    t = threading.Thread(
        target=lambda: out.append(maybe_dump(reason, extra=extra)),
        name="ptpu-flight-dump", daemon=True)
    t.start()
    t.join(timeout)
    return out[0] if out else None


# -- signal / excepthook wiring --------------------------------------------
_prev_handlers: dict = {}
_prev_excepthook = None


def _on_signal(signum, frame):
    dump_from_signal(signal.Signals(signum).name.lower())
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL:
        # restore + re-deliver so the default disposition (death) runs
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    # SIG_IGN / None: swallow, matching the previous disposition


def _on_exception(etype, evalue, tb):
    maybe_dump("exception", extra={
        "exception": "".join(
            traceback.format_exception_only(etype, evalue)).strip()})
    if _prev_excepthook is not None:
        _prev_excepthook(etype, evalue, tb)


def install(signals=(signal.SIGTERM, signal.SIGABRT),
            exceptions: bool = True) -> None:
    """Arm the dump-on-death hooks (idempotent; main thread only, the
    signal-module restriction).  Dumps fire only when PTPU_FLIGHT_DIR is
    set, so installing is safe unconditionally."""
    global _prev_excepthook
    for sig in signals:
        if sig in _prev_handlers:
            continue
        _prev_handlers[sig] = signal.signal(sig, _on_signal)
    if exceptions and _prev_excepthook is None:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _on_exception


def uninstall() -> None:
    global _prev_excepthook
    for sig, prev in list(_prev_handlers.items()):
        try:
            signal.signal(sig, prev)
        except (ValueError, TypeError):   # non-main-thread teardown
            pass
    _prev_handlers.clear()
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None


# -- the watchdog -----------------------------------------------------------

class Watchdog(threading.Thread):
    """Daemon thread dumping the ring + all-thread stacks when no span or
    step has completed for `stall_s` seconds, then re-arming (one dump
    per distinct stall, not one per poll).  Counts
    ``monitor/watchdog_dumps``."""

    def __init__(self, stall_s: float, dir: str = None, interval=None):
        super().__init__(name="ptpu-watchdog", daemon=True)
        self.stall_s = float(stall_s)
        self.dir = dir
        self.interval = interval or max(0.05, self.stall_s / 4.0)
        self.dump_paths: list = []
        self._stop_evt = threading.Event()

    def run(self):
        from . import counter, trace

        ctr = counter("monitor/watchdog_dumps",
                      "flight dumps triggered by a detected stall")
        errs = counter("monitor/watchdog_errors",
                       "watchdog dump attempts that failed")
        dumped_beat = None
        while not self._stop_evt.wait(self.interval):
            age = trace.last_activity_age()
            if age <= self.stall_s:
                continue
            # re-arm by remembering which beat was dumped, not by calling
            # trace.heartbeat(): a forged beat would reset /healthz's
            # last_activity_age_s and hide the ongoing stall
            beat = trace._last_beat[0]
            if beat == dumped_beat:
                continue
            try:
                path = _recorder.dump(
                    "stall", dir=self.dir,
                    extra={"stall_s": self.stall_s, "stalled_for_s": age})
                self.dump_paths.append(path)
                ctr.inc()
            except Exception:   # a failed dump (disk full, dir gone) must
                # not kill the watchdog: the next stall still deserves an
                # attempt; failures are counted
                errs.inc()
            dumped_beat = beat   # the next dump needs a new stall

    def stop(self, timeout: float = 5.0):
        self._stop_evt.set()
        self.join(timeout)


def watchdog(stall_s: float, dir: str = None, interval=None) -> Watchdog:
    """Start a stall watchdog; returns the (stoppable) thread::

        w = monitor.watchdog(stall_s=120)
        ...
        w.stop()
    """
    from . import trace

    trace.heartbeat()   # the clock starts now, not at module import
    w = Watchdog(stall_s, dir=dir, interval=interval)
    w.start()
    return w
