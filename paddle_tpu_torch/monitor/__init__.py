"""Runtime telemetry registry — the port of `paddle_tpu/monitor/__init__.py`
(reference: paddle/fluid/platform/monitor.h StatRegistry + STAT_INT
gauges).

A process-wide `StatRegistry` holds typed metrics — monotonic `Counter`s,
last-value `Gauge`s (optionally backed by a callback), and bucketed
`Histogram`s — each of which can fan out into labeled series
(`metric.labels(k=v)`).  The metric names, the ``PTPU_MONITOR`` gate and
the exporters' text are the JAX package's, letter for letter.

Design constraints, in priority order:

- **near-zero cost when idle**: every mutation checks one module-level
  flag first; with ``PTPU_MONITOR=0`` an increment is a no-op function
  call.
- **no torch dependency**: this package is pure stdlib, so importing it
  never initializes a device; a device value reaches it only as a gauge
  value or callback (the optimizer's grad norm: a 0-d tensor that
  ``float()`` reads at export time).
- **thread-safe**: hot paths run from DataLoader threads and the
  training loop; each metric guards its state with its own lock.

Exporters: `export_prometheus()` (text exposition format),
`export_jsonl(path)` (append one timestamped snapshot per call), and
`snapshot()` (plain dict).

Naming convention: ``subsystem/metric`` (e.g. ``train/step_time``);
slashes are mapped to ``_`` for Prometheus.

Submodules: `trace` (spans, liveness), `flight` (with the stall
watchdog), `serve` (the live endpoint), `reqlog`, `slo`, `wire`, `perf`
(its segment timers) and `train`.  Still to come with the rest of
``monitor`` (fleet, hlo, memory; ROADMAP Queue 1 item 8): the fleet
federation merge (``StatRegistry.merge_snapshot``).
"""
from __future__ import annotations

import bisect
import json
import os
import re
import threading
import time

__all__ = [
    "Counter", "Gauge", "Histogram", "StatRegistry", "get_registry",
    "counter", "gauge", "histogram", "snapshot", "export_prometheus",
    "export_jsonl", "render", "reset", "enabled", "enable", "refresh",
    "timer", "STAT_ADD", "STAT_SUB", "STAT_RESET",
    "exemplars_enabled", "enable_exemplars",
]


def _env_enabled() -> bool:
    return os.environ.get("PTPU_MONITOR", "1").strip().lower() not in (
        "0", "false", "off", "")


# Module-level flag, NOT per-registry: the disabled fast path must be one
# global read + branch, no attribute chains.
_enabled = _env_enabled()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip collection on/off at runtime (overrides PTPU_MONITOR)."""
    global _enabled
    _enabled = bool(on)


def refresh():
    """Re-read PTPU_MONITOR (+ PTPU_EXEMPLARS) from the environment."""
    global _enabled, _exemplars
    _enabled = _env_enabled()
    _exemplars = _env_exemplars()


# -- histogram exemplars ----------------------------------------------------
# Opt-in on top of PTPU_MONITOR: when on, Histogram.observe(v, trace_id=)
# stamps the observation's trace id on the bucket it lands in, rendered
# in OpenMetrics exemplar syntax on /metrics — the link from "p99 ttft
# spiked" to the kept tail-sampled trace that caused it.  One slot per
# bucket (newest wins): bounded, no per-observation allocation growth.

def _env_exemplars() -> bool:
    return os.environ.get("PTPU_EXEMPLARS", "0").strip().lower() not in (
        "0", "false", "off", "")


_exemplars = _env_exemplars()


def exemplars_enabled() -> bool:
    return _exemplars


def enable_exemplars(on: bool = True):
    """Flip exemplar capture on/off at runtime (overrides PTPU_EXEMPLARS)."""
    global _exemplars
    _exemplars = bool(on)


def _coerce(v):
    """Resolve a stored value to a plain float. Gauges may hold lazy device
    scalars (e.g. a 0-d tensor on the card); float() forces them only at
    snapshot/export time, keeping the recording site async."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return 0.0


class _Metric:
    """Base: name, own value state, and an optional family of labeled
    children (one child per unique label set, created on demand)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: dict = {}   # sorted (k, v) tuple -> child metric
        self._label_key = ()
        self._touched = False

    def labels(self, **labels):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make_child()
                    child._label_key = key
                    self._children[key] = child
        return child

    def _make_child(self):
        raise NotImplementedError

    # -- introspection ----------------------------------------------------
    def _series(self):
        """[(label_key_tuple, metric)] for every live series. Children are
        copied under the lock so concurrent labels() registration can't
        mutate the dict mid-iteration."""
        with self._lock:
            children = sorted(self._children.items())
            touched = self._touched
        out = []
        if touched:
            out.append(((), self))
        out.extend(children)
        return out

    def _snapshot_value(self):
        raise NotImplementedError

    def snapshot(self):
        """Value for an unlabeled metric; {"k=v,...": value} when labeled."""
        with self._lock:
            children = sorted(self._children.items())
            touched = self._touched
        if not children:
            return self._snapshot_value()
        out = {}
        if touched:
            out[""] = self._snapshot_value()
        for key, child in children:
            out[",".join(f"{k}={v}" for k, v in key)] = child._snapshot_value()
        return out

    def _reset(self):
        with self._lock:
            children = list(self._children.values())
            self._touched = False
            self._zero()
        # zero children IN PLACE (don't drop them): labeled handles cached
        # at call sites must keep feeding the registry after reset()
        for c in children:
            c._reset()

    def _zero(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic count (reference STAT_INT used as an accumulator)."""

    kind = "counter"

    def __init__(self, name, help=""):
        super().__init__(name, help)
        self._value = 0.0

    def _make_child(self):
        return Counter(self.name, self.help)

    def inc(self, n=1):
        return self.add(n)

    def add(self, n=1):
        if not _enabled:
            return self
        n = float(n)
        with self._lock:
            self._value += n
            self._touched = True
        return self

    @property
    def value(self):
        return self._value

    def _snapshot_value(self):
        return self._value

    def _zero(self):
        self._value = 0.0


class Gauge(_Metric):
    """Last-written value, or a live callback (fn) sampled at export time
    (how device values are wired in without a torch import here)."""

    kind = "gauge"

    def __init__(self, name, help="", fn=None):
        super().__init__(name, help)
        self._value = 0.0
        self._fn = fn
        if fn is not None:
            self._touched = True

    def _make_child(self):
        return Gauge(self.name, self.help)

    def set(self, v):
        if not _enabled:
            return self
        with self._lock:
            self._value = v          # may be a lazy device scalar
            self._touched = True
        return self

    def add(self, n=1.0):
        if not _enabled:
            return self
        with self._lock:
            self._value = _coerce(self._value) + float(n)
            self._touched = True
        return self

    def sub(self, n=1.0):
        return self.add(-float(n))

    @property
    def value(self):
        if self._fn is not None:
            try:
                return _coerce(self._fn())
            except Exception:
                # a broken callback (a device gauge probing a torn-down
                # device, say) must not take down snapshot()/render —
                # count it so the breakage is visible, keep exporting
                _default.counter(
                    "monitor/gauge_errors",
                    "gauge callbacks that raised at sample time",
                ).labels(name=self.name).inc()
                return 0.0
        return _coerce(self._value)

    def _snapshot_value(self):
        return self.value

    def _zero(self):
        self._value = 0.0
        if self._fn is not None:
            self._touched = True   # callback gauges stay live across reset()


# Two buckets per decade spanning µs-scale timings to token counts; override
# per-metric via histogram(name, buckets=...).
DEFAULT_BUCKETS = tuple(
    float(f"{b}e{e}") for e in range(-6, 7) for b in (1, 3))


def _interp_percentile(q, buckets, counts, count, mn, mx):
    """q-th percentile (q in [0, 100]) linearly interpolated inside the
    bucket holding the target rank; the observed min/max clamp the first
    and last occupied buckets, so a single-bucket histogram still
    returns a value inside the data's actual range."""
    if not count:
        return 0.0
    q = min(max(float(q), 0.0), 100.0)
    target = q / 100.0 * count
    if target <= 0:
        return mn
    cum = 0
    for i, c in enumerate(counts):
        if not c:
            continue
        prev = cum
        cum += c
        if cum >= target:
            lo = buckets[i - 1] if i > 0 else mn
            hi = buckets[i] if i < len(buckets) else mx
            lo = max(min(lo, mx), mn)
            hi = max(min(hi, mx), lo)
            return lo + (target - prev) / c * (hi - lo)
    return mx


class Histogram(_Metric):
    """Bucketed distribution with count/sum/min/max running stats."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=None):
        super().__init__(name, help)
        self._buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._zero()

    def _make_child(self):
        return Histogram(self.name, self.help, self._buckets)

    def observe(self, v, trace_id=None):
        if not _enabled:
            return self
        v = float(v)
        with self._lock:
            i = bisect.bisect_left(self._buckets, v)
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = v if self._count == 1 else min(self._min, v)
            self._max = v if self._count == 1 else max(self._max, v)
            self._touched = True
            if _exemplars and trace_id:
                if self._exm is None:
                    self._exm = [None] * len(self._counts)
                self._exm[i] = (str(trace_id), v, time.time())
        return self

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, q) -> float:
        """q-th percentile (q in [0, 100]) interpolated from the bucket
        counts — how `serving/ttft` p99 is read without storing samples."""
        with self._lock:
            return _interp_percentile(q, self._buckets, self._counts,
                                      self._count, self._min, self._max)

    def _snapshot_value(self):
        with self._lock:   # consistent (count, sum, min, max) tuple
            if not self._count:
                return {"count": 0, "sum": 0.0}
            out = {
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
                "avg": self._sum / self._count,
            }
            for q, key in ((50, "p50"), (95, "p95"), (99, "p99")):
                out[key] = _interp_percentile(
                    q, self._buckets, self._counts, self._count,
                    self._min, self._max)
            return out

    def _bucket_rows(self):
        """Consistent (buckets, per-bucket counts, count, sum, exemplars)
        copy — exemplars is None until one was ever stamped."""
        with self._lock:
            return (self._buckets, list(self._counts), self._count,
                    self._sum,
                    None if self._exm is None else list(self._exm))

    def _zero(self):
        self._counts = [0] * (len(self._buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = 0.0
        self._max = 0.0
        self._exm = None   # per-bucket (trace_id, value, ts), lazy


_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    n = _NAME_BAD.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return n or "_"


def _prom_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_labels(key, extra=()):
    items = list(key) + list(extra)
    if not items:
        return ""
    return "{" + ",".join(
        f'{_prom_name(k)}="{_prom_label_value(str(v))}"' for k, v in items
    ) + "}"


def _prom_num(v) -> str:
    v = _coerce(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar rendering for one bucket line:
    `` # {trace_id="..."} <value> <unix_ts>``."""
    tid, v, ts = ex
    return (f' # {{trace_id="{_prom_label_value(str(tid))}"}} '
            f"{_prom_num(v)} {repr(float(ts))}")


class StatRegistry:
    """Named metric store (reference monitor.h StatRegistry::Instance)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    # -- registration (get-or-create, type-checked) -----------------------
    def _get_or_create(self, cls, name, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name, help="", fn=None) -> Gauge:
        g = self._get_or_create(Gauge, name, help=help)
        if fn is not None:
            g._fn = fn
            g._touched = True
        return g

    def histogram(self, name, help="", buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help=help, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def reset(self):
        """Zero every metric IN PLACE. Registration (and callback fns)
        survive — including labeled children — so series handles cached at
        call sites stay live."""
        for _, m in self._items():
            m._reset()

    # -- exporters --------------------------------------------------------
    def _items(self):
        """Sorted (name, metric) pairs, copied under the registry lock so
        concurrent registration can't mutate the dict mid-export."""
        with self._lock:
            return sorted(self._metrics.items())

    def snapshot(self) -> dict:
        """{name: value | hist-stats | {label_str: ...}} for every metric
        with at least one live series."""
        out = {}
        for name, m in self._items():
            if m._touched or m._children:
                out[name] = m.snapshot()
        return out

    def export_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for name, m in self._items():
            series = m._series()
            if not series:
                continue
            pname = _prom_name(m.name)
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for key, s in series:
                if isinstance(s, Histogram):
                    buckets, counts, count, total, exm = s._bucket_rows()
                    cum = 0
                    for i, (le, c) in enumerate(zip(buckets, counts)):
                        cum += c
                        line = (f"{pname}_bucket"
                                f"{_prom_labels(key, [('le', repr(le))])}"
                                f" {cum}")
                        if exm is not None and exm[i] is not None:
                            line += _exemplar_suffix(exm[i])
                        lines.append(line)
                    line = (f"{pname}_bucket"
                            f"{_prom_labels(key, [('le', '+Inf')])}"
                            f" {count}")
                    if exm is not None and exm[len(buckets)] is not None:
                        line += _exemplar_suffix(exm[len(buckets)])
                    lines.append(line)
                    lines.append(
                        f"{pname}_sum{_prom_labels(key)} {_prom_num(total)}")
                    lines.append(
                        f"{pname}_count{_prom_labels(key)} {count}")
                else:
                    val = s.value if isinstance(s, Gauge) else s._value
                    lines.append(
                        f"{pname}{_prom_labels(key)} {_prom_num(val)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str) -> dict:
        """Append one timestamped snapshot line; returns the record."""
        rec = {"ts": time.time(), "metrics": self.snapshot()}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def render(self) -> str:
        """Human-readable table of the snapshot."""
        snap = self.snapshot()
        if not snap:
            return ""
        lines = [f"{'runtime monitor':48s} {'value':>24s}"]

        def fmt(v):
            if isinstance(v, dict) and "count" in v:
                if not v["count"]:
                    return "n=0"
                out = f"n={v['count']} avg={v['avg']:.4g}"
                if "p50" in v:
                    out += f" p50={v['p50']:.4g} p95={v['p95']:.4g}"
                return out + f" max={v['max']:.4g}"
            return f"{_coerce(v):.6g}"

        for name, val in snap.items():
            if isinstance(val, dict) and "count" not in val:
                for lab, v in val.items():
                    tag = f"{name}{{{lab}}}" if lab else name
                    lines.append(f"  {tag[:46]:46s} {fmt(v):>24s}")
            else:
                lines.append(f"  {name[:46]:46s} {fmt(val):>24s}")
        return "\n".join(lines)


_default = StatRegistry()


def get_registry() -> StatRegistry:
    return _default


def counter(name, help="") -> Counter:
    return _default.counter(name, help=help)


def gauge(name, help="", fn=None) -> Gauge:
    return _default.gauge(name, help=help, fn=fn)


def histogram(name, help="", buckets=None) -> Histogram:
    return _default.histogram(name, help=help, buckets=buckets)


def snapshot() -> dict:
    return _default.snapshot()


def export_prometheus() -> str:
    return _default.export_prometheus()


def export_jsonl(path) -> dict:
    return _default.export_jsonl(path)


def render() -> str:
    return _default.render()


def reset():
    _default.reset()


class timer:
    """Context manager observing elapsed seconds into a histogram:

        with monitor.timer("pipeline/stage_time"):
            run()
    """

    def __init__(self, name_or_hist, **labels):
        self._t0 = None
        self._hist = None
        if not _enabled:   # no phantom series registration when disabled
            return
        if isinstance(name_or_hist, Histogram):
            self._hist = name_or_hist
        else:
            self._hist = _default.histogram(name_or_hist)
        if labels:
            self._hist = self._hist.labels(**labels)

    def __enter__(self):
        if _enabled and self._hist is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            self._hist.observe(time.perf_counter() - self._t0)
        return False


# -- reference monitor.h macro parity ------------------------------------
def STAT_ADD(name, value):
    """STAT_ADD(item, t): add to the named int stat (gauge semantics)."""
    _default.gauge(name).add(value)


def STAT_SUB(name, value):
    _default.gauge(name).sub(value)


def STAT_RESET(name):
    _default.gauge(name).set(0)


# -- the submodules ---------------------------------------------------------
# Guarded relative imports: a test loads THIS file standalone
# (spec_from_file_location, no package) to prove the core registry
# imports neither torch nor jax; in that mode the submodules — equally
# stdlib-only — are simply absent.
try:
    from . import trace, flight, serve, perf, train  # noqa: E402,F401
    from . import reqlog, slo, wire               # noqa: E402,F401
    from .flight import watchdog                  # noqa: E402,F401
    from .serve import start_server, stop_server  # noqa: E402,F401

    __all__ += ["trace", "flight", "serve", "perf", "train", "reqlog",
                "slo", "wire", "watchdog", "start_server", "stop_server"]
except ImportError:   # loaded standalone, outside the package
    pass
