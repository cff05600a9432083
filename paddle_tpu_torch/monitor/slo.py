"""SLO burn-rate engine — the port of `paddle_tpu/monitor/slo.py`: *are
we burning our latency budget right now*, the signal SLO-aware shedding
reads (``serving.scheduler.should_shed``).

Objectives are declared in ``PTPU_SLO`` as a ``;``-separated list:

    PTPU_SLO="ttft_p95<0.5;tpot_p99<0.05;error_rate<0.01"

Two objective forms:

- ``<hist>_p<q><threshold>`` — a latency objective over a serving
  histogram (``ttft`` / ``tpot`` / ``queue_wait`` → ``serving/<hist>``):
  at most ``100-q`` percent of requests may exceed ``threshold`` seconds.
  Evaluated from the histogram's cumulative bucket counts (observations
  in the bucket containing the threshold count as good — the
  conservative read, no samples stored);
- ``error_rate<frac`` — at most ``frac`` of finished requests may end
  abnormally, from the ``serving/finish_reason{reason}`` counters; every
  reason but ``stop``, ``migrated``, ``shed`` and ``rejected`` counts as
  an error.

Evaluation is multi-window multi-burn-rate: each objective's bad
fraction over a fast and a slow trailing window (``PTPU_SLO_WINDOWS``,
default ``60,600`` seconds) divided by its error budget — burn rate 1.0
burns exactly at budget.  Cumulative metric state is sampled into a
bounded ring on each tick, so windowed deltas need no per-request
bookkeeping.  Exported as ``slo/burn_rate{objective,window}`` and
``slo/budget_remaining{objective}`` gauges, and served at ``GET /slo``.

Default off: with ``PTPU_SLO`` unset :func:`maybe_tick` is one
module-global read.  Enabled, a tick runs at most once per
``min_interval`` (1 s).  stdlib only, like every sibling.
"""
from __future__ import annotations

import bisect
import os
import re
import threading
import time
from collections import deque

__all__ = [
    "Objective", "SloEngine", "parse_spec", "enabled", "enable",
    "refresh", "get_engine", "install", "maybe_tick", "report",
    "violates",
]

_LAT_RE = re.compile(r"^([a-z_]+)_p(\d{1,2}(?:\.\d+)?)$")

# the serving histograms a latency objective may target (the metric
# name is assembled from this table only, keeping metric-hygiene's
# literal-name rule meaningful)
_HIST_NAMES = {
    "ttft": "serving/ttft",
    "tpot": "serving/tpot",
    "queue_wait": "serving/queue_wait",
}
_FINISH_NAME = "serving/finish_reason"
# reasons that are NOT errors: a natural finish; a request migrated to
# another engine (it finishes, and is judged, over there); a best-effort
# request shed by SLO-aware admission (counting it would double-charge
# the budget that triggered it); and an HTTP client rejection (auth /
# parse 4xx that never reached the scheduler)
_GOOD_REASONS = ("stop", "migrated", "shed", "rejected")


def _env_spec() -> str:
    return os.environ.get("PTPU_SLO", "").strip()


def _env_windows() -> "tuple[float, float]":
    raw = os.environ.get("PTPU_SLO_WINDOWS", "60,600")
    try:
        parts = [float(p) for p in raw.split(",")]
        fast, slow = parts[0], parts[1]
        if fast <= 0 or slow <= fast:
            raise ValueError(raw)
        return fast, slow
    except (ValueError, IndexError):
        return 60.0, 600.0


_enabled = bool(_env_spec())


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip evaluation on/off at runtime (overrides PTPU_SLO; turning
    on without a spec ever parsed leaves ticks as no-ops)."""
    global _enabled
    with _engine_lock:
        _enabled = bool(on)


class Objective:
    """One parsed objective: what fraction of requests may be bad, and
    how to count bad/total from cumulative metric state."""

    __slots__ = ("spec", "kind", "hist_name", "quantile", "threshold",
                 "budget")

    def __init__(self, spec: str):
        spec = spec.strip()
        if "<" not in spec:
            raise ValueError(
                f"SLO objective {spec!r}: expected '<metric><target'")
        lhs, _, rhs = spec.partition("<")
        lhs = lhs.strip()
        try:
            target = float(rhs)
        except ValueError:
            raise ValueError(
                f"SLO objective {spec!r}: target {rhs!r} is not a number")
        self.spec = f"{lhs}<{rhs.strip()}"
        if lhs == "error_rate":
            if not 0.0 < target < 1.0:
                raise ValueError(
                    f"SLO objective {spec!r}: error-rate budget must be "
                    "in (0, 1)")
            self.kind = "error_rate"
            self.hist_name = None
            self.quantile = None
            self.threshold = None
            self.budget = target
            return
        m = _LAT_RE.match(lhs)
        if not m or m.group(1) not in _HIST_NAMES:
            raise ValueError(
                f"SLO objective {spec!r}: unknown metric {lhs!r} "
                f"(know {sorted(_HIST_NAMES)} percentiles and "
                "error_rate)")
        q = float(m.group(2))
        if not 0.0 < q < 100.0:
            raise ValueError(
                f"SLO objective {spec!r}: quantile must be in (0, 100)")
        if target <= 0:
            raise ValueError(
                f"SLO objective {spec!r}: latency threshold must be > 0")
        self.kind = "latency"
        self.hist_name = _HIST_NAMES[m.group(1)]
        self.quantile = q
        self.threshold = target
        self.budget = 1.0 - q / 100.0

    def totals(self, registry) -> "tuple[float, float]":
        """Cumulative (bad, total) request counts from the registry —
        monotonic, so windowed deltas are safe."""
        if self.kind == "error_rate":
            c = registry.get(_FINISH_NAME)
            if c is None:
                return 0.0, 0.0
            bad = total = 0.0
            for key, series in c._series():
                v = series._snapshot_value()
                total += v
                if dict(key).get("reason") not in _GOOD_REASONS:
                    bad += v
            return bad, total
        h = registry.get(self.hist_name)
        if h is None or h.kind != "histogram":
            return 0.0, 0.0
        buckets, counts, count, _ = h._bucket_rows()[:4]
        j = bisect.bisect_left(buckets, self.threshold)
        good = sum(counts[:j + 1]) if j < len(buckets) else count
        return float(count - good), float(count)

    def __repr__(self):
        return f"Objective({self.spec})"


def parse_spec(spec: str) -> "list[Objective]":
    """Parse a ``;``-separated PTPU_SLO string (empty parts skipped)."""
    return [Objective(part) for part in spec.split(";") if part.strip()]


class SloEngine:
    """Window accounting + gauge export for a set of objectives.

    ``registry`` defaults to the process StatRegistry; tests hand in a
    synthetic one.  Time is injectable everywhere (``now=``, monotonic
    seconds) so window math is deterministic under test."""

    def __init__(self, objectives, registry=None,
                 windows: "tuple[float, float]" = None,
                 min_interval: float = 1.0):
        if isinstance(objectives, str):
            objectives = parse_spec(objectives)
        self.objectives = list(objectives)
        if registry is None:
            from . import get_registry

            registry = get_registry()
        self.registry = registry
        self.windows = tuple(windows or _env_windows())
        self.min_interval = float(min_interval)
        self._lock = threading.Lock()
        # ring of (t, ((bad, total) per objective)); pruned past the
        # slow window so memory stays bounded at slow/min_interval
        self._samples: deque = deque()
        self._last_tick = None
        self._last_report = None
        # cached gauge handles, one per (objective, window) series
        g_burn = registry.gauge(
            "slo/burn_rate",
            "windowed bad-fraction / error-budget per objective "
            "(1.0 = burning exactly at budget)")
        g_rem = registry.gauge(
            "slo/budget_remaining",
            "fraction of the lifetime error budget left per objective")
        self._g_burn = {
            (o.spec, w): g_burn.labels(objective=o.spec, window=w)
            for o in self.objectives for w in ("fast", "slow")}
        self._g_rem = {o.spec: g_rem.labels(objective=o.spec)
                       for o in self.objectives}

    # -- evaluation ---------------------------------------------------------

    def tick(self, now: "float | None" = None) -> "dict | None":
        """Rate-limited evaluate: cheap enough to call every engine
        step.  Returns the report when it ran, None when skipped."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._last_tick is not None \
                    and now - self._last_tick < self.min_interval:
                return None
        return self.evaluate(now)

    def evaluate(self, now: "float | None" = None) -> dict:
        """Sample cumulative state, compute per-window burn rates,
        write the gauges, and return the /slo report document."""
        if now is None:
            now = time.monotonic()
        totals = tuple(o.totals(self.registry) for o in self.objectives)
        fast_w, slow_w = self.windows
        with self._lock:
            self._last_tick = now
            self._samples.append((now, totals))
            while self._samples and self._samples[0][0] < now - slow_w:
                # keep ONE sample at/past the slow horizon so the slow
                # window always has a full-width baseline
                if len(self._samples) > 1 \
                        and self._samples[1][0] <= now - slow_w:
                    self._samples.popleft()
                else:
                    break
            samples = list(self._samples)
        objs = []
        for i, o in enumerate(self.objectives):
            bad_now, total_now = totals[i]
            burns = {}
            for wname, wsecs in (("fast", fast_w), ("slow", slow_w)):
                base = samples[0]
                for s in samples:
                    if s[0] <= now - wsecs:
                        base = s
                    else:
                        break
                d_bad = bad_now - base[1][i][0]
                d_total = total_now - base[1][i][1]
                frac = (d_bad / d_total) if d_total > 0 else 0.0
                burns[wname] = frac / o.budget
                self._g_burn[(o.spec, wname)].set(burns[wname])
            life_frac = (bad_now / total_now) if total_now > 0 else 0.0
            remaining = min(1.0, max(0.0, 1.0 - life_frac / o.budget))
            self._g_rem[o.spec].set(remaining)
            objs.append({
                "objective": o.spec,
                "kind": o.kind,
                "threshold": o.threshold,
                "budget": o.budget,
                "burn_rate": burns,
                "budget_remaining": remaining,
                "bad": bad_now,
                "total": total_now,
            })
        rep = {
            "enabled": True,
            "windows": {"fast": fast_w, "slow": slow_w},
            "objectives": objs,
        }
        with self._lock:
            self._last_report = rep
        return rep

    def report(self) -> dict:
        """The newest evaluation (evaluating now if none yet) — the
        ``/slo`` endpoint body."""
        with self._lock:
            rep = self._last_report
        return rep if rep is not None else self.evaluate()

    def violates(self, ttft_s=None, tpot_avg_s=None,
                 queue_wait_s=None) -> bool:
        """Does a single request's latency profile exceed any latency
        objective's threshold?  The per-request hook tail sampling and
        the engine's trace keep-marking use — static thresholds only,
        no window math."""
        probe = {"serving/ttft": ttft_s, "serving/tpot": tpot_avg_s,
                 "serving/queue_wait": queue_wait_s}
        for o in self.objectives:
            if o.kind != "latency":
                continue
            v = probe.get(o.hist_name)
            if v is not None and v > o.threshold:
                return True
        return False


# -- process-wide singleton --------------------------------------------------
_engine = None
_engine_lock = threading.Lock()


def get_engine() -> "SloEngine | None":
    """The PTPU_SLO-configured engine (built lazily; None when the spec
    is unset/empty/unparseable — a bad spec warns once rather than
    killing the serving process that merely wanted SLOs)."""
    global _engine, _enabled
    if _engine is not None:
        return _engine
    spec = _env_spec()
    if not spec:
        return None
    with _engine_lock:
        if _engine is None:
            try:
                objectives = parse_spec(spec)
            except ValueError as e:
                import warnings

                warnings.warn(f"PTPU_SLO ignored: {e}")
                _enabled = False
                return None
            if not objectives:
                _enabled = False
                return None
            _engine = SloEngine(objectives)
    return _engine


def install(engine: "SloEngine | None") -> None:
    """Pin the process engine explicitly (tests; None uninstalls)."""
    global _engine, _enabled
    with _engine_lock:
        _engine = engine
        _enabled = engine is not None


def refresh() -> None:
    """Re-read PTPU_SLO/PTPU_SLO_WINDOWS (drops the built engine)."""
    global _engine, _enabled
    with _engine_lock:
        _engine = None
        _enabled = bool(_env_spec())


def maybe_tick(now: "float | None" = None) -> None:
    """The engine-step hook: one module-global read when disabled."""
    if not _enabled:
        return
    eng = get_engine()
    if eng is not None:
        eng.tick(now)


def report() -> dict:
    """The ``/slo`` document (``{"enabled": False}`` when off)."""
    if not _enabled:
        return {"enabled": False, "objectives": []}
    eng = get_engine()
    if eng is None:
        return {"enabled": False, "objectives": []}
    return eng.report()


def violates(ttft_s=None, tpot_avg_s=None, queue_wait_s=None) -> bool:
    """Module-level :meth:`SloEngine.violates` against the configured
    engine (False when disabled)."""
    if not _enabled:
        return False
    eng = get_engine()
    return False if eng is None else eng.violates(
        ttft_s=ttft_s, tpot_avg_s=tpot_avg_s, queue_wait_s=queue_wait_s)
