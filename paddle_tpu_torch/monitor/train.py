"""Training microscope — the port of `paddle_tpu/monitor/train.py`, the
stdlib half of the training telemetry:

- **loss-spike forensics** (:class:`LossSpikeDetector`) — an EWMA
  mean/variance detector over the per-step loss that drops a
  pre-divergence warning into the flight ring *before* the NaN lands
  (``train/loss_spikes``, ``flight.note("train/loss_spike")``);
- **per-layer training telemetry** (:func:`observe_layer_stats` /
  :func:`report`) — the gauge store + ranked table behind the
  optimizer's sampled per-layer grad/param/update reduction
  (``PTPU_TRAIN_STATS=1``, every ``PTPU_TRAIN_STATS_EVERY`` steps);
- **input-pipeline goodput** (:class:`GoodputMeter`) — examples/s
  against the TOTAL loop wall and the fraction of it spent blocked on
  the reader, wired into the hapi fit loop;
- the ``train/step_time`` gauge (window-mean step seconds).

Gate: ``PTPU_TRAIN_STATS=1`` (default OFF) turns on the *sampling*
diagnostic — the per-layer reduction, one extra device sync per sampled
step.  The always-cheap paths (loss-spike EWMA, goodput accounting) ride
the ordinary ``PTPU_MONITOR`` gate like the rest of the hot-path
metrics.

Import constraints (shared with flight/perf): pure stdlib — device
reductions happen at the call sites (the optimizer), which already hold
torch; this module only stores/ranks.

Exported metrics (the JAX package's names):
``train/loss`` (gauge, last healthy loss), ``train/loss_ewma``
(gauge), ``train/loss_spikes`` (counter), ``train/grad_norm{layer}`` /
``train/param_norm{layer}`` / ``train/update_ratio{layer}`` (sampled
gauges), ``train/stats_step`` (gauge), ``train/step_time`` (gauge,
seconds), ``train/goodput_examples_per_s`` (gauge),
``train/data_wait_frac`` (gauge), ``train/examples`` (counter).
Companion series recorded at their own sites: ``reader/wait_time``
(io.DataLoader), ``optimizer/grad_norm`` (the optimizer).
"""
from __future__ import annotations

import math
import os
import threading
from collections import deque

__all__ = [
    "enabled", "enable", "refresh", "sample_every", "LossSpikeDetector",
    "GoodputMeter", "observe_layer_stats", "layer_stats", "report",
    "reset",
]


def _env_enabled() -> bool:
    return os.environ.get("PTPU_TRAIN_STATS", "0").strip().lower() not in (
        "0", "false", "off", "")


# Module-level flag like monitor/perf: the disabled fast path in
# the optimizer's update loop is one global read + branch.
_enabled = _env_enabled()


def enabled() -> bool:
    return _enabled


def enable(on: bool = True):
    """Flip the sampled training diagnostics on/off at runtime
    (overrides PTPU_TRAIN_STATS)."""
    global _enabled
    _enabled = bool(on)


def refresh():
    """Re-read PTPU_TRAIN_STATS from the environment."""
    global _enabled
    _enabled = _env_enabled()


def sample_every() -> int:
    """Stride of the per-layer sampled reduction (PTPU_TRAIN_STATS_EVERY,
    default 10; 1 = every step)."""
    try:
        return max(1, int(os.environ.get("PTPU_TRAIN_STATS_EVERY", "10")))
    except ValueError:
        return 10


def _registry():
    from . import get_registry

    return get_registry()


# ---------------------------------------------------------------------------
# Loss-spike detector (the pre-divergence warning)
# ---------------------------------------------------------------------------

class LossSpikeDetector:
    """EWMA mean/variance spike detector over the per-step loss.

    Divergence almost never starts at the NaN: the loss climbs for a
    handful of steps first.  This detector keeps an exponentially
    weighted mean and variance of the loss and, once warmed up, flags a
    step whose loss sits more than ``sigma`` standard deviations above
    the mean — dropping a ``train/loss_spike`` breadcrumb into the
    flight ring so the post-mortem a later NaN triggers already carries
    the pre-divergence trajectory.

    Robustness choices: a flagged loss is NOT folded into the EWMA (a
    diverging run must not drag its own baseline up until the spike
    disappears), a non-finite loss fires immediately regardless of
    warmup, and ``cooldown`` steps must pass between breadcrumbs so a
    sustained climb writes a few markers, not one per step.

    Host cost per observe: a handful of float ops + two gauge writes —
    callers gate on ``monitor.enabled()`` (one global read when off).
    """

    __slots__ = ("alpha", "sigma", "warmup", "cooldown", "_mean", "_var",
                 "_n", "_last_fire", "_m_loss", "_m_ewma", "_m_spikes")

    def __init__(self, alpha: float = 0.05, sigma: float = 6.0,
                 warmup: int = 20, cooldown: int = 10):
        self.alpha = float(alpha)
        self.sigma = float(sigma)
        self.warmup = int(warmup)
        self.cooldown = int(cooldown)
        self._mean = 0.0
        self._var = 0.0
        self._n = 0
        self._last_fire = None
        reg = _registry()
        self._m_loss = reg.gauge("train/loss",
                                 "last observed (healthy) step loss")
        self._m_ewma = reg.gauge("train/loss_ewma",
                                 "EWMA of the step loss (spike baseline)")
        self._m_spikes = reg.counter(
            "train/loss_spikes",
            "pre-divergence loss-spike warnings (EWMA detector)")

    def observe(self, loss: float, step: int = None) -> "dict | None":
        """Feed one step's loss; returns a spike-info dict when the step
        fires (and drops the flight-ring breadcrumb), else None."""
        try:
            loss = float(loss)
        except (TypeError, ValueError):
            return None
        spike = None
        if not math.isfinite(loss):
            spike = {"kind": "nonfinite", "loss": loss, "step": step,
                     "ewma": self._mean}
        elif self._n >= self.warmup:
            sd = math.sqrt(self._var) if self._var > 0 else 0.0
            if sd > 0 and loss > self._mean + self.sigma * sd:
                spike = {"kind": "spike", "loss": loss, "step": step,
                         "ewma": self._mean, "sigma": (loss - self._mean)
                         / sd}
        if spike is not None:
            if self._last_fire is not None and step is not None and \
                    self.cooldown > 0 and \
                    (step - self._last_fire) < self.cooldown:
                return None   # still inside the cooldown window
            self._last_fire = step
            self._m_spikes.inc()
            from . import flight

            flight.note("train/loss_spike", **{k: v for k, v in
                                               spike.items()
                                               if v is not None})
            return spike
        # only a NON-spike loss feeds the baseline (see class docstring)
        self._n += 1
        a = self.alpha if self._n > 1 else 1.0
        delta = loss - self._mean
        self._mean += a * delta
        self._var = (1.0 - a) * (self._var + a * delta * delta)
        self._m_loss.set(loss)
        self._m_ewma.set(self._mean)
        return None


# ---------------------------------------------------------------------------
# Per-layer telemetry store (the optimizer's sampled reduction lands here)
# ---------------------------------------------------------------------------

# latest sampled table: [(layer, grad_norm, param_norm, update_ratio)]
_layer_rows: list = []
_layer_step = None
_layer_lock = threading.Lock()


def observe_layer_stats(rows, step=None):
    """Record one sampled per-layer stats table.

    ``rows``: iterable of ``(layer, grad_norm, param_norm,
    update_norm)`` floats (the optimizer computes all three in one
    batch of device reductions and transfers ONCE).  The update *ratio*
    — ||delta|| / ||param||, the "is the step size sane per layer" number
    — is derived here; gauges are exported per layer and the table is
    kept for :func:`report`."""
    reg = _registry()
    g_g = reg.gauge("train/grad_norm",
                    "per-layer gradient L2 norm (sampled)")
    g_p = reg.gauge("train/param_norm",
                    "per-layer parameter L2 norm (sampled)")
    g_u = reg.gauge("train/update_ratio",
                    "per-layer ||update|| / ||param|| (sampled)")
    table = []
    for layer, gn, pn, un in rows:
        gn, pn, un = float(gn), float(pn), float(un)
        ratio = un / pn if pn > 0 else 0.0
        table.append((str(layer), gn, pn, ratio))
        g_g.labels(layer=layer).set(gn)
        g_p.labels(layer=layer).set(pn)
        g_u.labels(layer=layer).set(ratio)
    global _layer_rows, _layer_step
    with _layer_lock:
        _layer_rows = table
        _layer_step = step
    if step is not None:
        reg.gauge("train/stats_step",
                  "step of the last sampled per-layer table").set(step)


def layer_stats() -> "tuple[list, int | None]":
    """(rows, step) of the latest sampled per-layer table; rows are
    ``(layer, grad_norm, param_norm, update_ratio)``."""
    with _layer_lock:
        return list(_layer_rows), _layer_step


def report(top: int = 30) -> str:
    """Ranked per-layer training table: layers by gradient norm, each
    with param norm and update ratio — the rows that answer "which layer
    is about to diverge" and "which layer's update is out of scale"."""
    rows, step = layer_stats()
    if not rows:
        return ""
    rows = sorted(rows, key=lambda r: -r[1])
    head = "train layer stats" + (f" @ step {step}" if step is not None
                                  else "")
    lines = [head,
             f"  {'layer':36s} {'grad_norm':>12s} {'param_norm':>12s} "
             f"{'upd_ratio':>10s}"]
    for layer, gn, pn, ratio in rows[:top]:
        lines.append(f"  {layer[:36]:36s} {gn:12.4g} {pn:12.4g} "
                     f"{ratio:10.3g}")
    if len(rows) > top:
        lines.append(f"  ... {len(rows) - top} more layers")
    return "\n".join(lines)


def reset():
    """Drop the sampled table (tests)."""
    global _layer_rows, _layer_step
    with _layer_lock:
        _layer_rows = []
        _layer_step = None


# ---------------------------------------------------------------------------
# Input-pipeline goodput (the hapi fit loop's reader boundary)
# ---------------------------------------------------------------------------

class GoodputMeter:
    """Examples/s against the TOTAL training loop wall, and the fraction
    of it spent blocked on the reader — the training twin of
    ``serving/goodput_tokens_per_s``.

    The fit loop calls :meth:`wait` with the seconds it blocked in
    ``next(loader)`` and :meth:`step` with the step's wall + example
    count; both keep O(1) running sums over a sliding ``window`` of
    steps, so per-step cost is a deque append + four gauge writes
    (cached handles — no registry lookups in the loop).

    ``train/step_time`` is set to the window-mean step seconds (a mean
    over the window, not the last step, so one GC pause does not move
    it)."""

    __slots__ = ("window", "_ring", "_wait_s", "_step_s", "_examples",
                 "_pending_wait", "_m_good", "_m_frac", "_m_step",
                 "_m_examples")

    def __init__(self, window: int = 50):
        self.window = max(1, int(window))
        self._ring = deque()
        self._wait_s = 0.0
        self._step_s = 0.0
        self._examples = 0.0
        self._pending_wait = 0.0
        reg = _registry()
        self._m_good = reg.gauge(
            "train/goodput_examples_per_s",
            "examples/s over the total loop wall (incl. reader waits)")
        self._m_frac = reg.gauge(
            "train/data_wait_frac",
            "fraction of loop wall spent blocked on the reader")
        self._m_step = reg.gauge(
            "train/step_time",
            "train step seconds (window mean) — the straggler signal")
        self._m_examples = reg.counter(
            "train/examples", "training examples consumed")

    def wait(self, dt: float):
        """Seconds the loop just spent blocked on the reader (may be
        called more than once per step; accumulates)."""
        self._pending_wait += float(dt)

    def step(self, dt: float, examples: int = 0):
        """One completed train step of `dt` seconds over `examples`."""
        dt = float(dt)
        w = self._pending_wait
        self._pending_wait = 0.0
        self._ring.append((w, dt, float(examples)))
        self._wait_s += w
        self._step_s += dt
        self._examples += examples
        if len(self._ring) > self.window:
            ow, od, oe = self._ring.popleft()
            self._wait_s -= ow
            self._step_s -= od
            self._examples -= oe
        total = self._wait_s + self._step_s
        if total > 0:
            self._m_good.set(self._examples / total)
            self._m_frac.set(self._wait_s / total)
        self._m_step.set(self._step_s / len(self._ring))
        if examples:
            self._m_examples.inc(examples)

    @property
    def data_wait_frac(self) -> float:
        total = self._wait_s + self._step_s
        return self._wait_s / total if total > 0 else 0.0

    @property
    def goodput(self) -> float:
        total = self._wait_s + self._step_s
        return self._examples / total if total > 0 else 0.0
