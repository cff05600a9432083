"""paddle_tpu_torch's ``monitor`` (the registry, ``flight``, ``train``
and ``perf``'s segments) against the JAX package's, on the CPU.

Both packages' monitors are stdlib Python; the port's is a copy, so the
same operations must give the same values and the same text:

- a fixed sequence of counter, gauge (set / add / sub, labeled, a
  callback), histogram (labeled, exemplars) and ``timer`` operations on a
  fresh registry of each package: equal ``snapshot()``, equal
  ``export_prometheus()`` and ``render()`` text (exemplar timestamps
  masked), equal ``export_jsonl`` records but for ``ts``; the gate off
  records nothing;
- `LossSpikeDetector` over the same losses (a warm-up, a spike, a spike
  inside the cooldown, NaN and inf) fires on the same steps with the same
  payloads and breadcrumbs, and sets the same gauges;
- `GoodputMeter` over the same waits and steps: the same figures;
- `observe_layer_stats`: the same gauges and the same ``report()``;
- ``perf.segment``: the same records and histograms, a no-op when off;
- the ``flight`` ring's dump;
- ``paddle_tpu_torch/monitor`` loaded on its own (not through the
  package, whose ``__init__`` imports torch) imports neither jax nor
  torch.

Each test resets both packages' process-wide registries and restores
their gates (`_fresh`): one xdist worker runs this whole file.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import paddle_tpu.monitor as jmon
from paddle_tpu.monitor import flight as jflight
from paddle_tpu.monitor import perf as jperf
from paddle_tpu.monitor import train as jtrain

import paddle_tpu_torch.monitor as tmon
from paddle_tpu_torch.monitor import flight as tflight
from paddle_tpu_torch.monitor import perf as tperf
from paddle_tpu_torch.monitor import train as ttrain

REPO = Path(__file__).resolve().parents[1]
PKGS = [(jmon, jflight, jperf, jtrain), (tmon, tflight, tperf, ttrain)]


@pytest.fixture(autouse=True)
def _fresh():
    """Both packages' registries, tables and rings empty, the gates on;
    the gates as they were afterwards."""
    gates = [(m.enabled(), m.exemplars_enabled(), p.enabled(), t.enabled())
             for m, _, p, t in PKGS]
    for m, f, p, t in PKGS:
        m.reset()
        f.get_recorder().clear()
        t.reset()
        p.reset()
        m.enable(True)
    yield
    for (m, f, p, t), (on, ex, pon, ton) in zip(PKGS, gates):
        m.enable(on)
        m.enable_exemplars(ex)
        p.enable(pon)
        t.enable(ton)
        m.reset()
        f.get_recorder().clear()
        t.reset()
        p.reset()


def _drive(mon):
    """The same operations on a fresh registry of ``mon``."""
    reg = mon.StatRegistry()
    c = reg.counter("serving/requests", "requests seen")
    c.inc()
    c.add(2.5)
    c.labels(kind="prefill").inc(3)
    c.labels(kind="decode").inc()
    g = reg.gauge("optimizer/lr", "learning rate")
    g.set(1e-3)
    g.add(0.5)
    g.sub(0.25)
    reg.gauge("device/peak_bytes", fn=lambda: 1234567.0)
    reg.gauge("train/grad_norm").labels(layer="gpt.h_0.ln_1.weight").set(0.75)
    reg.gauge("train/grad_norm").labels(layer="gpt.ln_f.bias").set(1e-9)
    h = reg.histogram("reader/wait_time", "seconds blocked")
    for v in (1e-6, 3e-5, 0.002, 0.04, 0.5, 7.0, 2e6, 0.0):
        h.observe(v)
    hl = reg.histogram("serving/ttft", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        hl.labels(replica="r0").observe(v, trace_id="abc")
    hl.labels(replica="r1").observe(0.2)
    mon.enable(False)
    c.inc(100)
    g.set(99)
    h.observe(99)
    mon.enable(True)
    with pytest.raises(TypeError):
        reg.gauge("serving/requests")
    return reg


_TS = re.compile(r"(\} \S+) \d+\.\d+(e[+-]?\d+)?$", re.M)


def test_registry_operations_match_jax(tmp_path):
    out = []
    for mon, *_ in PKGS:
        mon.enable_exemplars(True)
        reg = _drive(mon)
        prom = _TS.sub(r"\1 <ts>", reg.export_prometheus())
        rec = reg.export_jsonl(str(tmp_path / mon.__name__ / "m.jsonl"))
        rec.pop("ts")
        lines = (tmp_path / mon.__name__ / "m.jsonl").read_text()
        out.append((reg.snapshot(), prom, reg.render(), rec,
                    sorted(json.loads(lines))))
    (js, jp, jr, jrec, jl), (ts, tp, tr, trec, tl) = out
    assert ts == js
    assert tp == jp
    assert "<ts>" in tp and 'trace_id="abc"' in tp
    assert tr == jr
    assert trec == jrec and tl == jl
    assert js["serving/requests"] == {"": 3.5, "kind=decode": 1.0,
                                      "kind=prefill": 3.0}


def test_timer_and_stat_helpers_match_jax():
    snaps = []
    for mon, *_ in PKGS:
        with mon.timer("pipeline/stage_time", stage="0"):
            pass
        mon.STAT_ADD("memory/in_use", 5)
        mon.STAT_SUB("memory/in_use", 2)
        mon.STAT_ADD("memory/peak", 7)
        mon.STAT_RESET("memory/peak")
        snap = mon.snapshot()
        count = snap["pipeline/stage_time"]["stage=0"]["count"]
        snaps.append((count, snap["memory/in_use"], snap["memory/peak"]))
        mon.enable(False)
        with mon.timer("pipeline/off_time"):
            pass
        assert "pipeline/off_time" not in mon.snapshot()
    assert snaps[0] == snaps[1] == (1, 3.0, 0.0)


LOSSES = ([4.0 + 0.01 * ((i * 7) % 5) for i in range(25)]
          + [9.0, 4.02, 30.0] + [4.01] * 12 + [float("nan"), 4.0,
                                               float("inf")]
          + [4.0] * 12 + ["not a number", None, 50.0])


def test_loss_spike_detector_matches_jax():
    runs = []
    for mon, flight, _, train in PKGS:
        det = train.LossSpikeDetector(warmup=20, cooldown=3)
        fired = [(i, det.observe(x, step=i)) for i, x in enumerate(LOSSES)]
        fired = [(i, s) for i, s in fired if s is not None]
        notes = [{k: v for k, v in r.items() if k != "ts"}
                 for r in flight.get_recorder().records()]
        snap = mon.snapshot()
        runs.append((repr(fired), repr(notes),
                     {k: snap[k] for k in ("train/loss", "train/loss_ewma",
                                           "train/loss_spikes")}))
    assert runs[1] == runs[0]
    fired = eval(runs[0][0], {"nan": float("nan"), "inf": float("inf")})
    # 27 and 42 fall inside the cooldown of 25 and 40
    assert [i for i, _ in fired] == [25, 40, 57]
    assert [s["kind"] for _, s in fired] == ["spike", "nonfinite", "spike"]


def _drop_series(drop):
    """Remove the series whose names ``drop`` accepts from both
    packages' process-wide registries."""
    for mon, _, _, _ in PKGS:
        metrics = mon.get_registry()._metrics
        for name in [n for n in metrics if drop(n)]:
            del metrics[name]


@pytest.fixture
def _no_train_series():
    """Both registries without any ``train/*`` series: a reset zeroes a
    series in place and keeps its labels, so the per-layer gauges that
    another test file wrote earlier in the process (one set a package,
    each with its own layers) would stay in the snapshots.  The train
    module looks each series up anew, so one dropped here is made again
    on use."""
    _drop_series(lambda name: name.startswith("train/"))


def test_goodput_meter_matches_jax(_no_train_series):
    figures = []
    for mon, _, _, train in PKGS:
        meter = train.GoodputMeter(window=3)
        for i in range(7):
            meter.wait(0.01 * i)
            meter.wait(0.002)
            meter.step(0.1 + 0.01 * (i % 3), examples=8 if i != 4 else 0)
        snap = mon.snapshot()
        figures.append((meter.goodput, meter.data_wait_frac,
                        {k: v for k, v in snap.items()
                         if k.startswith("train/")}))
    assert figures[1] == figures[0]
    assert set(figures[0][2]) == {"train/goodput_examples_per_s",
                                  "train/data_wait_frac", "train/step_time",
                                  "train/examples"}


ROWS = [("gpt.h_0.attn.qkv_proj.weight", 0.5, 3.0, 0.003),
        ("gpt.h_0.ln_1.bias", 0.0, 0.0, 0.0),
        ("gpt.embeddings.word_embeddings.weight", 2.25, 40.0, 0.01),
        ("gpt.ln_f.weight", 0.125, 11.0, 1e-4)]


@pytest.mark.parametrize("top", [30, 2])
def test_layer_stats_and_report_match_jax(top, _no_train_series):
    out = []
    for mon, _, _, train in PKGS:
        train.observe_layer_stats(ROWS, step=3)
        snap = mon.snapshot()
        out.append(({k: snap[k] for k in ("train/grad_norm",
                                          "train/param_norm",
                                          "train/update_ratio",
                                          "train/stats_step")},
                    train.layer_stats(), train.report(top)))
    assert out[1] == out[0]
    # ranked by gradient norm, names cut to 36 characters
    assert out[0][2].splitlines()[2].split()[0] == \
        "gpt.embeddings.word_embeddings.weight"[:36]


def test_train_gates_match_jax(monkeypatch):
    for env, every in (({}, 10), ({"PTPU_TRAIN_STATS_EVERY": "1"}, 1),
                       ({"PTPU_TRAIN_STATS_EVERY": "x"}, 10)):
        for k in ("PTPU_TRAIN_STATS_EVERY",):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert jtrain.sample_every() == ttrain.sample_every() == every
    for value, on in (("1", True), ("0", False), ("off", False)):
        monkeypatch.setenv("PTPU_TRAIN_STATS", value)
        monkeypatch.setenv("PTPU_PERF", value)
        monkeypatch.setenv("PTPU_MONITOR", value)
        for mon, _, perf, train in PKGS:
            train.refresh()
            perf.refresh()
            mon.refresh()
            assert (train.enabled(), perf.enabled(), mon.enabled()) == \
                (on, on, on)


PERF_SERIES = ("perf/segment_time", "perf/step_time")


@pytest.fixture
def _no_perf_series():
    """Both registries without the perf histograms: a reset zeroes a
    series in place and keeps its labels, so segments that another test
    ran earlier in the process would stay listed.  Each observation looks
    its histogram up anew, so one dropped here is made again on use."""
    _drop_series(lambda name: name in PERF_SERIES)


def test_perf_segments_match_jax(_no_perf_series):
    recs = []
    for mon, _, perf, _ in PKGS:
        perf.enable(False)
        seg = perf.segment("train", "forward")
        assert seg is perf.segment("train", "backward")    # the no-op
        with seg as s:
            s.sync([1.0])
        assert perf.records() == []
        perf.enable(True)
        for name in ("forward", "backward", "forward"):
            with perf.segment("train", name) as s:
                s.sync()
        rec = perf.get("train:forward")
        snap = mon.snapshot()
        recs.append(([r.label for r in perf.records()], rec.calls,
                     *(sorted(snap[name]) for name in PERF_SERIES)))
    assert recs[1] == recs[0]
    assert recs[0][:2] == (["train:forward", "train:backward"], 2)


def test_segment_syncs_host_tensors_without_a_card():
    import torch
    tperf.enable(True)
    with tperf.segment("train", "optimizer") as s:
        s.sync(torch.ones(3), [torch.zeros(2)], {"a": torch.ones(1)})
    rec = tperf.get("train:optimizer")
    assert rec.calls == 1 and rec.best_s == rec.last_s == rec.total_s >= 0


def test_flight_dump(tmp_path):
    dumps = []
    for mon, flight, _, train in PKGS:
        flight.note("train/loss_spike", loss=9.0, step=4)
        mon.counter("optimizer/steps").inc()
        path = flight.dump("test", dir=str(tmp_path / mon.__name__),
                           with_stacks=False, extra={"why": "test"})
        assert flight.latest_dump(str(tmp_path / mon.__name__)) == path
        doc = json.loads(Path(path).read_text())
        dumps.append(doc)
    jdoc, tdoc = dumps
    # both read monitor.trace's heartbeat
    assert all(isinstance(d["last_activity_age_s"], float)
               and d["last_activity_age_s"] >= 0 for d in dumps)
    for doc in dumps:
        for k in ("ts", "pid", "argv", "last_activity_age_s"):
            doc.pop(k)
        # the JAX package registers device gauges of its own at import
        doc["metrics"] = doc["metrics"]["optimizer/steps"]
        for r in doc["ring"]:
            r.pop("ts")
    assert tdoc == jdoc
    assert tflight.maybe_dump("x") is None        # PTPU_FLIGHT_DIR unset


def test_monitor_alone_imports_neither_jax_nor_torch():
    code = (
        "import importlib.util, sys\n"
        f"d = {str(REPO / 'paddle_tpu_torch' / 'monitor')!r}\n"
        "spec = importlib.util.spec_from_file_location("
        "'ptm', d + '/__init__.py', submodule_search_locations=[d])\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "sys.modules['ptm'] = m\n"
        "spec.loader.exec_module(m)\n"
        "assert m.train.GoodputMeter and m.perf.segment and m.flight.note\n"
        "m.counter('optimizer/steps').inc()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'torch', 'numpy', 'paddle_tpu', 'paddle_tpu_torch'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
