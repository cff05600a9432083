"""paddle_tpu_torch's serving telemetry (``monitor`` `wire`, `trace`,
`reqlog`, `slo`, `serve`, the flight recorder's watchdog, and the
engine's wiring) against the JAX package's, on the CPU.

The same inputs, under injected clocks where the modules take them, go
through both packages:

- the wire schemas are equal;
- `SloEngine` reports, ``maybe_tick`` / ``report`` / ``violates``, the
  exported ``slo/*`` text, and `should_shed` / `worst_fast_burn`
  decisions;
- reqlog events (keys the port's ``REQLOG_EVENT_KEYS``), the ring and the
  rotating JSONL sink;
- span trees (names, parents, attributes), errors, tail sampling,
  ``inject`` / ``extract`` across the two packages and the Chrome export;
- the live endpoint's documents over the same registry and stores.

Then both engines serve the same requests with every gate on (monitor,
exemplars, trace, reqlog, SLO with a real ``error_rate`` objective): a
deadline expiry, a best-effort request shed by the burn it causes, two
tenants, a seeded row and a preemption.  Metric names and labels, the
counters, the histograms' counts, the deterministic gauges, each
request's reqlog fields and its ``request_trace`` span names must agree.
The JAX engine counts compiles of its prefill and sample programs too
and ``jit/recompiles``; the port counts its captures (kinds "ragged" and
"verify"; a capture is faked on the CPU, where nothing is captured), so
only the kinds both have are held (ROADMAP "Differences by design").

Finally ``EngineConfig(metrics_port=0)`` serves ``/metrics`` and
``/healthz``, and the three unported routes answer 501.
"""
import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.monitor as jmon
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.monitor import flight as jflight
from paddle_tpu.monitor import reqlog as jreqlog
from paddle_tpu.monitor import serve as jserve
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.monitor import trace as jtrace
from paddle_tpu.monitor import wire as jwire
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import scheduler as jsched

import paddle_tpu_torch.monitor as tmon
from paddle_tpu_torch import graphs
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.monitor import flight as tflight
from paddle_tpu_torch.monitor import reqlog as treqlog
from paddle_tpu_torch.monitor import serve as tserve
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.monitor import trace as ttrace
from paddle_tpu_torch.monitor import wire as twire
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from paddle_tpu_torch.serving import scheduler as tsched
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


PKGS = {
    "jax": SimpleNamespace(mon=jmon, trace=jtrace, reqlog=jreqlog,
                           slo=jslo, serve=jserve, flight=jflight,
                           wire=jwire, sched=jsched),
    "port": SimpleNamespace(mon=tmon, trace=ttrace, reqlog=treqlog,
                            slo=tslo, serve=tserve, flight=tflight,
                            wire=twire, sched=tsched),
}
ENV = ("PTPU_SLO", "PTPU_SLO_WINDOWS", "PTPU_TRACE_TAIL", "PTPU_REQLOG",
       "PTPU_REQLOG_RING", "PTPU_REQLOG_ROTATE_MB", "PTPU_SHED_BURN",
       "PTPU_EXEMPLARS", "PTPU_FLIGHT_DIR", "PTPU_REPLICA_ID")


def _clear(p):
    p.mon.reset()
    p.trace.reset()
    p.reqlog.reset()
    p.slo.install(None)
    p.slo.refresh()
    p.flight.get_recorder().clear()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' registries, stores and rings empty, every gate on;
    the gates as the environment says afterwards."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for p in PKGS.values():
        _clear(p)
        p.mon.enable(True)
        p.trace.enable(True)
        p.trace.set_tail_budget(None)
        p.reqlog.enable(True)
    yield
    for p in PKGS.values():
        _clear(p)
        p.mon.refresh()
        p.mon.enable_exemplars(False)
        p.trace.refresh()
        p.reqlog.refresh()


def _both(fn):
    return {name: fn(p) for name, p in PKGS.items()}


def test_wire_schemas_equal():
    assert twire.__all__ == jwire.__all__
    for name in jwire.__all__:
        assert getattr(twire, name) == getattr(jwire, name), name
    assert treqlog.REQLOG_EVENT_KEYS == twire.REQLOG_EVENT_KEYS


# -- slo ----------------------------------------------------------------------

SLO_SPEC = "ttft_p95<0.5;tpot_p99<0.05;error_rate<0.01"


def _slo_run(p):
    reg = p.mon.StatRegistry()
    ttft = reg.histogram("serving/ttft")
    tpot = reg.histogram("serving/tpot")
    fin = reg.counter("serving/finish_reason")
    eng = p.slo.SloEngine(SLO_SPEC, registry=reg, windows=(60.0, 600.0),
                          min_interval=1.0)
    reps = [eng.evaluate(now=0.0)]
    for i in range(19):
        ttft.observe(0.05 + 0.01 * i)
        tpot.observe(0.01)
    ttft.observe(0.7)
    tpot.observe(0.2)
    for reason, n in (("stop", 30), ("deadline", 1), ("shed", 2),
                      ("rejected", 1), ("migrated", 1), ("abort", 1)):
        fin.labels(reason=reason).inc(n)
    reps.append(eng.tick(now=20.0))
    reps.append(eng.tick(now=20.5))          # rate-limited: None
    reps.append(eng.evaluate(now=120.0))
    fin.labels(reason="stop").inc(10)
    reps.append(eng.evaluate(now=900.0))
    reps.append(eng.report())
    decisions = []
    for rep in reps:
        burn = p.sched.worst_fast_burn(rep)
        decisions.append((burn, [p.sched.should_shed(q, burn=burn) for q in
                                 ("interactive", "batch", "best-effort",
                                  "bogus", None)]))
    violates = [eng.violates(ttft_s=a, tpot_avg_s=b, queue_wait_s=c)
                for a, b, c in ((0.1, 0.01, None), (0.6, None, None),
                                (None, 0.06, 5.0), (None, None, None))]
    # the process engine: off, then installed and ticked
    off = (p.slo.report(), p.slo.violates(ttft_s=9.0))
    p.slo.install(eng)
    p.slo.maybe_tick(now=901.5)
    module = (p.slo.report(), p.slo.violates(ttft_s=0.6),
              p.sched.worst_fast_burn(), p.sched.should_shed("best-effort"))
    p.slo.install(None)
    return {"reports": reps, "decisions": decisions, "violates": violates,
            "off": off, "module": module,
            "text": reg.export_prometheus()}


def test_slo_reports_and_shed_decisions(monkeypatch):
    got = _both(_slo_run)
    assert got["port"] == got["jax"]
    burns = [d[0] for d in got["port"]["decisions"]]
    assert max(burns) > 2.0 and min(burns) == 0.0   # both branches ran
    monkeypatch.setenv("PTPU_SHED_BURN", "5.0")
    for burn in (4.9, 5.0, 2.0):
        assert tsched.should_shed("best-effort", burn=burn) == \
            jsched.should_shed("best-effort", burn=burn)


# -- reqlog -------------------------------------------------------------------

def _events():
    out = []
    for i in range(12):
        out.append(dict(
            rid=i, trace_id=f"t{i}", arrival_ts=1000.0 + i,
            prompt_tokens=7 + i, generated_tokens=i % 5,
            queue_wait_s=0.001 * i, ttft_s=None if i % 3 == 0 else 0.02,
            tpot_avg_s=0.01, tpot_max_s=0.03, prefill_chunks=1 + i % 2,
            prefix_hit_tokens=16 * (i % 2), spec_proposed=i,
            spec_accepted=i // 2, preemptions=i % 3, peak_kv_blocks=2,
            finish_reason=("stop", "deadline", "shed", "abort")[i % 4],
            tenant=None if i % 2 else "acme",
            priority=("interactive", "best-effort")[i % 2]))
    return out


def _reqlog_run(p, tmp_path, name):
    sink = str(tmp_path / name / "reqlog.jsonl")
    p.reqlog.enable(True, sink=sink)
    built = []
    for kw in _events():
        ev = p.reqlog.event(**kw)
        assert tuple(ev) == twire.REQLOG_EVENT_KEYS
        built.append(p.reqlog.emit(ev))
    recent = p.reqlog.recent(5)
    p.reqlog.enable(False)
    p.reqlog.emit(p.reqlog.event(99))        # off: not recorded
    p.reqlog.reset()                          # closes the sink
    lines = []
    for path in (sink + ".1", sink):
        try:
            with open(path) as f:
                lines.append([json.loads(line) for line in f])
        except FileNotFoundError:
            lines.append(None)
    for ev in built + recent + [e for part in lines if part
                                for e in part]:
        ev.pop("ts", None)
    return {"built": built, "recent": recent, "files": lines,
            "after_off": p.reqlog.recent()}


def test_reqlog_events(tmp_path, monkeypatch):
    monkeypatch.setenv("PTPU_REPLICA_ID", "r7")
    monkeypatch.setenv("PTPU_REQLOG_ROTATE_MB", "0.001")   # 4 KiB floor
    got = {name: _reqlog_run(p, tmp_path, name)
           for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    files = got["port"]["files"]
    assert files[0] and files[1], "the sink rotated once"
    assert got["port"]["recent"][0]["rid"] == 11
    assert got["port"]["built"][0]["replica_id"] == "r7"


# -- trace --------------------------------------------------------------------

def _tree(spans):
    """Spans as (name, parent name, attrs, finished) in start order."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), s["attrs"],
             s["dur_us"] is not None and s["dur_us"] >= 0) for s in spans]


def _trace_run(p):
    t = p.trace
    root = t.start_span("serving/request", rid=1, prompt_len=4)
    with t.attach(root):
        with t.span("serving/prefill", chunk_start=0, chunk_len=4):
            with t.span("inner"):
                pass
        try:
            with t.span("broken"):
                raise ValueError("x")
        except ValueError:
            pass
    t.start_span("serving/decode_step", parent=root, pos=4).end(batch=2)
    child = t.start_span("late")
    child.end()
    child.end(ignored=True)                  # idempotent
    root.end(finish="stop", tokens=3)
    tree = _tree(t.get_trace(root.trace_id))
    events = [(e["name"], e["ph"], sorted(e["args"]))
              for e in t.chrome_events(root.trace_id)]
    ring = [r["name"] for r in p.flight.get_recorder().records()
            if r.get("kind") == "span"]
    # tail sampling: one boring trace a window kept, interesting ones always
    t.reset()
    t.set_tail_budget(1)
    kept = []
    for fin, extra in (("stop", {}), ("stop", {}), ("abort", {}),
                       ("stop", {"keep": True})):
        r = t.start_span("serving/request")
        t.start_span("serving/decode_step", parent=r).end()
        r.end(finish=fin, **extra)
        kept.append(bool(t.get_trace(r.trace_id)))
    t.set_tail_budget(None)
    counters = {k: v for k, v in p.mon.snapshot().items()
                if k.startswith("trace/")}
    # off: no-op singletons
    t.enable(False)
    off = (bool(t.span("x")), t.start_span("y").end().to_dict(), t.inject())
    t.enable(True)
    return {"tree": tree, "events": events, "ring": ring, "kept": kept,
            "tail_counters": counters, "off": off,
            "age": isinstance(t.last_activity_age(), float)}


def test_trace_span_trees():
    got = _both(_trace_run)
    assert got["port"] == got["jax"]
    assert got["port"]["kept"] == [True, False, True, True]
    names = [n for n, *_ in got["port"]["tree"]]
    assert names[0] == "serving/request" and "broken" in names
    # context travels between the packages' wire headers
    for src, dst in ((jtrace, ttrace), (ttrace, jtrace)):
        s = src.start_span("serving/request")
        ctx = dst.extract(src.inject(s))
        assert (ctx.trace_id, ctx.span_id) == (s.trace_id, s.span_id)
        s.end()
    assert ttrace.extract("garbage") is None


def test_chrome_export_and_watchdog(tmp_path):
    for name, p in PKGS.items():
        s = p.trace.start_span("serving/request", rid=0)
        s.end()
        path = p.trace.export_chrome_trace(str(tmp_path / name / "t.json"),
                                           include_host_tracer=False)
        with open(path) as f:
            doc = json.load(f)
        assert [e["name"] for e in doc["traceEvents"]] == ["serving/request"]
    # the stall watchdog: one dump a distinct stall, none while beating
    docs = {}
    for name, p in PKGS.items():
        d = tmp_path / name / "flight"
        w = p.mon.watchdog(stall_s=0.15, dir=str(d), interval=0.03)
        try:
            deadline = time.monotonic() + 5.0
            while not w.dump_paths and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.1)                  # the same stall: no new dump
        finally:
            w.stop()
        assert len(w.dump_paths) == 1, name
        with open(w.dump_paths[0]) as f:
            doc = json.load(f)
        assert doc["reason"] == "stall"
        assert doc["last_activity_age_s"] >= 0.15
        docs[name] = (sorted(doc), sorted(doc["extra"]),
                      p.mon.snapshot()["monitor/watchdog_dumps"])
    assert docs["port"] == docs["jax"]


# -- serve --------------------------------------------------------------------

def _get(url):
    try:
        resp = urllib.request.urlopen(url, timeout=30)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serve_run(p, tmp_path, name, monkeypatch):
    reg = p.mon.StatRegistry()
    reg.counter("serving/decode_tokens").inc(12)
    reg.gauge("serving/running", "requests decoding").set(3)
    h = reg.histogram("serving/ttft", "arrival to first token, seconds")
    for v in (0.01, 0.2, 3.0):
        h.observe(v)
    reg.counter("serving/finish_reason").labels(reason="stop").inc(2)
    p.reqlog.emit(p.reqlog.event(5, prompt_tokens=3, generated_tokens=2))
    p.reqlog.emit(p.reqlog.event(6, finish_reason="deadline"))
    root = p.trace.start_span("serving/request", rid=5)
    p.trace.start_span("serving/prefill", parent=root).end()
    root.end(finish="stop")
    srv = p.serve.MonitorServer(0, registry=reg)
    try:
        out = {"metrics": _get(srv.url + "/metrics")}
        code, body = _get(srv.url + "/healthz")
        doc = json.loads(body)
        out["healthz"] = (code, sorted(doc), doc["schema_version"],
                          doc["status"], doc["last_activity_age_s"] >= 0)
        code, body = _get(srv.url + "/requests/recent?n=1")
        doc = json.loads(body)
        for ev in doc["events"]:
            ev.pop("ts", None)
        out["recent"] = (code, doc)
        code, body = _get(srv.url + "/slo")
        out["slo_off"] = (code, json.loads(body))
        eng = p.slo.SloEngine("error_rate<0.1", registry=reg,
                              windows=(60.0, 600.0))
        eng.evaluate(now=0.0)
        p.slo.install(eng)
        code, body = _get(srv.url + "/slo")
        out["slo"] = (code, json.loads(body))
        code, body = _get(srv.url + f"/traces/{root.trace_id}")
        out["trace"] = (code, _tree(json.loads(body)))
        out["unknown_trace"] = _get(srv.url + "/traces/nope")[0]
        out["flight_none"] = _get(srv.url + "/flight/latest")[0]
        monkeypatch.setenv("PTPU_FLIGHT_DIR", str(tmp_path / name))
        path = p.flight.dump("test", with_stacks=False)
        code, body = _get(srv.url + "/flight/latest")
        out["flight"] = (code, json.loads(body)["reason"],
                         path == p.flight.latest_dump())
        monkeypatch.delenv("PTPU_FLIGHT_DIR")
        out["missing"] = _get(srv.url + "/nothing")
    finally:
        srv.stop()
        p.slo.install(None)
    return out


def test_serve_endpoint(tmp_path, monkeypatch):
    got = {name: _serve_run(p, tmp_path, name, monkeypatch)
           for name, p in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["metrics"][0] == 200
    assert "serving_ttft_bucket" in got["port"]["metrics"][1]
    assert got["port"]["slo"][1]["enabled"] is True


# -- the engines --------------------------------------------------------------

NEW = 5
# (prompt length, SamplingParams fields): two tenants, an expiring
# deadline, a best-effort request the deadline's burn sheds, a seeded row;
# 2 blocks of 16: the first request's second block evicts the seeded row
REQUESTS = (
    (14, dict(tenant="acme")),
    (15, dict(tenant="free", priority="batch")),
    (3, dict(deadline_s=1e-9)),
    (5, dict(tenant="free", priority="best-effort")),
    (6, dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
             seed=5, max_new_tokens=4)),
)
ENGINE = dict(block_size=16, num_blocks=2, max_num_seqs=2)
# JAX programs the port runs without compiling (ROADMAP "Differences by
# design"): it counts captures only
JAX_ONLY_COMPILES = {"prefill", "chunk", "sample"}
# the memory microscope's ledger (ROADMAP Queue 1 item 8: not ported)
UNPORTED = {"serving/kv_blocks"}
# gauges that depend on wall time (the SLO burn rates over time windows,
# the latency objective's budget over measured TTFTs)
TIMED_GAUGES = {"serving/prefill_tps", "serving/decode_tps", "slo/burn_rate",
                "serving/goodput_tokens_per_s"}


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_test_config(stacked_blocks=True, sequence_parallel=False))
    m.eval()
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jax_model)._param_arrays().items()}
    m = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    return m.load_params(params_from_numpy(arrays, device="cpu"))


def _fake_capture(self):
    """A CPU stand-in for `StepGraph._capture`: the replays run the step
    eagerly; the capture is counted as a real one is."""
    self.graph = SimpleNamespace(
        replay=lambda: setattr(self, "outputs", self.step()))
    self.counts[self.kind] = self.counts.get(self.kind, 0) + 1
    self.on_capture(self.kind)


def _series(mon):
    """{(name, labels): (kind, value)} of the serving subsystems' series
    written since the last reset (a labeled series stays registered
    across resets, so other tests in the process leave some behind); a
    histogram's value is its count."""
    out = {}
    for name, m in mon.get_registry()._items():
        if name.split("/")[0] not in ("serving", "lowbit", "slo", "trace"):
            continue
        for key, s in m._series():
            if not s._touched:
                continue
            v = s._snapshot_value()
            out[(name, key)] = (m.kind, v["count"] if m.kind == "histogram"
                                else v)
    return out


def _run_engine(p, make_engine, sp_cls):
    prompts = [np.random.RandomState(n).randint(0, 128, (n,))
               .astype(np.int32) for n, _ in REQUESTS]
    eng = make_engine()
    slo_eng = p.slo.SloEngine("error_rate<0.01;ttft_p95<10",
                              windows=(60.0, 600.0), min_interval=0.0)
    slo_eng.evaluate()                       # the baseline sample
    p.slo.install(slo_eng)
    p.mon.enable_exemplars(True)
    try:
        ids = [eng.add_request(pr, sp_cls(**dict(dict(max_new_tokens=NEW),
                                                 **kw)))
               for pr, (_, kw) in zip(prompts, REQUESTS)]
        while eng.has_unfinished():
            eng.step()
        outs = {i: eng.request_output(i).tolist() for i in ids
                if i in eng._requests}
        for i in ids:
            eng.release_request(i)
    finally:
        p.slo.install(None)
    events = {e["rid"]: {k: e[k] for k in (
        "prompt_tokens", "generated_tokens", "finish_reason",
        "prefill_chunks", "preemptions", "peak_kv_blocks", "tenant",
        "priority", "spec_proposed", "spec_accepted")}
        for e in p.reqlog.recent()}
    traces = {i: sorted(s["name"] for s in eng.request_trace(i))
              for i in ids}
    return {"outs": outs, "events": events, "traces": traces,
            "series": _series(p.mon)}


def test_engines_telemetry_agree(jax_model, port_model, monkeypatch):
    monkeypatch.setattr(graphs, "graphs_on", lambda device: True)
    monkeypatch.setattr(graphs.StepGraph, "_capture", _fake_capture)
    got = {
        "jax": _run_engine(PKGS["jax"], lambda: JaxEngine(
            jax_model, JaxEngineConfig(**ENGINE)), JaxSamplingParams),
        "port": _run_engine(PKGS["port"], lambda: LLMEngine(
            port_model, EngineConfig(device="cpu", **ENGINE)),
            SamplingParams)}
    j, t = got["jax"], got["port"]
    assert t["outs"] == j["outs"] and len(j["outs"]) == 3
    assert t["events"] == j["events"]
    reasons = sorted(e["finish_reason"] for e in j["events"].values())
    assert reasons == ["deadline", "shed", "stop", "stop", "stop"]
    assert t["traces"] == j["traces"]
    assert j["series"][("serving/preemptions", ())][1] >= 1
    # metric names and labels; compile kinds only where both count
    jser = {k: v for k, v in j["series"].items()
            if k[0] not in UNPORTED
            and not (k[0] == "serving/compiles"
                     and dict(k[1])["kind"] in JAX_ONLY_COMPILES)}
    assert set(t["series"]) == set(jser), set(t["series"]) ^ set(jser)
    assert t["series"][("serving/compiles", (("kind", "ragged"),))] == \
        ("counter", 1)
    for key, (kind, v) in jser.items():
        if kind == "gauge" and (key[0] in TIMED_GAUGES or dict(key[1]).get(
                "objective", "").startswith("ttft")):
            continue
        assert t["series"][key] == (kind, v), key
    shed = t["series"][("serving/finish_reason", (("reason", "shed"),))]
    assert shed == ("counter", 1)


def test_metrics_port_endpoint(port_model):
    eng = LLMEngine(port_model, EngineConfig(device="cpu", metrics_port=0))
    srv = eng.metrics_server
    try:
        assert srv is tserve.start_server(0)
        eng.generate([np.arange(1, 5, dtype=np.int32)],
                     SamplingParams(max_new_tokens=3))
        code, text = _get(srv.url + "/metrics")
        assert code == 200 and "serving_decode_tokens 2" in text
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        for route in tserve.UNPORTED_ROUTES:
            code, body = _get(srv.url + route)
            assert code == 501, route
            assert "ROADMAP Queue 1 item 8" in json.loads(body)["error"]
    finally:
        tserve.stop_server()
