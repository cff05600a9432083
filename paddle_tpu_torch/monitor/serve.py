"""Live observability endpoint — the port of `paddle_tpu/monitor/serve.py`:
a stdlib ``http.server`` thread serving the process's metrics and traces
while it runs:

- ``GET /metrics``       — Prometheus text exposition;
- ``GET /healthz``       — JSON liveness: pid, uptime, seconds since the
  last completed span or engine step (``trace.last_activity_age``), and
  identity (host, rank / replica_id when known);
- ``GET /traces/<id>``   — one trace's finished spans as JSON (the ids
  come from ``LLMEngine.request_trace`` / ``trace.trace_ids()``);
- ``GET /flight/latest`` — the newest flight-recorder dump in
  ``PTPU_FLIGHT_DIR`` (404 when none);
- ``GET /requests/recent[?n=K]`` — the wide-event request-log ring
  (``monitor/reqlog.py``), newest first;
- ``GET /slo``           — the SLO burn-rate report (``monitor/slo.py``).

Three routes of the JAX endpoint read parts that are not ported yet and
answer 501 with a body naming ROADMAP Queue 1 item 8: ``/profile`` (an
on-demand device profile; the port's would run ``torch.profiler``),
``/kv`` and ``/memory/timeline`` (the memory microscope).  Nor does a
started server register itself with a fleet store (``PTPU_FLEET_STORE``,
``monitor/fleet.py``, the same item).

No handler touches torch: every value served is a host number the
producers stored (the engine sets its gauges from host ints and floats),
so a scrape can never run a CUDA call beside a CUDA-graph capture on the
engine's thread.

Launch: ``monitor.start_server(port)`` (port 0 = ephemeral; the chosen
port is on the returned server), or ``EngineConfig(metrics_port=...)``.
The server runs on a daemon thread and binds 127.0.0.1 by default.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .wire import HEALTHZ_SCHEMA_VERSION as SCHEMA_VERSION

__all__ = ["MonitorServer", "start_server", "stop_server",
           "set_identity", "identity", "UNPORTED_ROUTES"]

# uptime is elapsed time: monotonic survives NTP steps and suspend
_started_at = time.monotonic()

# the JAX endpoint's routes whose producers are not ported yet
UNPORTED_ROUTES = {
    "/profile": "on-demand device profiling (torch.profiler)",
    "/kv": "the memory microscope's KV pool map",
    "/memory/timeline": "the memory microscope's timeline",
}

_identity_override = {}


def set_identity(replica_id=None, rank=None) -> None:
    """Pin this process's fleet identity explicitly (overrides the
    PTPU_REPLICA_ID / PADDLE_TRAINER_ID env defaults)."""
    if replica_id is not None:
        _identity_override["replica_id"] = str(replica_id)
    if rank is not None:
        _identity_override["rank"] = int(rank)


def identity() -> dict:
    """host + (when known) rank / replica_id; absent fields are omitted,
    not null."""
    out = {"host": socket.gethostname(), "schema_version": SCHEMA_VERSION}
    rank = _identity_override.get("rank")
    if rank is None:
        env = os.environ.get("PADDLE_TRAINER_ID")
        rank = int(env) if env and env.isdigit() else None
    if rank is not None:
        out["rank"] = rank
    rid = _identity_override.get("replica_id") \
        or os.environ.get("PTPU_REPLICA_ID")
    if rid:
        out["replica_id"] = rid
    return out


def _rss_bytes():
    """Resident set size — /proc on linux, peak-RSS rusage fallback
    elsewhere; None when neither answers."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        import sys

        # peak, not current; ru_maxrss is KiB on linux, bytes on macOS
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return rss if sys.platform == "darwin" else rss * 1024
    except (ImportError, OSError, ValueError):
        return None


def _open_fds():
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return None


class _Handler(BaseHTTPRequestHandler):
    server_version = "ptpu-monitor/2"

    def _send(self, code: int, body, ctype: str):
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, doc) -> None:
        self._send(code, json.dumps(doc), "application/json")

    def do_GET(self):   # noqa: N802 (http.server API)
        from . import enabled, export_prometheus, flight, reqlog, slo, trace

        raw = self.path
        query = raw.split("?", 1)[1] if "?" in raw else ""
        path = raw.split("?", 1)[0].rstrip("/") or "/"
        routes = getattr(self.server, "routes", None)
        if routes and path in routes:
            try:
                code, body, ctype = routes[path]()
            except Exception as e:   # a broken route must not kill the
                # scrape endpoint: report it as a 500 body instead
                code, body, ctype = 500, json.dumps(
                    {"error": repr(e)}), "application/json"
            self._send(code, body, ctype)
        elif path == "/metrics":
            reg = getattr(self.server, "registry", None)
            text = export_prometheus() if reg is None \
                else reg.export_prometheus()
            self._send(200, text,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/healthz":
            doc = {
                "status": "ok",
                "pid": os.getpid(),
                "uptime_s": round(time.monotonic() - _started_at, 3),
                "last_activity_age_s": round(trace.last_activity_age(), 3),
                "monitor_enabled": enabled(),
                "trace_enabled": trace.enabled(),
            }
            rss = _rss_bytes()
            if rss is not None:
                doc["rss_bytes"] = rss
            fds = _open_fds()
            if fds is not None:
                doc["open_fds"] = fds
            doc.update(identity())
            self._json(200, doc)
        elif path in UNPORTED_ROUTES:
            self._json(501, {"error": (
                f"{path}: {UNPORTED_ROUTES[path]} is not ported to "
                "paddle_tpu_torch yet (ROADMAP Queue 1 item 8)")})
        elif path == "/flight/latest":
            p = flight.latest_dump()
            if p is None:
                self._json(404, {"error": "no flight dump (PTPU_FLIGHT_DIR "
                                          "unset or empty)"})
            else:
                try:
                    with open(p) as f:
                        body = f.read()
                    self._send(200, body, "application/json")
                except OSError as e:   # raced a cleanup between listdir
                    # and open: a 404 is the truthful answer
                    self._json(404, {"error": repr(e)})
        elif path.startswith("/traces/"):
            tid = path[len("/traces/"):]
            spans = trace.get_trace(tid)
            if not spans:
                self._json(404, {"error": f"unknown trace {tid!r}"})
            else:
                self._json(200, spans)
        elif path == "/requests/recent":
            n = None
            for part in query.split("&"):
                if part.startswith("n="):
                    try:
                        n = int(part[2:])
                    except ValueError:
                        pass
            self._json(200, {
                "enabled": reqlog.enabled(),
                "schema_version": reqlog.REQLOG_SCHEMA_VERSION,
                "events": reqlog.recent(n),
            })
        elif path == "/slo":
            self._json(200, slo.report())
        elif path == "/":
            extra = " ".join(sorted(routes)) + " " if routes else ""
            self._send(200, "paddle_tpu_torch monitor: /metrics /healthz "
                            "/traces/<id> /flight/latest "
                            f"/requests/recent /slo {extra}\n",
                       "text/plain; charset=utf-8")
        else:
            self._send(404, "not found\n", "text/plain; charset=utf-8")

    def log_message(self, fmt, *args):
        pass   # scrapes every few seconds must not spam stderr


class MonitorServer:
    """A running endpoint; ``.port`` is the bound port (useful with
    port=0), ``.stop()`` shuts it down.

    ``registry``: an alternate StatRegistry whose exposition /metrics
    serves instead of the process default.  ``routes``: extra exact-path
    GET handlers, each a zero-arg callable returning ``(status,
    body_str, content_type)``."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, routes=None):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.registry = registry
        self._httpd.routes = dict(routes) if routes else None
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ptpu-monitor-http",
            daemon=True)
        self._thread.start()

    @property
    def registry(self):
        return self._httpd.registry

    @registry.setter
    def registry(self, reg):
        self._httpd.registry = reg

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __repr__(self):
        return f"MonitorServer({self.url})"


_server = None
_server_lock = threading.Lock()


def start_server(port: int = 0, host: str = "127.0.0.1") -> MonitorServer:
    """Start (or return) the process-wide endpoint.  Asking for a
    different explicit port while one is already bound warns instead of
    silently handing back the old server."""
    global _server
    with _server_lock:
        if _server is None:
            _server = MonitorServer(port, host)
        elif port not in (0, _server.port):
            import warnings

            warnings.warn(
                f"monitor.start_server({port}): endpoint already bound "
                f"on port {_server.port}; returning the existing server "
                "— stop_server() first to rebind")
        return _server


def stop_server() -> None:
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
