"""OpenAI-compatible HTTP front door — the port of
`paddle_tpu/serving/api.py`.

A stdlib ``http.server`` tier in front of an `LLMEngine`:

- ``POST /v1/completions``       — prompt in, tokens out; SSE streaming
  (``"stream": true`` — one chunk per engine step, fed straight from
  the step loop) or one non-streaming JSON body;
- ``POST /v1/chat/completions``  — the same engine path with the chat
  request / response shapes (``messages`` in, ``delta`` / ``message``
  out);
- ``GET  /v1/models``            — the one served model;
- structured error bodies (``{"error": {message, type, code, param}}``,
  the OpenAI client's shape, ``monitor.wire.API_ERROR_KEYS``);
- API-key → tenant mapping: ``PTPU_API_KEYS="sk-a:acme:interactive,
  sk-b:free:best-effort"``.  With keys configured, a missing or unknown
  ``Authorization: Bearer`` is a 401; without, the server is open and
  the tenant falls back to the request's ``user`` field.

Status codes and bodies are the JAX server's, ids aside.
The JAX server fronts either a local engine or the multi-replica router;
the router is not ported yet, and ``router=`` raises (ROADMAP Queue 1
item 8).

ONE daemon pump thread owns the engine: ``add_request``,
``release_request`` and ``step`` run only there, and HTTP handler
threads never touch the engine or torch.  Handlers enqueue submissions
and read per-request event queues the pump feeds.  On the card this
matters twice: the engine's pinned staging buffer is not thread-safe,
and the first decode step is captured as a CUDA graph inside
``engine.step()`` on the pump thread, where a CUDA call from another
thread would invalidate the capture.

Request deadlines ride the engine: a body ``deadline_s`` maps to
``SamplingParams.deadline_s``, the engine's deadline sweep aborts the
request at the next step, and the stream sees ``finish_reason=
"deadline"``.  The HTTP side adds a backstop timer (deadline + grace, or
a fixed budget) so that no stream hangs past its deadline, even with a
wedged pump.  A step that raises answers every open request with a 500
naming the error.

SLO-aware admission (the scheduler's `should_shed`): while the live
``monitor.slo`` fast-window burn rate breaches ``PTPU_SHED_BURN``,
best-effort requests are answered 429 + ``finish_reason="shed"`` before
they reach the queue.  HTTP client errors (auth / parse) count as
``finish_reason="rejected"``.

Tokens in, tokens out: there is no tokenizer, so ``prompt`` is a
token-id array by default and string prompts or chat content need an
``encode=`` callable.  ``decode=`` renders emitted ids into the ``text``
/ ``content`` fields (default: space-separated ids); every choice also
carries a ``token_ids`` field.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import monitor
from ..monitor import reqlog as mreqlog
from .scheduler import SamplingParams, should_shed, worst_fast_burn

__all__ = ["ApiServer", "start_api_server", "api_error",
           "parse_api_keys"]

# HTTP backstop past the request's own deadline: the engine path
# finishes "deadline" well inside this; the grace only fires when the
# pump itself is wedged, and turns a would-be hang into a clean timeout
# body.
_DEADLINE_GRACE_S = 5.0
# budget for requests that set no deadline_s — generous, but a BOUND
_DEFAULT_BUDGET_S = 120.0
# handler wait granularity: how often a waiting handler rechecks its
# budget while the pump is quiet
_WAIT_SLICE_S = 1.0


def parse_api_keys(spec: Optional[str] = None) -> dict:
    """``key:tenant[:priority]`` comma list → ``{key: (tenant,
    priority)}`` (default: the ``PTPU_API_KEYS`` env var).  Malformed
    entries are dropped, not fatal — a typo'd key should fail ITS
    requests with 401, not take the server down."""
    if spec is None:
        spec = os.environ.get("PTPU_API_KEYS", "")
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if not fields[0]:
            continue
        tenant = fields[1] if len(fields) > 1 and fields[1] else None
        priority = fields[2] if len(fields) > 2 and fields[2] else None
        out[fields[0]] = (tenant, priority)
    return out


def api_error(message: str, type: str = "invalid_request_error",
              code: Optional[str] = None,
              param: Optional[str] = None) -> dict:
    """The error body: the inner object of every non-2xx
    response, with exactly ``wire.API_ERROR_KEYS``."""
    err = {
        "message": message,
        "type": type,
        "code": code,
        "param": param,
    }
    return {"error": err}


def _default_decode(ids) -> str:
    """Space-separated token ids — honest output for a tokenizer-less
    framework; chunks concatenate cleanly (each starts with a space)."""
    return "".join(f" {int(t)}" for t in ids)


class _Stream:
    """One in-flight HTTP request's pump-side state + its event queue
    (the only object both a handler thread and the pump touch; the
    queue is the synchronization)."""

    def __init__(self, prompt_ids, params):
        self.prompt_ids = list(prompt_ids)
        self.params = params
        self.q: "queue.Queue" = queue.Queue()
        self.rid = None            # engine id once the pump submits
        self.req = None            # the live Request object
        self.sent = 0              # generated tokens already pushed
        self.cancelled = False     # handler gone — pump must release


class ApiServer:
    """The HTTP tier over ``engine``; ``router`` keeps the JAX signature
    and raises until the router is ported.  ``port=0`` binds an ephemeral
    port (read ``.port`` / ``.url``).  ``api_keys`` overrides the
    ``PTPU_API_KEYS`` parse; ``encode`` / ``decode`` bridge strings to
    token ids and back."""

    def __init__(self, engine=None, router=None, host: str = "127.0.0.1",
                 port: int = 0, model_id: str = "paddle-tpu",
                 api_keys: Optional[dict] = None, encode=None,
                 decode=None, poll_s: float = 0.02):
        if (engine is None) == (router is None):
            raise ValueError("exactly one of engine/router")
        if router is not None:
            raise NotImplementedError(
                "ApiServer(router=...): the multi-replica router "
                "(serving/router.py) is not ported to paddle_tpu_torch "
                "yet (ROADMAP Queue 1 item 8); serve an LLMEngine")
        self.engine = engine
        self.model_id = model_id
        self.api_keys = (dict(api_keys) if api_keys is not None
                         else parse_api_keys())
        self.encode = encode
        self.decode = decode or _default_decode
        self.poll_s = float(poll_s)
        self._submit_q: "queue.Queue" = queue.Queue()
        self._streams: dict = {}       # rid -> _Stream (pump-owned)
        self._ids = itertools.count()
        self._m_finish = monitor.counter(
            "serving/finish_reason",
            "finished requests by outcome "
            "(stop|abort|deadline|released|migrated|shed|rejected)")
        self._m_tenant_shed = monitor.counter(
            "serving/tenant_shed",
            "best-effort requests shed by SLO admission control, "
            "by tenant")
        self._m_http = monitor.counter(
            "serving/http_requests", "API requests by response class")
        self._stop = threading.Event()
        self._pump_thread = threading.Thread(
            target=self._pump, name="ptpu-api-pump", daemon=True)
        self._httpd = ThreadingHTTPServer((host, int(port)), _ApiHandler)
        self._httpd.daemon_threads = True
        self._httpd.api = self
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ptpu-api-http",
            daemon=True)
        self._pump_thread.start()
        self._http_thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._stop.set()
        self._pump_thread.join(timeout=5)
        self._http_thread.join(timeout=5)

    # -- handler-side API ---------------------------------------------------

    def submit(self, stream: _Stream) -> None:
        self._submit_q.put(stream)

    def live_burn(self) -> float:
        """Worst fast-window burn the shed decision reads: the local SLO
        engine's."""
        return worst_fast_burn()

    # -- the pump (owns the engine; the only engine-touching thread) --------

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                self._pump_once()
            except Exception as e:   # an engine failure surfaces as
                # per-stream 500s naming it, never a silent dead pump
                self._fail_all(repr(e))
                time.sleep(self.poll_s)   # no hot-spin on an engine
                #                           that keeps raising

    def _pump_once(self) -> None:
        busy = bool(self._streams)
        self._drain_submits(block_s=0.0 if busy else self.poll_s)
        if self.engine.has_unfinished():
            self.engine.step()
        self._push_engine_progress()

    def _drain_submits(self, block_s: float) -> None:
        try:
            first = self._submit_q.get(timeout=max(block_s, 0.001))
        except queue.Empty:
            return
        items = [first]
        while True:
            try:
                items.append(self._submit_q.get_nowait())
            except queue.Empty:
                break
        for st in items:
            self._handle_submit(st)

    def _handle_submit(self, st: _Stream) -> None:
        try:
            st.rid = self.engine.add_request(st.prompt_ids, st.params)
            st.req = self.engine._requests[st.rid]
        except ValueError as e:
            st.q.put(("reject", str(e)))
            return
        self._streams[st.rid] = st

    def _push_engine_progress(self) -> None:
        for rid, st in list(self._streams.items()):
            if st.cancelled:
                self.engine.release_request(rid)
                del self._streams[rid]
                continue
            new = st.req.output_ids[st.sent:]
            if new:
                st.sent += len(new)
                st.q.put(("tokens", list(new)))
            if st.req.finish_reason is not None:
                st.q.put(("end", st.req.finish_reason))
                self.engine.release_request(rid)
                del self._streams[rid]

    def _fail_all(self, msg: str) -> None:
        for rid, st in list(self._streams.items()):
            st.q.put(("error", msg))
            del self._streams[rid]


class _ApiHandler(BaseHTTPRequestHandler):
    server_version = "ptpu-api/1"

    def log_message(self, *a):   # noqa: D102 — quiet by design; the
        pass                     # monitor counters are the access log

    # -- plumbing -----------------------------------------------------------

    def _send_json(self, code: int, doc: dict,
                   extra_headers=()) -> None:
        data = json.dumps(doc).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)
        self.server.api._m_http.labels(code=str(code)).inc()

    def _send_error_body(self, code: int, message: str,
                         type: str = "invalid_request_error",
                         err_code: Optional[str] = None,
                         param: Optional[str] = None,
                         extra_headers=()) -> None:
        if code in (400, 401, 404):
            # HTTP-level client rejection: never reached the scheduler,
            # counted in the finish mix (SLO-good — the client's fault)
            self.server.api._m_finish.labels(reason="rejected").inc()
        self._send_json(code, api_error(message, type=type,
                                        code=err_code, param=param),
                        extra_headers=extra_headers)

    # -- auth / parsing -----------------------------------------------------

    def _auth(self):
        """(tenant, priority) from the bearer key; (None, None) when no
        keys are configured; False after answering 401."""
        api = self.server.api
        if not api.api_keys:
            return (None, None)
        hdr = self.headers.get("Authorization", "")
        key = hdr[len("Bearer "):].strip() \
            if hdr.startswith("Bearer ") else ""
        ent = api.api_keys.get(key)
        if ent is None:
            self._send_error_body(
                401, "missing or unknown API key",
                type="authentication_error", err_code="invalid_api_key")
            return False
        return ent

    def _read_body(self):
        try:
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n) if n else b""
            doc = json.loads(raw or b"{}")
            if not isinstance(doc, dict):
                raise ValueError("body must be a JSON object")
            return doc
        except (ValueError, OSError) as e:
            self._send_error_body(400, f"invalid JSON body: {e}")
            return None

    def _encode_text(self, text, param):
        api = self.server.api
        if api.encode is None:
            self._send_error_body(
                400, "string prompts need a server-side tokenizer "
                     "(ApiServer(encode=...)); send token-id arrays",
                err_code="no_tokenizer", param=param)
            return None
        return [int(t) for t in api.encode(text)]

    def _prompt_ids(self, body):
        """Token ids from a /v1/completions ``prompt`` (ints, one
        nested int array, or a string via encode); None after 400."""
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            return self._encode_text(prompt, "prompt")
        if isinstance(prompt, list) and prompt:
            if all(isinstance(t, int) for t in prompt):
                return list(prompt)
            if len(prompt) == 1 and isinstance(prompt[0], list) \
                    and all(isinstance(t, int) for t in prompt[0]):
                return list(prompt[0])
        self._send_error_body(
            400, "prompt must be a non-empty token-id array (or a "
                 "string with a server-side tokenizer)", param="prompt")
        return None

    def _chat_ids(self, body):
        """Token ids from ``messages`` — content as int arrays (the
        tokenizer-less extension) or strings via encode."""
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not msgs:
            self._send_error_body(400, "messages must be a non-empty "
                                       "array", param="messages")
            return None
        ids: list = []
        for m in msgs:
            content = m.get("content") if isinstance(m, dict) else None
            if isinstance(content, list) \
                    and all(isinstance(t, int) for t in content):
                ids.extend(content)
            elif isinstance(content, str):
                got = self._encode_text(content, "messages")
                if got is None:
                    return None
                ids.extend(got)
            else:
                self._send_error_body(
                    400, "message content must be a string or a "
                         "token-id array", param="messages")
                return None
        if not ids:
            self._send_error_body(400, "messages encode to an empty "
                                       "prompt", param="messages")
        return ids or None

    def _params(self, body, tenant, priority):
        """SamplingParams from the request body.  OpenAI deviation,
        documented: sampling engages only when ``temperature`` is
        present and > 0 — the default is greedy, the parity oracle."""
        temp = body.get("temperature")
        do_sample = temp is not None and float(temp) > 0
        return SamplingParams(
            max_new_tokens=int(body.get("max_tokens", 16)),
            do_sample=do_sample,
            temperature=float(temp) if do_sample else 1.0,
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            seed=(None if body.get("seed") is None
                  else int(body["seed"])),
            eos_token_id=(None if body.get("eos_token_id") is None
                          else int(body["eos_token_id"])),
            deadline_s=(None if body.get("deadline_s") is None
                        else float(body["deadline_s"])),
            tenant=tenant,
            priority=priority or "interactive",
        )

    # -- endpoints ----------------------------------------------------------

    def do_GET(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/v1/models":
            api = self.server.api
            self._send_json(200, {
                "object": "list",
                "data": [{"id": api.model_id, "object": "model",
                          "owned_by": "paddle_tpu"}],
            })
        else:
            self._send_error_body(404, f"no route {path}",
                                  type="not_found_error")

    def do_POST(self):   # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/")
        if path not in ("/v1/completions", "/v1/chat/completions"):
            self._send_error_body(404, f"no route {path}",
                                  type="not_found_error")
            return
        chat = path.endswith("/chat/completions")
        auth = self._auth()
        if auth is False:
            return
        body = self._read_body()
        if body is None:
            return
        model = body.get("model")
        api = self.server.api
        if model is not None and model != api.model_id:
            self._send_error_body(
                404, f"model {model!r} not found (serving "
                     f"{api.model_id!r})", type="not_found_error",
                err_code="model_not_found", param="model")
            return
        tenant = auth[0] or body.get("user") or None
        priority = body.get("priority") or auth[1]
        ids = self._chat_ids(body) if chat else self._prompt_ids(body)
        if ids is None:
            return
        try:
            params = self._params(body, tenant, priority)
        except (TypeError, ValueError) as e:
            self._send_error_body(400, f"bad sampling field: {e}")
            return
        # SLO-aware admission: shed best-effort work now, with a 429,
        # instead of queueing it to death
        if should_shed(params.priority, burn=api.live_burn()):
            api._m_finish.labels(reason="shed").inc()
            if tenant:
                api._m_tenant_shed.labels(tenant=tenant).inc()
            if mreqlog.enabled():
                mreqlog.emit(mreqlog.event(
                    f"api-shed-{next(api._ids)}",
                    prompt_tokens=len(ids), finish_reason="shed",
                    tenant=tenant, priority=params.priority))
            self._send_error_body(
                429, "best-effort capacity shed (SLO burn-rate breach); "
                     "retry later", type="rate_limit_error",
                err_code="shed", extra_headers=(("Retry-After", "1"),))
            return
        st = _Stream(ids, params)
        api.submit(st)
        budget = (_DEFAULT_BUDGET_S if params.deadline_s is None
                  else params.deadline_s + _DEADLINE_GRACE_S)
        if body.get("stream"):
            self._respond_stream(st, chat, budget)
        else:
            self._respond_json(st, chat, budget)

    # -- response modes -----------------------------------------------------

    def _next_event(self, st, hard_deadline):
        """One pump event, or ("timeout", None) once the HTTP budget is
        spent — the no-hang backstop.  Never blocks more than
        _WAIT_SLICE_S per poll."""
        while True:
            remaining = hard_deadline - time.monotonic()
            if remaining <= 0:
                st.cancelled = True
                return ("timeout", None)
            try:
                return st.q.get(timeout=min(remaining, _WAIT_SLICE_S))
            except queue.Empty:
                continue

    def _respond_json(self, st, chat, budget):
        hard = time.monotonic() + budget
        toks: list = []
        while True:
            kind, val = self._next_event(st, hard)
            if kind == "tokens":
                toks.extend(val)
            elif kind == "end":
                self._send_completion(st, chat, toks, val)
                return
            elif kind == "reject":
                self._send_error_body(400, val)
                return
            elif kind == "error":
                self._send_error_body(500, val, type="api_error")
                return
            else:   # timeout
                self._send_error_body(
                    504, "request exceeded its deadline budget",
                    type="api_error", err_code="deadline")
                return

    def _send_completion(self, st, chat, toks, reason):
        api = self.server.api
        text = api.decode(toks)
        rid = next(api._ids)
        usage = {"prompt_tokens": len(st.prompt_ids),
                 "completion_tokens": len(toks),
                 "total_tokens": len(st.prompt_ids) + len(toks)}
        if chat:
            doc = {"id": f"chatcmpl-{rid}", "object": "chat.completion",
                   "model": api.model_id,
                   "choices": [{"index": 0,
                                "message": {"role": "assistant",
                                            "content": text},
                                "token_ids": toks,
                                "finish_reason": reason}],
                   "usage": usage}
        else:
            doc = {"id": f"cmpl-{rid}", "object": "text_completion",
                   "model": api.model_id,
                   "choices": [{"index": 0, "text": text,
                                "token_ids": toks,
                                "finish_reason": reason}],
                   "usage": usage}
        self._send_json(200, doc)

    def _respond_stream(self, st, chat, budget):
        """SSE: ``data: <chunk json>`` per pump event, ``data: [DONE]``
        terminator, close-delimited (HTTP/1.0 semantics — no length
        needed).  A mid-stream deadline/error becomes a final chunk
        with the finish reason, then [DONE]: the stream always
        terminates cleanly."""
        api = self.server.api
        rid = next(api._ids)
        started = False
        obj = "chat.completion.chunk" if chat else "text_completion"
        cid = f"chatcmpl-{rid}" if chat else f"cmpl-{rid}"

        def chunk(toks, reason):
            choice = {"index": 0, "token_ids": toks,
                      "finish_reason": reason}
            if chat:
                delta = {} if reason is not None and not toks else \
                    {"content": api.decode(toks)}
                if not started:
                    delta["role"] = "assistant"
                choice["delta"] = delta
            else:
                choice["text"] = api.decode(toks)
            return {"id": cid, "object": obj, "model": api.model_id,
                    "choices": [choice]}

        hard = time.monotonic() + budget
        try:
            while True:
                kind, val = self._next_event(st, hard)
                if kind == "reject" and not started:
                    self._send_error_body(400, val)
                    return
                if kind == "error" and not started:
                    self._send_error_body(500, val, type="api_error")
                    return
                if kind == "timeout" and not started:
                    self._send_error_body(
                        504, "request exceeded its deadline budget",
                        type="api_error", err_code="deadline")
                    return
                if not started:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    api._m_http.labels(code="200").inc()
                if kind == "tokens":
                    self._sse(chunk(val, None))
                    started = True
                    continue
                # terminal: end / mid-stream error / timeout — one
                # final chunk naming the reason, then the terminator
                reason = val if kind == "end" else (
                    "deadline" if kind == "timeout" else "error")
                self._sse(chunk([], reason))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
                return
        except (BrokenPipeError, ConnectionResetError, OSError):
            st.cancelled = True   # client went away: pump releases the
            #                       engine request on its next cycle

    def _sse(self, doc: dict) -> None:
        self.wfile.write(b"data: " + json.dumps(doc).encode("utf-8")
                         + b"\n\n")
        self.wfile.flush()


def start_api_server(engine=None, router=None, port=None,
                     **kw) -> ApiServer:
    """Launch an :class:`ApiServer`; ``port`` defaults to
    ``PTPU_API_PORT`` (0 = ephemeral)."""
    if port is None:
        try:
            port = int(os.environ.get("PTPU_API_PORT", "0"))
        except ValueError:
            port = 0
    return ApiServer(engine=engine, router=router, port=port, **kw)
