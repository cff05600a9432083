"""paddle_tpu_torch's HTTP front door (`serving.api.ApiServer`) against
the JAX package's, on the CPU.

- **The front door.**  Every scenario of ``tests/test_api.py``'s
  ``TestApiServer`` runs against both packages' ``ApiServer`` over that
  file's duck-typed fake engine (`_FakeEngine`, `_BurnStub`, `_post`,
  `_sse_chunks`): models, completion JSON, SSE framing, chat (JSON and
  stream), eos, 400 / 404 / 401 with the wire's error shape, the tenant
  mapping, the shed 429, the deadline backstop over a wedged engine, and
  an engine exception as a 500.  Each scenario records every response's
  status, headers of note and body (SSE bodies as their chunks, ids
  masked), the `SamplingParams` each request reached the engine with,
  and the engine's releases; the two records must be equal.
- **Real engines.**  The JAX ``ApiServer`` over the JAX `LLMEngine`, and
  the port's over the port's `LLMEngine` on the CPU, serve a 2-layer GPT
  of hidden 64 (the JAX weights carried across by `convert.py`): a
  greedy, a seeded, a streamed and a chat request, one at a time.  Every
  ``token_ids`` list must be equal, and equal to the port engine's own
  `generate`.  The JAX side runs once, in a module fixture.
"""
import dataclasses
import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from test_api import _BurnStub, _FakeEngine, _post, _sse_chunks

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import api as japi

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.monitor.wire import API_ERROR_KEYS
from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                      SamplingParams)
from paddle_tpu_torch.serving import api as tapi
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


PKGS = {"jax": SimpleNamespace(api=japi, slo=jslo),
        "port": SimpleNamespace(api=tapi, slo=tslo)}


class _Recorder(_FakeEngine):
    """The fake engine, recording the sampling fields of every request
    that reaches it."""

    def __init__(self, wedged=False):
        super().__init__(wedged=wedged)
        self.seen = []

    def add_request(self, prompt_ids, params):
        self.seen.append(dataclasses.asdict(params))
        return super().add_request(prompt_ids, params)


def _mask(doc):
    """A response body with its per-server ids masked."""
    if isinstance(doc, dict):
        return {k: ("<id>" if k == "id" else _mask(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


def _call(srv, path, body=None, key=None):
    """(status, Retry-After, body) of one request; an SSE body as its
    chunks."""
    try:
        if body is None:
            resp = urllib.request.urlopen(srv.url + path, timeout=30)
        else:
            resp = _post(srv.url + path, body, key=key)
        if body is not None and body.get("stream"):
            return resp.status, None, _mask(_sse_chunks(resp))
        return resp.status, None, _mask(json.loads(resp.read()))
    except urllib.error.HTTPError as e:
        return (e.code, e.headers.get("Retry-After"),
                _mask(json.loads(e.read())))


def _serve(pkg, eng=None, **kw):
    kw.setdefault("api_keys", {})
    return pkg.api.ApiServer(engine=eng or _Recorder(), poll_s=0.005, **kw)


def _wait_released(eng, timeout=5.0):
    end = time.monotonic() + timeout
    while eng._requests and time.monotonic() < end:
        time.sleep(0.01)


def _plain(pkg, calls, **kw):
    """Run ``calls`` (path, body[, key]) against a fresh server."""
    eng = _Recorder()
    srv = _serve(pkg, eng, **kw)
    try:
        out = [_call(srv, *c) for c in calls]
        _wait_released(eng)
    finally:
        srv.stop()
    return {"responses": out, "seen": eng.seen, "released": eng.released,
            "left": sorted(eng._requests)}


CHAT = {"messages": [{"role": "user", "content": [5, 6, 7]}],
        "max_tokens": 3}


def s_models(pkg, mp):
    return _plain(pkg, [("/v1/models",)])


def s_completion_json(pkg, mp):
    return _plain(pkg, [("/v1/completions",
                         {"prompt": [5, 6, 7], "max_tokens": 4})])


def s_completion_stream(pkg, mp):
    return _plain(pkg, [("/v1/completions", {"prompt": [5, 6, 7],
                                             "max_tokens": 4,
                                             "stream": True})])


def s_chat_json_and_stream(pkg, mp):
    return _plain(pkg, [("/v1/chat/completions", CHAT),
                        ("/v1/chat/completions", dict(CHAT, stream=True))])


def s_eos(pkg, mp):
    return _plain(pkg, [("/v1/completions",
                         {"prompt": [5, 6, 7], "max_tokens": 16,
                          "eos_token_id": 9})])


def s_bad_requests_400(pkg, mp):
    return _plain(pkg, [
        ("/v1/completions", {"prompt": "strings need a tokenizer"}),
        ("/v1/completions", {"prompt": []}),
        ("/v1/completions", {"prompt": {"not": "a list"}}),
        ("/v1/chat/completions", {"messages": []}),
        ("/v1/chat/completions", {"messages": [{"content": 3}]}),
        ("/v1/completions", {"prompt": [1], "max_tokens": "many"})])


def s_not_found_404(pkg, mp):
    return _plain(pkg, [
        ("/v1/completions", {"model": "gpt-oss-999", "prompt": [1]}),
        ("/v1/nothing", {"prompt": [1]}),
        ("/v1/nothing",)])


def s_auth_401_and_tenant(pkg, mp):
    keys = {"sk-a": ("acme", "batch")}
    return _plain(pkg, [
        ("/v1/completions", {"prompt": [1]}, None),
        ("/v1/completions", {"prompt": [1]}, "sk-wrong"),
        ("/v1/completions", {"prompt": [1], "max_tokens": 1}, "sk-a"),
        ("/v1/completions", {"prompt": [1], "max_tokens": 1,
                             "user": "spoof", "priority": "interactive"},
         "sk-a")], api_keys=keys)


def s_shed_429(pkg, mp):
    keys = {"sk-be": ("free", "best-effort"),
            "sk-int": ("acme", "interactive")}
    eng = _Recorder()
    srv = _serve(pkg, eng, api_keys=keys)
    pkg.slo.install(_BurnStub(fast=10.0))
    try:
        t0 = time.monotonic()
        out = [_call(srv, "/v1/completions",
                     {"prompt": [1], "max_tokens": 1}, "sk-be")]
        assert time.monotonic() - t0 < 5.0, "shed must answer at once"
        queued = sorted(eng._requests)
        out.append(_call(srv, "/v1/completions",
                         {"prompt": [1], "max_tokens": 1}, "sk-int"))
        pkg.slo.install(_BurnStub(fast=0.5))
        out.append(_call(srv, "/v1/completions",
                         {"prompt": [1], "max_tokens": 1}, "sk-be"))
    finally:
        pkg.slo.refresh()
        srv.stop()
    return {"responses": out, "queued_after_shed": queued,
            "seen": eng.seen, "released": eng.released}


def s_deadline_backstop(pkg, mp):
    mp.setattr(pkg.api, "_DEADLINE_GRACE_S", 0.3)
    eng = _Recorder(wedged=True)
    srv = _serve(pkg, eng)
    try:
        out = []
        for stream in (False, True):
            t0 = time.monotonic()
            out.append(_call(srv, "/v1/completions",
                             {"prompt": [1], "max_tokens": 4,
                              "deadline_s": 0.2, "stream": stream}))
            assert time.monotonic() - t0 < 3.0, f"stream={stream} hung"
        _wait_released(eng)
    finally:
        srv.stop()
    return {"responses": out, "seen": eng.seen, "released": eng.released,
            "left": sorted(eng._requests)}


def s_engine_exception_500(pkg, mp):
    eng = _Recorder()

    def boom():
        raise RuntimeError("backend on fire")

    eng.step = boom
    srv = _serve(pkg, eng)
    try:
        out = [_call(srv, "/v1/completions",
                     {"prompt": [1], "max_tokens": 2})]
    finally:
        srv.stop()
    return {"responses": out, "seen": eng.seen}


SCENARIOS = {f.__name__[2:]: f for f in (
    s_models, s_completion_json, s_completion_stream,
    s_chat_json_and_stream, s_eos, s_bad_requests_400, s_not_found_404,
    s_auth_401_and_tenant, s_shed_429, s_deadline_backstop,
    s_engine_exception_500)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_front_door_matches_jax(scenario, monkeypatch):
    got = {name: SCENARIOS[scenario](pkg, monkeypatch)
           for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    assert got["jax"]["responses"]
    # the error bodies carry exactly the wire's keys
    for status, _, body in got["port"]["responses"]:
        if status >= 400:
            assert tuple(body["error"]) == API_ERROR_KEYS


def test_router_raises_until_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tapi.ApiServer(router=object())
    with pytest.raises(ValueError, match="exactly one"):
        tapi.ApiServer()


# -- real engines -------------------------------------------------------------

NEW = 6
SEEDED = {"temperature": 0.8, "top_k": 20, "top_p": 0.9, "seed": 11}
REQUESTS = {
    "greedy": ("/v1/completions", {"prompt": [3, 1, 4, 1, 5],
                                   "max_tokens": NEW}),
    "seeded": ("/v1/completions", dict({"prompt": [9, 2, 6, 5, 3, 5],
                                        "max_tokens": NEW}, **SEEDED)),
    "streamed": ("/v1/completions", {"prompt": [8, 9, 7, 9, 3, 2, 3],
                                     "max_tokens": NEW, "stream": True}),
    "chat": ("/v1/chat/completions",
             {"messages": [{"role": "system", "content": [8, 4]},
                           {"role": "user", "content": [6, 2, 6, 4]}],
              "max_tokens": NEW}),
}


def _tokens(status, body):
    """The completion's token ids from a JSON body or SSE chunks."""
    assert status == 200, body
    if isinstance(body, list):
        assert body[-1]["choices"][0]["finish_reason"] == "stop"
        return [t for c in body for t in c["choices"][0]["token_ids"]]
    assert body["choices"][0]["finish_reason"] == "stop"
    return body["choices"][0]["token_ids"]


def _serve_requests(pkg, eng):
    srv = pkg.api.ApiServer(engine=eng, api_keys={}, poll_s=0.005)
    try:
        out = {}
        for name, (path, body) in REQUESTS.items():
            status, _, doc = _call(srv, path, body)
            out[name] = _tokens(status, doc)
    finally:
        srv.stop()
    return out


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_test_config(stacked_blocks=True, sequence_parallel=False))
    m.eval()
    return m


@pytest.fixture(scope="module")
def jax_tokens(jax_model):
    return _serve_requests(PKGS["jax"], JaxEngine(jax_model,
                                                  JaxEngineConfig()))


@pytest.fixture(scope="module")
def port_engine(jax_model):
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jax_model)._param_arrays().items()}
    m = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    m.load_params(params_from_numpy(arrays, device="cpu"))
    return LLMEngine(m, EngineConfig(device="cpu"))


@pytest.fixture(scope="module")
def port_tokens(port_engine):
    return _serve_requests(PKGS["port"], port_engine)


@pytest.mark.parametrize("kind", list(REQUESTS))
def test_real_engines_same_tokens(kind, jax_tokens, port_tokens,
                                  port_engine):
    assert len(jax_tokens[kind]) == NEW
    assert port_tokens[kind] == jax_tokens[kind]
    # ... and the port engine's own generate gives them too
    path, body = REQUESTS[kind]
    prompt = body.get("prompt") or [t for m in body["messages"]
                                    for t in m["content"]]
    sample = {"do_sample": True, "temperature": body["temperature"],
              "top_k": body["top_k"], "top_p": body["top_p"],
              "seed": body["seed"]} if "seed" in body else {}
    out, = port_engine.generate([np.asarray(prompt, np.int32)],
                                SamplingParams(max_new_tokens=NEW,
                                               **sample))
    assert out[len(prompt):].tolist() == jax_tokens[kind]
    assert port_engine.cache.blocks_in_use == 0
    assert not port_engine._requests

