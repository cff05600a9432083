"""The declared wire schemas — the port of `paddle_tpu/monitor/wire.py`.

Every cross-process surface the serving stack speaks is versioned here,
with the JAX package's names, values and key orders, so that a consumer
(a router, a dashboard, a log pipeline) reads either package's documents
alike:

- **rpc frame**: a pickled tuple of ``RPC_FRAME_MIN`` mandatory fields
  and up to ``RPC_FRAME_MAX`` in all;
- **/healthz**: ``schema_version`` only ever increases and keys only
  ever accrete.  The per-replica document and the fleet rollup version
  independently;
- **router feed**: the per-replica dict the load-aware router reads;
  keys only accrete, and a replica predating a key reads ``None``;
- **reqlog event**: the wide per-request event of ``monitor/reqlog.py``;
- **router protocol**: the request frames a multi-replica router and
  its replica workers exchange, and the router's metric names;
- **API error body**: the inner object of every non-2xx response of
  ``serving/api.py``.

The router, its replicas, the rpc layer and the fleet aggregator are not
ported yet (ROADMAP Queue 1 item 8); their schemas are declared here all
the same, as one registry.

stdlib only: ``monitor.serve``, ``monitor.reqlog`` and ``serving.api``
import this module.
"""
from __future__ import annotations

__all__ = ["RPC_FRAME_MIN", "RPC_FRAME_MAX", "HEALTHZ_SCHEMA_VERSION",
           "FLEET_HEALTHZ_SCHEMA_VERSION", "ROUTER_FEED_KEYS",
           "REQLOG_SCHEMA_VERSION", "REQLOG_EVENT_KEYS",
           "ROUTER_SCHEMA_VERSION", "ROUTER_SUBMIT_KEYS",
           "ROUTER_RESULT_KEYS", "ROUTER_HANDOFF_KEYS",
           "ROUTER_POLL_KEYS", "ROUTER_METRIC_NAMES",
           "API_ERROR_KEYS"]

# rpc wire frame: (fn, args, kwargs[, trace_hdr])
RPC_FRAME_MIN = 3
RPC_FRAME_MAX = 4

# /healthz per-replica document (monitor/serve.py): v3 carries the
# process identity (rss_bytes, open_fds) on top of host / rank /
# replica_id
HEALTHZ_SCHEMA_VERSION = 3

# the fleet rollup's /fleet/healthz (v2: the straggler block)
FLEET_HEALTHZ_SCHEMA_VERSION = 2

# the load-aware-routing feed's per-replica keys, in emission order
ROUTER_FEED_KEYS = (
    "url",
    "state",
    "host",
    "pid",
    "queue_depth",
    "running",
    "waiting",
    "decode_tokens_per_s",
    "goodput_tokens_per_s",
    "padding_waste_rows",
    "kernels_per_step",
    "step_time",
    "goodput_examples_per_s",
    "data_wait_frac",
    "straggler_skew",
    "rss_bytes",
    "open_fds",
    "uptime_s",
    "last_activity_age_s",
    "scrape_age_s",
    "scrape_errors",
    "fail_streak",
    "last_err",
    "harvested",
    # serving throughput: cumulative draft acceptance, prefix-cache-paid
    # prompt tokens
    "spec_accept_rate",
    "prefix_hit_tokens",
    # SLO burn: the worst burn rate over every (objective, window) and
    # the smallest remaining error budget
    "slo_max_burn_rate",
    "slo_min_budget_remaining",
    # the router's circuit breaker (filled by the router, None from the
    # aggregator)
    "breaker_state",
    "breaker_trips",
    # {tenant: {"tokens", "admitted", "shed"}} from the serving/tenant_*
    # series
    "tenants",
    # KV-pool pressure (the memory microscope)
    "kv_blocks_in_use",
    "kv_block_utilization",
    "kv_pressure_dumps",
    "tenant_kv_blocks",
)

# -- wide-event request log -------------------------------------------------
# One structured event per finished request (monitor/reqlog.py), served
# at GET /requests/recent and optionally sunk to rotating JSONL
# (PTPU_REQLOG).  Keys only ever accrete and schema_version only ever
# increases.
REQLOG_SCHEMA_VERSION = 2        # v2: + tenant, priority

REQLOG_EVENT_KEYS = (
    "schema_version",
    "rid",
    "trace_id",
    "replica_id",
    "ts",
    "arrival_ts",
    "prompt_tokens",
    "generated_tokens",
    "queue_wait_s",
    "ttft_s",
    "tpot_avg_s",
    "tpot_max_s",
    "prefill_chunks",
    "prefix_hit_tokens",
    "spec_proposed",
    "spec_accepted",
    "preemptions",
    "peak_kv_blocks",
    # stop | abort | deadline | released | migrated | shed | rejected:
    # "migrated" is a request handed to another engine, "shed" best-effort
    # work dropped by SLO-aware admission (HTTP 429), "rejected" an HTTP
    # client error (auth / parse) that never reached the scheduler;
    # monitor/slo.py's error_rate counts all three good
    "finish_reason",
    # fair-share tenant (None = the default pool) and priority class
    # (interactive | batch | best-effort)
    "tenant",
    "priority",
)

# -- multi-replica router protocol ------------------------------------------
# The payload dicts a router and its replica workers exchange; one
# version number covers the protocol and every frame carries it.
ROUTER_SCHEMA_VERSION = 1

# router -> replica: admit one request
ROUTER_SUBMIT_KEYS = (
    "schema_version",
    "rid",              # the router's request id
    "prompt_ids",       # list[int]
    "params",           # SamplingParams as a plain dict
    "trace",            # monitor.trace inject() header, or None
)

# replica -> router: one finished (or failed) request
ROUTER_RESULT_KEYS = (
    "schema_version",
    "rid",
    "replica",          # reporting replica's name
    "ok",               # bool; False => error is set, token_ids is None
    "token_ids",        # [prompt + generated] ints
    "finish_reason",
    "error",            # str | None
)

# prefill worker -> router -> decode worker: a mid-flight request with
# its KV snapshot
ROUTER_HANDOFF_KEYS = (
    "schema_version",
    "rid",
    "prompt_ids",
    "output_ids",       # tokens emitted so far (>= 1)
    "params",
    "key",              # the row's PRNG key (uint32[2])
    "kv",               # BlockKVCache.swap_out() host snapshot
    "trace",
)

# replica -> router: one poll response
ROUTER_POLL_KEYS = (
    "schema_version",
    "replica",
    "draining",         # admission stopped, waiting requests requeued
    "results",          # list of ROUTER_RESULT_KEYS frames
    "handoffs",         # list of ROUTER_HANDOFF_KEYS frames
    "requeued",         # list of ROUTER_SUBMIT_KEYS frames
)

# the router's exported metric names
ROUTER_METRIC_NAMES = (
    "router/requests",
    "router/dispatched",
    "router/sticky_hits",
    "router/deadline_rejected",
    "router/failovers",
    "router/requeued",
    "router/handoffs",
    "router/stale_results",
    "router/errors",
    "router/queue_depth",
    "router/inflight",
    "router/breaker_trips",
    "router/breaker_open",
    "router/deadline_inflight",
)

# -- HTTP API error body ------------------------------------------------------
# The ``{"error": {...}}`` inner object every non-2xx response from
# serving/api.py carries, in the OpenAI client's shape.
API_ERROR_KEYS = (
    "message",          # human-readable description
    "type",             # invalid_request_error | authentication_error |
    #                     not_found_error | rate_limit_error | api_error
    "code",             # machine key: "shed", "deadline",
    #                     "model_not_found", ..., or None
    "param",            # offending request field, or None
)
