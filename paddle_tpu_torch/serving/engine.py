"""`LLMEngine` — continuous batching over a paged KV cache, the port of
`paddle_tpu/serving/engine.py`.

The scheduler (waiting queue, token-budget admission, preemption, prefix
adoption) lives on the host; each step runs one of these bodies on the
device:

- **prefill** — one request's whole prompt at its exact length: causal
  flash attention within the prompt (`ops.flash_attention`, on the fp K/V
  just computed) plus the paged K/V writes (quantizing ones for int8
  pools).
- **ragged** (``attention_impl="ragged"``, the default) — the
  ``(max_num_seqs, 1)`` decode step, padded to ``max_num_seqs`` rows
  whatever the batch holds, and the ``(1, C)`` continuation of a chunked
  prefill, of a prefix-cache hit's uncached tail or of a forked child's
  re-fed position.  Per layer ONE `ops.ragged_paged_attention` call
  writes the new tokens' K/V into their slots and attends the ragged
  batch against the pools: the int8 kernel for ``kv_cache_dtype="int8"``,
  whose plain version on the CPU is the JAX fallback's (quantized write,
  scale-folded attention).  The decode step reads its inputs from one
  static device buffer (``toks | pos0 | lens | slots | tables``), filled
  each step by ONE host-to-device copy from a pinned staging buffer, and
  ends at the fp32 logits: on the card it is captured as one CUDA graph,
  keyed ``("ragged", max_num_seqs, 1)`` as the JAX engine keys its
  compiled program, and replayed every step (`graphs.StepGraph`;
  ``PTPU_CUDA_GRAPHS=0`` runs it eagerly).
- **verify** (speculative decoding, ``speculative_tokens=k``) — the
  ragged body at ``(max_num_seqs, k+1)``: each greedy row's last token
  plus up to k n-gram drafts (`spec.propose_ngram`), draft positions past
  a row's own drafts on the dropped slot.  It returns the position-0 fp32
  logits (the sampler's input) and every position's greedy argmax; the
  longest draft run that matches the greedy tokens, plus the correction
  token, is accepted and every table rolls back to its accepted length
  (`BlockKVCache.truncate_to`).  Captured like the decode step, keyed
  ``("verify", max_num_seqs, k+1)``.  A step with no drafts anywhere runs
  the plain decode step.
- **chunk** (``attention_impl="bucketed"``, the JAX fallback) — the
  paged write then `ops.paged_attention_arrays` (gather and masked
  attention in torch, eager), the decode batch padded to a power of two.
  It exists only for parity with the JAX engine's options: in JAX it
  serves hardware where the Pallas ragged kernel cannot run, while the
  port's ragged kernel runs on every card, so nothing here needs it.  It
  is slower on the card than the captured ragged step and is not timed.
- **sample** — greedy argmax, or temperature / top-k / top-p and one
  categorical draw from the row's own threefry key (`core.random`), split
  once a step, as the JAX engine's per-row sampler draws (``(1, V)``
  noise a row); a greedy row keeps its key.  So a seeded request gives
  the tokens of its solo dense ``generate(seed=...)`` in the JAX package.
  After the step, outside its graph (JAX's separate ``sample`` program).

The captures are counted in ``compiles`` by kind, as the JAX engine
counts its compiles (`_count_compile`).  Prefill and chunk steps run
eagerly.  Copy-on-write copies and prefix adoption change only tables
(graph inputs) and pool rows in place; the pools are never reallocated,
so the captured steps stay valid.

Requests can be forked (`fork_request`: the child shares the parent's
blocks and re-feeds its last token into a private copy of the last
block), exported and adopted across engines (`export_request` /
`adopt_request`: the JAX package's handoff, so a request moves between
the two packages too), and given a deadline (``deadline_s``: an expired
request is released at the next step and `generate` returns None in its
place).

The final LayerNorm and tied LM head follow the JAX ``_model_logits``
(`nn.functional.layer_norm_arrays`, not the block LN).  Padding rows carry
``kv_lens = 0``, table entries ``num_blocks`` and slots ``num_slots``:
their writes are dropped and their outputs ignored.

Telemetry, as the JAX engine's (all default off, each hook a flag check
when its gate is unset):

- the registry (``PTPU_MONITOR``): ``serving/queue_depth``,
  ``running``, ``waiting``, ``blocks_in_use``, ``block_utilization``,
  ``kv_free_blocks``, ``kv_parked_blocks``, ``prefill_tokens``,
  ``decode_tokens``, ``prefill_tps``, ``decode_tps``, ``preemptions``,
  ``requests_finished``, ``deadline_expired``, ``step_time{phase}``,
  ``ttft`` / ``tpot`` (with ``{tenant}`` series and trace-id exemplars),
  ``queue_wait``, ``finish_reason{reason}``, ``tenant_tokens`` /
  ``tenant_admitted`` / ``tenant_shed``, ``compiles{kind}`` (raised at
  each `StepGraph` capture: the port's compiles are its captures, kinds
  "ragged" and "verify"), ``attention_impl{kind}``,
  ``kernels_per_step`` (the decode step's dispatches: its step and the
  sampler), ``padding_waste{kind}``, ``goodput_tokens_per_s``,
  ``spec_proposed`` / ``spec_accepted`` / ``spec_accept_rate``, and the
  int8 pool's ``lowbit/kv_blocks{dtype}`` / ``lowbit/bytes_saved{wing}``.
  Every value is a host number: a scrape from another thread never
  touches the card, so it cannot break a capture on the engine's thread.
- spans (``PTPU_TRACE``): a root ``serving/request`` span a request with
  ``serving/queue_wait``, ``serving/prefill`` (one a chunk) and
  ``serving/decode_step`` children (`request_trace`).
- the wide ``monitor.reqlog`` event a finished request (``PTPU_REQLOG``),
  the ``monitor.slo`` tick a step (``PTPU_SLO``), with SLO-violating
  traces kept by tail sampling and best-effort requests still queued
  shed while the burn rate breaches ``PTPU_SHED_BURN``.
- ``EngineConfig(metrics_port=...)`` starts ``monitor.serve``'s endpoint.

TTFT and TPOT are host times, taken when a step's tokens have reached
the host.  Left out for later slices: ``decode_breakdown``, the memory
microscope (``PTPU_MEMOBS``), the fault injection of
``resilience/faults`` and CUDA-graph capture of the prefill and chunk
steps.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .. import monitor
from ..core import random as _random
from ..device import resolve_device
from ..graphs import StepGraph
from ..models.gpt import BLOCK_PARAMS, _filter_logits, _stacked_block_body
from ..monitor import reqlog as mreqlog
from ..monitor import slo as mslo
from ..monitor import trace as mtrace
from ..nn.functional import layer_norm_arrays
from ..ops.flash_attention import flash_attention_arrays
from ..ops.paged_attention import (paged_attention_arrays,
                                   paged_cache_update_arrays,
                                   quantized_cache_update_arrays)
from ..ops.ragged_paged_attention import ragged_paged_attention_arrays
from ..resilience.retry import Deadline
from .kv_cache import (BlockKVCache, prefix_block_keys, snapshot_from_handoff,
                       snapshot_to_handoff)
from .scheduler import (Request, SamplingParams, Scheduler, priority_rank,
                        should_shed, worst_fast_burn)
from .spec import propose_ngram

__all__ = ["EngineConfig", "LLMEngine"]


@dataclasses.dataclass
class EngineConfig:
    block_size: int = 16
    num_blocks: Optional[int] = None       # default: dense-equivalent pool
    max_num_seqs: int = 8
    # prefill token budget per step; None = whole prompt in one chunk
    max_num_batched_tokens: Optional[int] = None
    max_model_len: Optional[int] = None    # default: max_position_embeddings
    # "int8": int8 KV pools with per-block-per-head scales; the default
    # num_blocks then fills the fp pool's bytes (~2x blocks for bf16, ~4x
    # for fp32).  None = pools in the engine's dtype.
    kv_cache_dtype: Optional[str] = None
    # launch monitor.serve's live endpoint (/metrics, /healthz,
    # /traces/<id>, ...) on this port when the engine boots; 0 =
    # ephemeral (read it back from engine.metrics_server.port), None = no
    # server
    metrics_port: Optional[int] = None
    # "ragged" (default) or "bucketed" (kept for parity with JAX, eager
    # and slower on the card); None reads PTPU_RAGGED ("0", "false",
    # "off" -> bucketed)
    attention_impl: Optional[str] = None
    # automatic prefix caching; None reads PTPU_PREFIX_CACHE (default off:
    # finished requests then leave parked blocks, so blocks_in_use is no
    # longer 0 at idle)
    enable_prefix_caching: Optional[bool] = None
    # speculative decoding: k n-gram drafts per greedy row, verified in
    # one (max_num_seqs, k+1) ragged step; 0 = off, None reads
    # PTPU_SPEC_TOKENS.  Needs attention_impl="ragged".
    speculative_tokens: Optional[int] = None
    # the n-gram proposer: longest / shortest suffix tried, lookback
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    spec_lookup_window: int = 1024
    # port-only fields, keyword-only so that a positional call means what
    # it means in JAX
    _: dataclasses.KW_ONLY
    device: Optional[str] = None           # None = "cuda"
    dtype: Optional[torch.dtype] = None    # None = the model's dtype


class LLMEngine:
    """add_request() / step() / generate() over a stacked-blocks GPT."""

    def __init__(self, model, config: Optional[EngineConfig] = None):
        cfg = model.cfg
        if not cfg.stacked_blocks:
            raise ValueError(
                "LLMEngine serves the stacked-blocks GPT form "
                "(GPTConfig(stacked_blocks=True)), as the JAX engine does")
        self.cfg = cfg
        self.config = c = config or EngineConfig()
        self.device = resolve_device(c.device)
        params = model.param_arrays()
        self.dtype = c.dtype or params["wte"].dtype
        self.params = {n: t.detach().to(self.device, self.dtype)
                       for n, t in params.items()}
        self.max_model_len = int(c.max_model_len
                                 or cfg.max_position_embeddings)
        # table width as the JAX engine computes it (the dense ring rounds
        # up to 128), so both reduce over the same padded extent
        ring = -(-self.max_model_len // 128) * 128
        self.blocks_per_seq = -(-ring // c.block_size)
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // self.num_heads
        if c.kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f'kv_cache_dtype must be None or "int8", got '
                f'{c.kv_cache_dtype!r}')
        self.kv_quant = c.kv_cache_dtype
        impl = c.attention_impl
        if impl is None:
            impl = ("bucketed"
                    if os.environ.get("PTPU_RAGGED", "1").lower()
                    in ("0", "false", "off") else "ragged")
        if impl not in ("ragged", "bucketed"):
            raise ValueError(
                f'attention_impl must be "ragged" or "bucketed", got '
                f'{impl!r}')
        self.attention_impl = impl
        pc = c.enable_prefix_caching
        if pc is None:
            pc = os.environ.get("PTPU_PREFIX_CACHE", "0").lower() in (
                "1", "true", "on")
        self.prefix_caching = bool(pc)
        st = c.speculative_tokens
        if st is None:
            st = int(os.environ.get("PTPU_SPEC_TOKENS", "0") or 0)
        self.spec_tokens = max(0, int(st))
        if self.spec_tokens and self.attention_impl != "ragged":
            raise ValueError(
                "speculative decoding needs the ragged attention path "
                "(the fixed-shape multi-token verify program); "
                'attention_impl="bucketed" cannot serve it')
        fp_blocks = c.max_num_seqs * self.blocks_per_seq
        if c.num_blocks is not None:
            num_blocks = c.num_blocks
        elif self.kv_quant:
            # the fp default pool's bytes, in int8 blocks
            geo = (c.block_size, self.num_heads, self.head_dim)
            layers = cfg.num_hidden_layers
            budget = fp_blocks * BlockKVCache.block_bytes(
                *geo, self.dtype) * layers
            num_blocks = budget // (BlockKVCache.block_bytes(
                *geo, self.dtype, self.kv_quant) * layers)
        else:
            num_blocks = fp_blocks
        self.cache = BlockKVCache(
            cfg.num_hidden_layers, num_blocks, c.block_size, self.num_heads,
            self.head_dim, dtype=self.dtype, device=self.device,
            kv_quant=self.kv_quant)
        if monitor.enabled():
            monitor.gauge("lowbit/kv_blocks",
                          "paged KV pool size in blocks").labels(
                dtype=self.kv_quant or _dtype_name(self.dtype)).set(
                    num_blocks)
            if self.kv_quant:
                # what this pool's block count would cost at the engine's
                # dtype, minus what the quantized pool costs
                fp_cost = num_blocks * cfg.num_hidden_layers \
                    * BlockKVCache.block_bytes(c.block_size, self.num_heads,
                                               self.head_dim, self.dtype)
                monitor.counter("lowbit/bytes_saved").labels(
                    wing="kv_cache").add(max(0, fp_cost
                                             - self.cache.pool_bytes))
        self.scheduler = Scheduler(
            self.cache, max_num_seqs=c.max_num_seqs,
            max_num_batched_tokens=(c.max_num_batched_tokens
                                    or self.max_model_len),
            spec_tokens=self.spec_tokens, max_model_len=self.max_model_len)
        self._requests: dict = {}
        self._next_id = 0
        # step bodies run so far, by kind ("chunk" = a (1, C)
        # continuation, "decode" = a decode step, plain or verify);
        # verify_steps counts the speculative ones apart
        self.step_counts = {"prefill": 0, "chunk": 0, "decode": 0}
        self.verify_steps = 0
        self.num_preemptions = 0
        self.num_expired = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        # captured step graphs by kind, and the static steps by JAX key
        self.compiles: dict = {}
        self._steps: dict = {}
        self._init_metrics()
        self._wall_s_total = 0.0
        self._goodput_toks = 0
        # rid -> trace_id survives release_request (the spans live in the
        # bounded monitor.trace store), bounded like that store
        self._trace_ids: "OrderedDict" = OrderedDict()
        self.metrics_server = None
        if c.metrics_port is not None:
            from ..monitor import serve as mserve

            self.metrics_server = mserve.start_server(c.metrics_port)

    def _init_metrics(self):
        """The JAX engine's metric handles (no-ops with PTPU_MONITOR
        off); every value they take is a host number."""
        m = monitor
        self._m_queue = m.gauge("serving/queue_depth",
                                "requests waiting for admission")
        self._m_running = m.gauge("serving/running", "requests decoding")
        self._m_waiting = m.gauge("serving/waiting",
                                  "waiting incl. preempted")
        self._m_blocks = m.gauge("serving/blocks_in_use", "KV blocks held")
        self._m_util = m.gauge("serving/block_utilization",
                               "blocks_in_use / num_blocks")
        self._m_pre_toks = m.counter("serving/prefill_tokens")
        self._m_dec_toks = m.counter("serving/decode_tokens")
        self._m_pre_tps = m.gauge("serving/prefill_tps")
        self._m_dec_tps = m.gauge("serving/decode_tps")
        self._m_preempt = m.counter("serving/preemptions")
        self._m_done = m.counter("serving/requests_finished")
        self._m_expired = m.counter("serving/deadline_expired",
                                    "requests aborted past deadline_s")
        self._m_step = m.histogram("serving/step_time")
        self._m_ttft = m.histogram("serving/ttft",
                                   "arrival to first token, seconds")
        self._m_tpot = m.histogram("serving/tpot",
                                   "inter-token latency after the first, "
                                   "seconds")
        self._m_queue_wait = m.histogram(
            "serving/queue_wait",
            "arrival to first prefill compute, seconds")
        self._m_finish = m.counter(
            "serving/finish_reason",
            "finished requests by outcome "
            "(stop|abort|deadline|released|migrated|shed)")
        # tenant-labeled series materialize only for requests that carry
        # a tenant
        self._m_tenant_tokens = m.counter(
            "serving/tenant_tokens", "generated tokens by tenant")
        self._m_tenant_admitted = m.counter(
            "serving/tenant_admitted", "requests accepted by tenant")
        self._m_tenant_shed = m.counter(
            "serving/tenant_shed",
            "best-effort requests shed by SLO admission control, "
            "by tenant")
        self._m_compiles = m.counter("serving/compiles",
                                     "step-program cache misses")
        self._m_attn_impl = m.counter(
            "serving/attention_impl",
            "decode steps served, by attention path")
        self._m_kernels = m.gauge(
            "serving/kernels_per_step",
            "distinct compiled programs dispatched per decode step")
        pad = m.gauge(
            "serving/padding_waste",
            "padded fraction of the fixed-shape decode program")
        self._m_pad_rows = pad.labels(kind="rows")
        self._m_pad_toks = pad.labels(kind="tokens")
        self._m_goodput = m.gauge(
            "serving/goodput_tokens_per_s",
            "generated tokens per second of total engine step wall "
            "time (prefill/idle/scheduling included)")
        self._m_spec_prop = m.counter(
            "serving/spec_proposed", "draft tokens proposed")
        self._m_spec_acc = m.counter(
            "serving/spec_accepted", "draft tokens accepted by verify")
        self._m_spec_rate = m.gauge(
            "serving/spec_accept_rate",
            "cumulative accepted/proposed draft-token ratio")
        self._m_kv_free = m.gauge(
            "serving/kv_free_blocks",
            "truly free KV blocks (free list only, parked excluded)")
        self._m_kv_parked = m.gauge(
            "serving/kv_parked_blocks",
            "LRU-parked prefix blocks (adoptable AND reclaimable)")

    def _count_capture(self, kind: str) -> None:
        """A `StepGraph` capture: the port's counterpart of the JAX
        engine's step-program compile (``serving/compiles{kind}``)."""
        self._m_compiles.labels(kind=kind).inc()

    # -- request API --------------------------------------------------------

    def _check_len(self, prompt_len, params):
        if prompt_len + params.max_new_tokens > self.max_model_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({params.max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")

    def _new_request(self, prompt, params, key) -> Request:
        req = Request(self._next_id, prompt, params)
        self._next_id += 1
        req.key = key
        if params.deadline_s is not None:
            req.deadline = Deadline(params.deadline_s)
        return req

    def _enqueue(self, req, **trace_attrs) -> int:
        self._begin_trace(req, **trace_attrs)
        self._requests[req.req_id] = req
        self.scheduler.add(req)
        return req.req_id

    def add_request(self, prompt_ids, sampling_params=None) -> int:
        params = sampling_params or SamplingParams()
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        self._check_len(len(prompt), params)
        req = self._new_request(prompt, params, self._init_key(params))
        if self.prefix_caching:
            # matched and adopted at admission, registered as prefill
            # fills the blocks
            req.prefix_keys = prefix_block_keys(prompt,
                                                self.cache.block_size)
        rid = self._enqueue(req)
        if monitor.enabled() and params.tenant:
            self._m_tenant_admitted.labels(tenant=params.tenant).inc()
        return rid

    def fork_request(self, parent_id, sampling_params=None) -> int:
        """A new request continuing the parent's current text, sharing
        the parent's KV blocks (refcounted; the shared partial last block
        is copied at once, since the child re-writes its last position)."""
        parent = self._requests[parent_id]
        if parent.state != Request.RUNNING or not parent.prefill_done:
            raise ValueError(
                "fork requires a running, fully-prefilled parent")
        params = sampling_params or parent.params
        prompt = parent.prompt_ids + parent.output_ids
        if len(prompt) + params.max_new_tokens > self.max_model_len:
            raise ValueError("forked request exceeds max_model_len")
        req = self._new_request(prompt, params, self._init_key(params))
        # the parent has written total_len - 1 positions; the child
        # re-feeds its last token through its own prefill continuation,
        # whose write must land in a private copy of the last block
        req.num_computed = parent.total_len - 1
        self.cache.fork(parent_id, req.req_id)
        self.cache.privatize_last_block(req.req_id)
        return self._enqueue(req, forked_from=parent_id)

    def export_request(self, req_id) -> dict:
        """Detach a running, fully-prefilled request for migration to
        another engine: ``{prompt_ids, output_ids, params, key, kv}`` with
        the row's PRNG key (numpy uint32 [2]) and its bit-exact KV
        snapshot in the JAX package's layout (`snapshot_to_handoff`; the
        local blocks are freed).  The request finishes here with reason
        "migrated"."""
        req = self._requests[req_id]
        if req.finished or not req.prefill_done or not req.output_ids:
            raise ValueError(
                "export_request needs an unfinished, fully-prefilled "
                "request with at least one emitted token (prefill "
                "samples the first token from its final logits)")
        if req not in self.scheduler.running:
            raise ValueError(
                "export_request needs a RUNNING request (a preempted "
                "one already carries its snapshot in req.swap)")
        handoff = {
            "prompt_ids": list(req.prompt_ids),
            "output_ids": list(req.output_ids),
            "params": req.params,
            "key": req.key.numpy().astype(np.uint32),
            "kv": snapshot_to_handoff(self.cache.swap_out(req_id)),
        }
        self.scheduler.running.remove(req)
        self._finish_request(req, "migrated")
        req.state = Request.FINISHED
        del self._requests[req_id]
        return handoff

    def adopt_request(self, prompt_ids, sampling_params, output_ids,
                      key, kv) -> int:
        """Admit a mid-flight request exported by `export_request` (of
        this package or the JAX one): the KV snapshot is restored by the
        scheduler's swap-resume path and decode continues from the
        shipped key, with no prefill here."""
        params = sampling_params or SamplingParams()
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        out = [int(t) for t in output_ids]
        if not prompt or not out:
            raise ValueError("adopt_request needs a prompt and at least "
                             "one emitted token")
        if len(out) >= params.max_new_tokens:
            raise ValueError("request already finished — ship a result, "
                             "not a handoff")
        self._check_len(len(prompt), params)
        req = self._new_request(
            prompt, params,
            torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)))
        req.output_ids = out
        # the exporter's cache covered positions [0, total_len - 1): the
        # last emitted token is fed by the next decode step
        req.num_computed = req.total_len - 1
        req.swap = snapshot_from_handoff(kv)
        return self._enqueue(req, adopted=True)

    # -- telemetry ----------------------------------------------------------

    def _begin_trace(self, req, **attrs) -> None:
        """Stamp arrival (TTFT's zero point) and, with tracing on, open
        the request's root span and its queue-wait child."""
        req.arrival_t = time.perf_counter()
        req.arrival_ts = time.time()   # wall clock for the reqlog event
        if mtrace.enabled():
            root = mtrace.start_span(
                "serving/request", rid=req.req_id,
                prompt_len=req.prompt_len,
                max_new_tokens=req.params.max_new_tokens, **attrs)
            req.trace = root
            req.queue_span = mtrace.start_span("serving/queue_wait",
                                               parent=root)
            self._trace_ids[req.req_id] = root.trace_id
            while len(self._trace_ids) > mtrace._MAX_TRACES:
                self._trace_ids.popitem(last=False)

    def _end_trace(self, req, finish: str, keep: bool = False) -> None:
        """Close the request's open spans (idempotent).  ``keep=True``
        marks the root for tail sampling's always-keep path."""
        if req.queue_span is not None:
            req.queue_span.end(finish=finish)
            req.queue_span = None
        if req.trace is not None:
            extra = {"keep": True} if keep else {}
            req.trace.end(finish=finish, tokens=len(req.output_ids),
                          **extra)
            req.trace = None

    def _finish_request(self, req, reason: str) -> None:
        """The one request-finish choke point (idempotent): stamp the
        reason, close spans (SLO violators kept for tail sampling), count
        the outcome, and emit the wide reqlog event.  Reasons: "stop",
        "deadline", "abort" (released mid-flight), "released" (released
        while still queued), "migrated" (exported to another engine),
        "shed" (best-effort work dropped by SLO-aware admission)."""
        if req.finish_reason is not None:
            return
        req.finish_reason = reason
        gen = len(req.output_ids)
        ttft = tpot_avg = None
        if req.first_token_t is not None and req.arrival_t is not None:
            ttft = req.first_token_t - req.arrival_t
        if gen >= 2 and req.first_token_t is not None \
                and req.last_token_t is not None:
            tpot_avg = (req.last_token_t - req.first_token_t) / (gen - 1)
        keep = mslo.enabled() and mslo.violates(
            ttft_s=ttft, tpot_avg_s=tpot_avg,
            queue_wait_s=req.queue_wait_s)
        self._end_trace(req, reason, keep=keep)
        tenant = req.params.tenant
        if monitor.enabled():
            self._m_finish.labels(reason=reason).inc()
            if tenant and gen:
                self._m_tenant_tokens.labels(tenant=tenant).inc(gen)
        if mreqlog.enabled():
            mreqlog.emit(mreqlog.event(
                req.req_id,
                trace_id=self._trace_ids.get(req.req_id),
                arrival_ts=req.arrival_ts,
                prompt_tokens=req.prompt_len,
                generated_tokens=gen,
                queue_wait_s=req.queue_wait_s,
                ttft_s=ttft,
                tpot_avg_s=tpot_avg,
                tpot_max_s=req.tpot_max,
                prefill_chunks=req.prefill_chunks,
                prefix_hit_tokens=req.prefix_hit_tokens,
                spec_proposed=req.spec_proposed,
                spec_accepted=req.spec_accepted,
                preemptions=req.num_preemptions,
                peak_kv_blocks=req.peak_kv_blocks,
                finish_reason=reason,
                tenant=tenant,
                priority=req.params.priority))

    def request_trace(self, req_id) -> list:
        """The request's finished spans (start-ordered dicts), valid after
        the request is released; [] when it was never traced (PTPU_TRACE
        off at add time) or its trace aged out of the bounded store."""
        tid = self._trace_ids.get(req_id)
        return [] if tid is None else mtrace.get_trace(tid)

    def _record_latency(self, req, now) -> None:
        """Per-token TTFT / TPOT at host time ``now`` (tokens emitted in
        one step share it); each observation carries the request's
        trace_id as an exemplar, and a tenant's request also observes
        into its tenant's series."""
        tid = req.trace.trace_id if req.trace is not None else None
        tenant = req.params.tenant
        if req.first_token_t is None:
            req.first_token_t = now
            if req.arrival_t is not None:
                ttft = now - req.arrival_t
                self._m_ttft.observe(ttft, trace_id=tid)
                if tenant:
                    self._m_ttft.labels(tenant=tenant).observe(ttft)
        else:
            gap = now - req.last_token_t
            self._m_tpot.observe(gap, trace_id=tid)
            if tenant:
                self._m_tpot.labels(tenant=tenant).observe(gap)
            if req.tpot_max is None or gap > req.tpot_max:
                req.tpot_max = gap
        req.last_token_t = now

    @staticmethod
    def _init_key(params: SamplingParams):
        """The row's key, an int64 host tensor [2] (`engine.py:620-628`):
        a sampling row's ``PRNGKey(seed)``, or ``next_key()`` without a
        seed; a greedy row's ``PRNGKey(0)``, never advanced."""
        if params.do_sample:
            key = (_random.PRNGKey(params.seed) if params.seed is not None
                   else _random.next_key())
        else:
            key = _random.PRNGKey(0)
        return key.cpu()

    def request_output(self, req_id) -> np.ndarray:
        """[prompt + generated] int32 ids."""
        req = self._requests[req_id]
        return np.asarray(req.prompt_ids + req.output_ids, np.int32)

    def release_request(self, req_id, reason=None) -> None:
        """Drop a request's host state, aborting it if unfinished (its
        blocks are released: decref, so shared blocks survive for their
        other holders).  Callers of the add_request/step API release
        requests after reading their output; `generate()` releases its
        own.  ``reason`` overrides the finish attribution (the deadline
        sweep passes "deadline"); otherwise "released" while still
        queued, "abort" mid-flight."""
        req = self._requests.pop(req_id, None)
        if req is None:
            return
        if req.finished:
            self._finish_request(req, "stop")
            return
        if reason is None:
            reason = ("released" if req.state == Request.WAITING
                      else "abort")
        self._finish_request(req, reason)
        sched = self.scheduler
        if req in sched.running:
            sched.running.remove(req)
            self.cache.free(req_id)
        elif req in sched.waiting:
            sched.waiting.remove(req)
            if req.req_id in self.cache._tables:   # a forked child
                self.cache.free(req_id)
        req.swap = None
        req.state = Request.FINISHED

    def has_unfinished(self) -> bool:
        return self.scheduler.has_work()

    # -- the loop -----------------------------------------------------------

    def generate(self, prompts, sampling_params=None):
        """Run `prompts` (list of id sequences) to completion; returns a
        list of [prompt + generated] int32 arrays in submission order, and
        None in the place of a request its deadline aborted."""
        if sampling_params is None or isinstance(sampling_params,
                                                 SamplingParams):
            params = [sampling_params] * len(prompts)
        else:
            params = list(sampling_params)
            if len(params) != len(prompts):
                raise ValueError("one SamplingParams per prompt (or one "
                                 "shared instance)")
        ids = [self.add_request(p, sp) for p, sp in zip(prompts, params)]
        try:
            while self.scheduler.has_work():
                self.step()
            return [self.request_output(i) if i in self._requests else None
                    for i in ids]
        finally:
            # also on error: abandoned requests would leak their KV blocks
            for i in ids:
                self.release_request(i)

    def _expire_deadlines(self) -> list:
        """Release every unfinished request whose deadline has passed.
        Returns the expired ids."""
        expired = [r.req_id for r in self._requests.values()
                   if r.deadline is not None and not r.finished
                   and r.deadline.expired]
        for rid in expired:
            self.release_request(rid, reason="deadline")
            self._m_expired.inc()
        self.num_expired += len(expired)
        return expired

    def _shed_best_effort(self) -> list:
        """SLO-aware load shedding: while the live fast-window burn rate
        breaches ``PTPU_SHED_BURN``, release every still-waiting
        best-effort request with reason "shed".  Interactive and batch
        requests are never shed (they defer).  Returns the shed ids."""
        floor = priority_rank("best-effort")
        cand = [r for r in self._requests.values()
                if r.state == Request.WAITING and not r.finished
                and priority_rank(r.params.priority) >= floor]
        if not cand or not mslo.enabled():
            return []
        burn = worst_fast_burn()
        shed = [r for r in cand if should_shed(r.params.priority, burn=burn)]
        for r in shed:
            self.release_request(r.req_id, reason="shed")
            if monitor.enabled() and r.params.tenant:
                self._m_tenant_shed.labels(tenant=r.params.tenant).inc()
        return [r.req_id for r in shed]

    @torch.no_grad()
    def step(self) -> list:
        """One scheduler decision and one step body.  Returns the requests
        that FINISHED this step."""
        t0 = time.perf_counter()
        self._expire_deadlines()
        self._shed_best_effort()
        out = self.scheduler.schedule()
        if out.preempted:
            self.num_preemptions += len(out.preempted)
            self._m_preempt.inc(len(out.preempted))
            for r in out.preempted:
                r.num_preemptions += 1
        if out.kind == "prefill":
            self._step_prefill(out)
            phase, toks = "prefill", out.chunk_len
        elif out.kind == "decode":
            # a speculative step can emit more tokens than rows
            toks = self._step_decode(out)
            phase = "decode"
        else:
            phase, toks = "idle", 0
        if mreqlog.enabled():
            # peak KV blocks a request: walked only while the wide events
            # are collected
            for r in self.scheduler.running:
                blocks = len(self.cache._tables.get(r.req_id, ()))
                if blocks > r.peak_kv_blocks:
                    r.peak_kv_blocks = blocks
        done = list(self.scheduler.retire_finished())
        for req in done:
            self._m_done.inc()
            self._finish_request(req, "stop")
        mslo.maybe_tick()   # one module-global read with PTPU_SLO unset
        dt = time.perf_counter() - t0
        mtrace.heartbeat()   # the watchdog's signal, tracing on or off
        if monitor.enabled():
            self._step_metrics(phase, toks, dt)
        return done

    def _step_metrics(self, phase, toks, dt) -> None:
        """Per-phase step time and tokens, goodput (generated tokens over
        all step wall time) and the queue and pool gauges."""
        self._m_step.labels(phase=phase).observe(dt)
        self._wall_s_total += dt
        if phase == "prefill":
            self._m_pre_toks.inc(toks)
            self._m_pre_tps.set(toks / max(dt, 1e-9))
        elif phase == "decode":
            self._m_dec_toks.inc(toks)
            self._m_dec_tps.set(toks / max(dt, 1e-9))
            self._goodput_toks += toks
        self._m_goodput.set(self._goodput_toks
                            / max(self._wall_s_total, 1e-9))
        sched = self.scheduler
        # queue_depth: never-started requests; waiting: all not running,
        # preempted included
        self._m_queue.set(sum(1 for r in sched.waiting
                              if r.state == Request.WAITING))
        self._m_running.set(len(sched.running))
        self._m_waiting.set(len(sched.waiting))
        c = self.cache.counts()
        self._m_blocks.set(c["in_use"])
        self._m_util.set(c["in_use"] / max(c["total"], 1))
        self._m_kv_free.set(c["free"])
        self._m_kv_parked.set(c["parked"])

    # -- step bodies --------------------------------------------------------

    def _int_tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _step_prefill(self, out):
        req = out.prefill_request
        start, chunk = out.chunk_start, out.chunk_len
        req.prefill_chunks += 1
        if req.queue_wait_s is None and req.arrival_t is not None:
            # first compute: the queue wait is over
            req.queue_wait_s = time.perf_counter() - req.arrival_t
            self._m_queue_wait.observe(
                req.queue_wait_s,
                trace_id=req.trace.trace_id if req.trace is not None
                else None)
        if req.queue_span is not None:
            req.queue_span.end()
            req.queue_span = None
        sp = None
        if req.trace is not None:
            sp = mtrace.start_span("serving/prefill", parent=req.trace,
                                   chunk_start=start, chunk_len=chunk)
        try:
            self._prefill_body(req, start, chunk)
        finally:
            if sp is not None:
                sp.end()

    def _step_decode(self, out) -> int:
        rows = list(out.decode_requests)
        spans = [mtrace.start_span("serving/decode_step", parent=r.trace,
                                   pos=r.total_len - 1, batch=len(rows))
                 for r in rows if r.trace is not None]
        try:
            return self._decode_body(rows)
        finally:
            for sp in spans:
                sp.end()

    def _prefill_body(self, req, start, chunk):
        ids = self._int_tensor([req.prompt_ids[start:start + chunk]])
        slots = self._int_tensor(
            [[self.cache.slot(req.req_id, p)
              for p in range(start, start + chunk)]])
        if start == 0 and chunk == req.prompt_len:
            logits = self._prefill_logits(ids, slots)
            self.step_counts["prefill"] += 1
        else:
            tables = self._int_tensor(
                [self.cache.padded_table(req.req_id, self.blocks_per_seq)])
            pos0 = self._int_tensor([start])
            if self.attention_impl == "ragged":
                logits = self._ragged_logits(
                    ids, pos0, self._int_tensor([start + chunk]), tables,
                    slots)
            else:
                logits = self._chunk_logits(ids, pos0, tables, slots)
            self.step_counts["chunk"] += 1
        req.num_computed = start + chunk
        if req.prefix_keys:
            # index the full prompt blocks this chunk filled
            self.cache.register_prefix(req.req_id, req.prefix_keys,
                                       req.num_computed)
        if req.prefill_done:
            if req.params.max_new_tokens <= 0:
                req.state = Request.FINISHED
            else:
                self._sample_rows([req], logits)

    def _decode_body(self, rows) -> int:
        if self.spec_tokens:
            drafts = [self._propose(r) for r in rows]
            if any(drafts):
                return self._decode_body_spec(rows, drafts)
            # no drafts anywhere this step: the plain step is cheaper
            n = self._decode_body_plain(rows)
            for req in rows:
                # release the scheduler's draft reservation
                self.cache.truncate_to(req.req_id, req.total_len)
            return n
        return self._decode_body_plain(rows)

    def _static_step(self, cls, key):
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = cls(self, *key[1:])
        return step

    def _fill_rows(self, step, rows, drafts=None):
        """Write the rows' step inputs into ``step``'s staging buffer and
        copy it to the device.  The staging buffer was last copied from
        before the previous step's sampler synced with the host."""
        self._encode_rows(rows, *step.views(step.host), drafts)
        step.inputs.copy_(step.staging, non_blocking=True)

    def _encode_rows(self, rows, toks, pos0, lens, slots, tables,
                     drafts=None):
        """The rows' step inputs, written into the given arrays (as many
        rows as the step has): each row's last token and drafts, its first
        position, its length with the drafts, its slots and its padded
        table; padding rows token 0, length 0, dropped slots and table
        entries num_blocks."""
        toks[:] = 0
        pos0[:] = 0
        lens[:] = 0
        slots[:] = self.cache.num_slots
        tables[:] = self.cache.num_blocks
        for i, req in enumerate(rows):
            d = drafts[i] if drafts else []
            m = len(d)
            toks[i, 0] = req.output_ids[-1] if req.output_ids \
                else req.prompt_ids[-1]
            toks[i, 1:1 + m] = d
            p = req.total_len - 1
            pos0[i] = p
            lens[i] = req.total_len + m
            tables[i] = self.cache.padded_table(req.req_id,
                                                self.blocks_per_seq)
            # draft positions past m keep the dropped-slot sentinel: no
            # write, outputs never read
            for j in range(1 + m):
                slots[i, j] = self.cache.slot(req.req_id, p + j)

    def _decode_body_plain(self, rows) -> int:
        if self.attention_impl == "bucketed":
            return self._decode_body_bucketed(rows)
        bb = self.scheduler.max_num_seqs
        step = self._static_step(_DecodeStep, ("ragged", bb, 1))
        self._fill_rows(step, rows)
        self._m_attn_impl.labels(kind=self.attention_impl).inc()
        logits = step.run()
        self.step_counts["decode"] += 1
        self._sample_rows(rows, logits)
        self._decode_metrics(bb, len(rows), len(rows))
        return len(rows)

    def _decode_metrics(self, bb, n, real_q, cw=1) -> None:
        """The decode step's padding (rows and query tokens of the
        fixed-shape step that were padding) and its dispatches: the
        step and the sampler, as the JAX engine's two programs."""
        if not monitor.enabled():
            return
        self._m_pad_rows.set((bb - n) / max(bb, 1))
        self._m_pad_toks.set((bb * cw - real_q) / max(bb * cw, 1))
        self._m_kernels.set(2)

    def _decode_body_bucketed(self, rows) -> int:
        n = len(rows)
        bb = self._bucket_batch(n)
        toks, slots = np.empty((2, bb, 1), np.int32)
        pos0, lens = np.empty((2, bb), np.int32)
        tables = np.empty((bb, self.blocks_per_seq), np.int32)
        self._encode_rows(rows, toks, pos0, lens, slots, tables)
        self._m_attn_impl.labels(kind=self.attention_impl).inc()
        logits = self._chunk_logits(
            self._int_tensor(toks), self._int_tensor(pos0),
            self._int_tensor(tables), self._int_tensor(slots))
        self.step_counts["decode"] += 1
        self._sample_rows(rows, logits)
        self._decode_metrics(bb, n, n)
        return n

    def _bucket_batch(self, n: int) -> int:
        """Power-of-2 decode bucket of the bucketed fallback."""
        bb = 1
        while bb < n:
            bb *= 2
        return min(max(bb, 1), self.scheduler.max_num_seqs)

    # -- speculative decoding -----------------------------------------------

    def _propose(self, req) -> list:
        """Draft tokens for one row.  Sampling rows get none: their key
        must advance exactly one draw per emitted token.  The budget keeps
        the emitted tokens within max_new_tokens and every draft write
        below max_model_len."""
        p = req.params
        if p.do_sample:
            return []
        budget = min(self.spec_tokens,
                     p.max_new_tokens - len(req.output_ids) - 1,
                     self.max_model_len - req.total_len)
        if budget <= 0:
            return []
        c = self.config
        return propose_ngram(req.prompt_ids + req.output_ids, budget,
                             ngram_max=c.spec_ngram_max,
                             ngram_min=c.spec_ngram_min,
                             window=c.spec_lookup_window)

    def _decode_body_spec(self, rows, drafts) -> int:
        """One verify step over the rows' last tokens and drafts, then
        acceptance, then every table rolled back to its accepted length
        (before `retire_finished` frees finished rows' blocks)."""
        bb, cw = self.scheduler.max_num_seqs, self.spec_tokens + 1
        step = self._static_step(_VerifyStep, ("verify", bb, cw))
        self._fill_rows(step, rows, drafts)
        self._m_attn_impl.labels(kind=self.attention_impl).inc()
        logits0, greedy = step.run()
        self.step_counts["decode"] += 1
        self.verify_steps += 1
        emitted = self._emit_spec(rows, drafts, logits0,
                                  greedy[:len(rows)].tolist())
        for req in rows:
            self.cache.truncate_to(req.req_id, req.total_len)
        self._decode_metrics(bb, len(rows),
                             len(rows) + sum(len(d) for d in drafts), cw)
        return emitted

    def _emit_spec(self, rows, drafts, logits0, greedy) -> int:
        """Acceptance and emission: the position-0 logits go through the
        same sampler as a plain step (keys and sampling rows' streams as
        with spec off); a greedy row then extends with its drafts while
        draft j equals the greedy token at position j - 1, emitting
        position j's greedy token each time (the correction token ends
        the run)."""
        toks = self._sample_tokens(rows, logits0)
        now = time.perf_counter()   # the tokens are on the host
        emitted = proposed = accepted = 0
        for i, req in enumerate(rows):
            out = [toks[i]]
            m = len(drafts[i])
            proposed += m
            if not req.params.do_sample:
                g = greedy[i]
                for j in range(1, m + 1):
                    if int(drafts[i][j - 1]) != int(g[j - 1]):
                        break
                    out.append(int(g[j]))
            row = 0
            for tok in out:
                req.record_token(tok)
                row += 1
                self._record_latency(req, now)
                if req.finished:
                    break          # eos inside the accepted run
            emitted += row
            accepted += row - 1
            req.spec_proposed += m
            req.spec_accepted += row - 1
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted
        if monitor.enabled():
            if proposed:
                self._m_spec_prop.inc(proposed)
            if accepted:
                self._m_spec_acc.inc(accepted)
            if self._spec_proposed_total:
                self._m_spec_rate.set(self._spec_accepted_total
                                      / self._spec_proposed_total)
        return emitted

    # -- device programs ----------------------------------------------------

    def _embed(self, ids, pos):
        p = self.params
        return p["wte"][ids.long()] + p["wpe"][pos.long()]

    def _run_blocks(self, h, attn_for_layer):
        cfg = self.cfg
        for l in range(cfg.num_hidden_layers):
            p = {n: self.params[n][l] for n in BLOCK_PARAMS}
            h, _ = _stacked_block_body(p, h, attn_for_layer(l),
                                       self.num_heads, self.head_dim,
                                       cfg.layer_norm_epsilon)
        return h

    def _logits(self, h):
        """fp32 logits of every position of h: final LN + tied LM head
        (the JAX ``_model_logits``)."""
        p = self.params
        hn = layer_norm_arrays(h, p["lnf_w"], p["lnf_b"],
                               epsilon=self.cfg.layer_norm_epsilon)
        return (hn @ p["wte"].T).float()

    def _tail(self, h):
        """Last position's fp32 logits [B, V]."""
        return self._logits(h[:, -1])

    def _prefill_logits(self, ids, slots):
        """Whole-prompt prefill of one request: [1, P] ids -> [1, V]."""
        pos = torch.arange(ids.shape[1], device=self.device)

        def attn_for_layer(l):
            def attn(q, k, v):
                # flash reads the fp K/V just computed: only the STORED
                # cache is quantized
                self._write(l, k, v, slots)
                return flash_attention_arrays(q, k, v, is_causal=True), None
            return attn

        return self._tail(self._run_blocks(self._embed(ids, pos[None]),
                                           attn_for_layer))

    def _write(self, l, k, v, slots):
        """The paged K/V write of layer l (quantizing for int8 pools)."""
        cache = self.cache
        if self.kv_quant:
            quantized_cache_update_arrays(
                cache.k_blocks[l], cache.k_scales[l], k, slots)
            quantized_cache_update_arrays(
                cache.v_blocks[l], cache.v_scales[l], v, slots)
        else:
            paged_cache_update_arrays(cache.k_blocks[l], k, slots)
            paged_cache_update_arrays(cache.v_blocks[l], v, slots)

    def _ragged_hidden(self, ids, pos0, lens, tables, slots):
        """The ragged body: [B, C] ids at per-row positions pos0 -> the
        last hidden states [B, C, H]."""
        c = ids.shape[1]
        pos = pos0[:, None].long() + torch.arange(c, device=self.device)
        cache = self.cache

        def attn_for_layer(l):
            scales = ((cache.k_scales[l], cache.v_scales[l])
                      if self.kv_quant else (None, None))

            def attn(q, k, v):
                out = ragged_paged_attention_arrays(
                    q, k, v, cache.k_blocks[l], cache.v_blocks[l], tables,
                    pos0, lens, slots, *scales)
                return out[0], None
            return attn

        return self._run_blocks(self._embed(ids, pos), attn_for_layer)

    def _ragged_logits(self, ids, pos0, lens, tables, slots):
        """Ragged step: [B, C] ids -> the last position's [B, V]."""
        return self._tail(self._ragged_hidden(ids, pos0, lens, tables,
                                              slots))

    def _verify_logits(self, ids, pos0, lens, tables, slots):
        """Verify step: the ragged body at [B, k+1], then the position-0
        fp32 logits [B, V] and every position's greedy argmax [B, k+1]."""
        logits = self._logits(self._ragged_hidden(ids, pos0, lens, tables,
                                                  slots))
        return logits[:, 0], torch.argmax(logits, dim=-1)

    def _chunk_logits(self, ids, pos0, tables, slots):
        """The bucketed fallback's chunk program (`engine.py:1665-1702`):
        per layer the paged write, then `paged_attention_arrays` over the
        gathered pools (dequantized with the scales for int8 pools),
        write-then-attend.  [B, C] ids -> the last position's [B, V]."""
        c = ids.shape[1]
        pos = pos0[:, None].long() + torch.arange(c, device=self.device)
        cache = self.cache

        def attn_for_layer(l):
            def attn(q, k, v):
                self._write(l, k, v, slots)
                scales = ({"k_scales": cache.k_scales[l],
                           "v_scales": cache.v_scales[l]}
                          if self.kv_quant else {})
                return paged_attention_arrays(
                    q, cache.k_blocks[l], cache.v_blocks[l], tables, pos0,
                    **scales), None
            return attn

        return self._tail(self._run_blocks(self._embed(ids, pos),
                                           attn_for_layer))

    # -- the sampler --------------------------------------------------------

    def _sample_tokens(self, rows, logits) -> list:
        """One token per live row from [B, V] fp32 logits (B may exceed
        len(rows) by padding), as the JAX engine's per-row sampler
        (`engine.py:1779-1812`): greedy rows the argmax; sampling rows
        split their key (new, sub), filter their logits and draw one
        categorical from sub, over all sampling rows at once, and keep
        new.  The keys are split on the host."""
        toks = torch.argmax(logits[:len(rows)], dim=-1)
        samp = [i for i, r in enumerate(rows) if r.params.do_sample]
        if samp:
            pairs = _random.split(torch.stack([rows[i].key for i in samp]))
            dev = logits.device
            idx = torch.tensor(samp, device=dev)
            sp = [rows[i].params for i in samp]
            ll = _filter_logits(
                logits.index_select(0, idx),
                torch.tensor([p.temperature for p in sp],
                             dtype=torch.float32, device=dev),
                torch.tensor([p.top_k for p in sp], device=dev),
                torch.tensor([p.top_p for p in sp], dtype=torch.float32,
                             device=dev))
            drawn = _random.categorical(pairs[:, 1].to(dev), ll)
            toks = toks.index_copy(0, idx, drawn)
            for j, i in enumerate(samp):
                rows[i].key = pairs[j, 0]
        return toks.tolist()

    def _sample_rows(self, rows, logits):
        toks = self._sample_tokens(rows, logits)
        now = time.perf_counter()   # the tokens are on the host
        for req, tok in zip(rows, toks):
            req.record_token(tok)
            self._record_latency(req, now)


class _DecodeStep:
    """The engine's ``(bb, cw)`` ragged step over buffers that outlive it:
    ``inputs``, one int32 device buffer ``toks | pos0 | lens | slots |
    tables`` (``bb * cw``, ``bb``, ``bb``, ``bb * cw``, then ``bb`` rows of
    the table width), its staging copy ``staging`` (pinned on the card;
    ``host`` is its numpy view), the pools and scales of the engine's
    `BlockKVCache` and the weights.  ``run()`` returns the step's outputs
    (here the fp32 logits [bb, V]); it is a `StepGraph` of kind ``KIND``
    counted in the engine's ``compiles``."""

    KIND = "ragged"

    def __init__(self, engine, bb, cw):
        self.bb, self.cw = bb, cw
        self.maxb = maxb = engine.blocks_per_seq
        n = 2 * bb * cw + 2 * bb + bb * maxb
        dev = engine.device
        self.staging = torch.zeros(n, dtype=torch.int32,
                                   pin_memory=dev.type == "cuda")
        self.host = self.staging.numpy()
        self.inputs = torch.zeros(n, dtype=torch.int32, device=dev)
        toks, pos0, lens, slots, tables = self.views(self.inputs)
        body = self.body(engine)
        self.run = StepGraph(lambda: body(toks, pos0, lens, tables, slots),
                             dev, self.KIND, engine.compiles,
                             on_capture=engine._count_capture)

    def views(self, buf):
        """(toks [bb, cw], pos0 [bb], lens [bb], slots [bb, cw], tables
        [bb, maxb]) over ``buf``."""
        bb, cw = self.bb, self.cw
        o = [int(x) for x in np.cumsum([0, bb * cw, bb, bb, bb * cw])]
        return (buf[o[0]:o[1]].reshape(bb, cw), buf[o[1]:o[2]],
                buf[o[2]:o[3]], buf[o[3]:o[4]].reshape(bb, cw),
                buf[o[4]:].reshape(bb, self.maxb))

    def body(self, engine):
        return engine._ragged_logits


class _VerifyStep(_DecodeStep):
    """The speculative verify step ``(bb, k+1)``: `_DecodeStep`'s buffers,
    run by ``_verify_logits`` (position-0 logits, every position's greedy
    argmax); a `StepGraph` of kind "verify"."""

    KIND = "verify"

    def body(self, engine):
        return engine._verify_logits


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the JAX package's dtype label."""
    return str(dtype).replace("torch.", "")
