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

Left out for later slices: SLO-aware shedding (``monitor.slo``), the
monitor and tracing (``metrics_port`` raises), ``decode_breakdown``, and
CUDA-graph capture of the prefill and chunk steps.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..core import random as _random
from ..device import resolve_device
from ..graphs import StepGraph
from ..models.gpt import BLOCK_PARAMS, _filter_logits, _stacked_block_body
from ..nn.functional import layer_norm_arrays
from ..ops.flash_attention import flash_attention_arrays
from ..ops.paged_attention import (paged_attention_arrays,
                                   paged_cache_update_arrays,
                                   quantized_cache_update_arrays)
from ..ops.ragged_paged_attention import ragged_paged_attention_arrays
from ..resilience.retry import Deadline
from .kv_cache import (BlockKVCache, prefix_block_keys, snapshot_from_handoff,
                       snapshot_to_handoff)
from .scheduler import Request, SamplingParams, Scheduler
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
    # the JAX engine's live metrics endpoint: kept for its position; the
    # port has no monitor.serve yet, so setting it raises
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

    def __post_init__(self):
        if self.metrics_port is not None:
            raise NotImplementedError(
                "EngineConfig.metrics_port: the live metrics endpoint "
                "(monitor.serve) is not ported yet (ROADMAP Queue 1 item "
                "8)")


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

    def _enqueue(self, req) -> int:
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
        return self._enqueue(req)

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
        return self._enqueue(req)

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
        req.finish_reason = "migrated"
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
        return self._enqueue(req)

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
            if req.finish_reason is None:
                req.finish_reason = "stop"
            return
        if reason is None:
            reason = ("released" if req.state == Request.WAITING
                      else "abort")
        req.finish_reason = reason
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
        self.num_expired += len(expired)
        return expired

    @torch.no_grad()
    def step(self) -> list:
        """One scheduler decision and one step body.  Returns the requests
        that FINISHED this step."""
        self._expire_deadlines()
        out = self.scheduler.schedule()
        self.num_preemptions += len(out.preempted)
        if out.kind == "prefill":
            self._prefill_body(out.prefill_request, out.chunk_start,
                               out.chunk_len)
        elif out.kind == "decode":
            self._decode_body(list(out.decode_requests))
        done = list(self.scheduler.retire_finished())
        for req in done:
            if req.finish_reason is None:
                req.finish_reason = "stop"
        return done

    # -- step bodies --------------------------------------------------------

    def _int_tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

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
        logits = step.run()
        self.step_counts["decode"] += 1
        self._sample_rows(rows, logits)
        return len(rows)

    def _decode_body_bucketed(self, rows) -> int:
        n = len(rows)
        bb = self._bucket_batch(n)
        toks, slots = np.empty((2, bb, 1), np.int32)
        pos0, lens = np.empty((2, bb), np.int32)
        tables = np.empty((bb, self.blocks_per_seq), np.int32)
        self._encode_rows(rows, toks, pos0, lens, slots, tables)
        logits = self._chunk_logits(
            self._int_tensor(toks), self._int_tensor(pos0),
            self._int_tensor(tables), self._int_tensor(slots))
        self.step_counts["decode"] += 1
        self._sample_rows(rows, logits)
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
        logits0, greedy = step.run()
        self.step_counts["decode"] += 1
        self.verify_steps += 1
        emitted = self._emit_spec(rows, drafts, logits0,
                                  greedy[:len(rows)].tolist())
        for req in rows:
            self.cache.truncate_to(req.req_id, req.total_len)
        return emitted

    def _emit_spec(self, rows, drafts, logits0, greedy) -> int:
        """Acceptance and emission: the position-0 logits go through the
        same sampler as a plain step (keys and sampling rows' streams as
        with spec off); a greedy row then extends with its drafts while
        draft j equals the greedy token at position j - 1, emitting
        position j's greedy token each time (the correction token ends
        the run)."""
        toks = self._sample_tokens(rows, logits0)
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
                if req.finished:
                    break          # eos inside the accepted run
            emitted += row
            accepted += row - 1
            req.spec_proposed += m
            req.spec_accepted += row - 1
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted
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
        for req, tok in zip(rows, self._sample_tokens(rows, logits)):
            req.record_token(tok)


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
                             dev, self.KIND, engine.compiles)

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
