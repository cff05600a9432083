"""`LLMEngine` — continuous batching over a paged KV cache, the port of
`paddle_tpu/serving/engine.py`.

The scheduler (waiting queue, token-budget admission, preemption) lives on
the host; each step runs one of three bodies on the device:

- **prefill** — one request's whole prompt at its exact length: causal
  flash attention within the prompt (`ops.flash_attention`, on the fp K/V
  just computed) plus the paged K/V writes (quantizing ones for int8
  pools).
- **ragged** — the ``(max_num_seqs, 1)`` decode step, padded to
  ``max_num_seqs`` rows whatever the batch holds, and the ``(1, C)``
  chunked-prefill continuation.  Per layer ONE
  `ops.ragged_paged_attention` call writes the new tokens' K/V into their
  slots and attends the ragged batch against the pools: the int8 kernel
  for ``kv_cache_dtype="int8"``, whose plain version on the CPU is the JAX
  fallback's (quantized write, scale-folded attention), as the JAX
  engine's ragged program computes both step kinds.
- **sample** — greedy argmax, or temperature / top-k / top-p with a
  per-request `torch.Generator`.

The final LayerNorm and tied LM head follow the JAX ``_model_logits``
(`nn.functional.layer_norm_arrays`, not the block LN).  Padding rows carry
``kv_lens = 0``, table entries ``num_blocks`` and slots ``num_slots``: their
writes are dropped and their outputs ignored.

Left out for later slices: the bucketed fallback path, speculative
verify, prefix caching, deadlines and shedding,
fork/export/adopt, the monitor and tracing, CUDA-graph capture, and
seeded sampling that reproduces the JAX package's PRNG streams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.gpt import BLOCK_PARAMS, _sample_next, _stacked_block_body
from ..nn.functional import layer_norm_arrays
from ..ops.flash_attention import flash_attention_arrays
from ..ops.paged_attention import (paged_cache_update_arrays,
                                   quantized_cache_update_arrays)
from ..ops.ragged_paged_attention import ragged_paged_attention_arrays
from .kv_cache import BlockKVCache
from .scheduler import Request, SamplingParams, Scheduler

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
    # port-only fields, keyword-only so that a positional call means what
    # it means in JAX (whose next field, metrics_port, is not ported)
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
                                    or self.max_model_len))
        self._requests: dict = {}
        self._next_id = 0
        # step bodies run so far, by kind ("chunk" = ragged (1, C)
        # continuation, "decode" = ragged (max_num_seqs, 1))
        self.step_counts = {"prefill": 0, "chunk": 0, "decode": 0}
        self.num_preemptions = 0

    # -- request API --------------------------------------------------------

    def add_request(self, prompt_ids, sampling_params=None) -> int:
        params = sampling_params or SamplingParams()
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        total = len(prompt) + params.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({params.max_new_tokens}) exceeds max_model_len "
                f"({self.max_model_len})")
        req = Request(self._next_id, prompt, params)
        self._next_id += 1
        if params.do_sample:
            g = torch.Generator(device=self.device)
            if params.seed is not None:
                g.manual_seed(params.seed)
            else:
                g.seed()
            req.generator = g
        self._requests[req.req_id] = req
        self.scheduler.add(req)
        return req.req_id

    def request_output(self, req_id) -> np.ndarray:
        """[prompt + generated] int32 ids."""
        req = self._requests[req_id]
        return np.asarray(req.prompt_ids + req.output_ids, np.int32)

    def release_request(self, req_id) -> None:
        """Drop a request's host state, aborting it if unfinished.  Callers
        of the add_request/step API release requests after reading their
        output; `generate()` releases its own."""
        req = self._requests.pop(req_id, None)
        if req is None or req.finished:
            return
        sched = self.scheduler
        if req in sched.running:
            sched.running.remove(req)
            self.cache.free(req_id)
        elif req in sched.waiting:
            sched.waiting.remove(req)
        req.swap = None
        req.state = Request.FINISHED

    def has_unfinished(self) -> bool:
        return self.scheduler.has_work()

    # -- the loop -----------------------------------------------------------

    def generate(self, prompts, sampling_params=None):
        """Run `prompts` (list of id sequences) to completion; returns a
        list of [prompt + generated] int32 arrays in submission order."""
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
            return [self.request_output(i) for i in ids]
        finally:
            # also on error: abandoned requests would leak their KV blocks
            for i in ids:
                self.release_request(i)

    @torch.no_grad()
    def step(self) -> list:
        """One scheduler decision and one step body.  Returns the requests
        that FINISHED this step."""
        out = self.scheduler.schedule()
        self.num_preemptions += len(out.preempted)
        if out.kind == "prefill":
            self._prefill_body(out.prefill_request, out.chunk_start,
                               out.chunk_len)
        elif out.kind == "decode":
            self._decode_body(list(out.decode_requests))
        return list(self.scheduler.retire_finished())

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
            logits = self._ragged_logits(
                ids, self._int_tensor([start]),
                self._int_tensor([start + chunk]), tables, slots)
            self.step_counts["chunk"] += 1
        req.num_computed = start + chunk
        if req.prefill_done:
            if req.params.max_new_tokens <= 0:
                req.state = Request.FINISHED
            else:
                self._sample_rows([req], logits)

    def _decode_body(self, rows):
        bb = self.scheduler.max_num_seqs
        maxb = self.blocks_per_seq
        # one host buffer, one copy to the device: toks | pos0 | lens |
        # slots | tables
        host = np.zeros(4 * bb + bb * maxb, np.int32)
        toks, pos0, lens, slots = (host[i * bb:(i + 1) * bb]
                                   for i in range(4))
        tables = host[4 * bb:].reshape(bb, maxb)
        slots[:] = self.cache.num_slots
        tables[:] = self.cache.num_blocks
        for i, req in enumerate(rows):
            toks[i] = req.output_ids[-1] if req.output_ids \
                else req.prompt_ids[-1]
            p = req.total_len - 1
            pos0[i] = p
            lens[i] = req.total_len
            tables[i] = self.cache.padded_table(req.req_id, maxb)
            slots[i] = self.cache.slot(req.req_id, p)
        dev = torch.from_numpy(host).to(self.device)
        d_toks, d_pos0, d_lens, d_slots = (dev[i * bb:(i + 1) * bb]
                                           for i in range(4))
        logits = self._ragged_logits(
            d_toks.view(bb, 1), d_pos0, d_lens,
            dev[4 * bb:].view(bb, maxb), d_slots.view(bb, 1))
        self.step_counts["decode"] += 1
        self._sample_rows(rows, logits)

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

    def _tail(self, h):
        """Last position's fp32 logits: final LN + tied LM head."""
        p = self.params
        hn = layer_norm_arrays(h[:, -1], p["lnf_w"], p["lnf_b"],
                               epsilon=self.cfg.layer_norm_epsilon)
        return (hn @ p["wte"].T).float()

    def _prefill_logits(self, ids, slots):
        """Whole-prompt prefill of one request: [1, P] ids -> [1, V]."""
        pos = torch.arange(ids.shape[1], device=self.device)
        cache = self.cache

        def attn_for_layer(l):
            def attn(q, k, v):
                # flash reads the fp K/V just computed: only the STORED
                # cache is quantized
                if self.kv_quant:
                    quantized_cache_update_arrays(
                        cache.k_blocks[l], cache.k_scales[l], k, slots)
                    quantized_cache_update_arrays(
                        cache.v_blocks[l], cache.v_scales[l], v, slots)
                else:
                    paged_cache_update_arrays(cache.k_blocks[l], k, slots)
                    paged_cache_update_arrays(cache.v_blocks[l], v, slots)
                return flash_attention_arrays(q, k, v, is_causal=True), None
            return attn

        return self._tail(self._run_blocks(self._embed(ids, pos[None]),
                                           attn_for_layer))

    def _ragged_logits(self, ids, pos0, lens, tables, slots):
        """Ragged step: [B, C] ids at per-row positions pos0 -> [B, V]."""
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

        return self._tail(self._run_blocks(self._embed(ids, pos),
                                           attn_for_layer))

    def _sample_rows(self, rows, logits):
        """One token per live row from [B, V] fp32 logits (B may exceed
        len(rows) by padding)."""
        toks = torch.argmax(logits[:len(rows)], dim=-1).tolist()
        for i, req in enumerate(rows):
            if req.params.do_sample:
                sp = req.params
                toks[i] = int(_sample_next(
                    logits[i:i + 1], True, sp.temperature, sp.top_k,
                    sp.top_p, req.generator)[0])
            req.record_token(toks[i])

