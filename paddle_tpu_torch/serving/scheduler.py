"""Continuous-batching scheduler — the port of
`paddle_tpu/serving/scheduler.py` (host logic, no device math).

Per engine step the scheduler picks ONE of:

- a **prefill** for the best waiting request, chunked to the token budget
  (`max_num_batched_tokens`), admitted only when the KV pool can hold the
  chunk;
- a **decode** over every RUNNING request, after reserving each row's next
  slot — reservation failures trigger **preemption by eviction**: the
  lowest-priority youngest running request is swapped out (host snapshot,
  blocks freed, re-queued at the FRONT of the waiting queue) until the
  rest fit.

Multi-tenant policy: admission candidates are ordered by (priority class,
weighted tenant service, arrival), a deficit-style fair share; with default
params every ordering is plain FIFO/youngest-first.

With prefix caching on, a fresh request first adopts its longest cached
block-aligned prefix (capped below the whole prompt: the last prompt
token is recomputed for its logits), and its chunk budget counts only the
uncached tokens.  With speculative decoding on, the decode branch
reserves each greedy row's draft extent (`_decode_reserve_len`); the
engine rolls the tables back to the accepted length after the step.

SLO-aware admission: `should_shed` drops best-effort work while the
worst fast-window burn rate of ``monitor.slo`` (`worst_fast_burn`)
reaches ``PTPU_SHED_BURN``; the engine sheds queued requests with it and
the HTTP front door (`serving.api`) answers 429 before admission.
"""
from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Optional

__all__ = ["SamplingParams", "Request", "Scheduler", "SchedulerOutput",
           "PRIORITIES", "priority_rank", "tenant_weights", "should_shed",
           "worst_fast_burn"]

# Priority classes, best first.  Unknown strings rank with "best-effort".
PRIORITIES = ("interactive", "batch", "best-effort")
_PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITIES)}

# Shed threshold: best-effort traffic is shed once the worst fast-window
# SLO burn rate reaches this multiple of budget burn
_SHED_DEFAULT_BURN = 2.0


def priority_rank(priority) -> int:
    """Rank of a priority class — lower is better; unknown ranks worst."""
    return _PRIORITY_RANK.get(priority, len(PRIORITIES) - 1)


def tenant_weights(spec: Optional[str] = None) -> dict:
    """Parse a ``name:weight,name:weight`` spec (default: the
    ``PTPU_TENANT_WEIGHTS`` env var).  Unlisted tenants weigh 1.0; zero,
    negative or malformed weights are dropped rather than raising."""
    if spec is None:
        spec = os.environ.get("PTPU_TENANT_WEIGHTS", "")
    out: dict = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, raw = part.partition(":")
        try:
            weight = float(raw) if raw else 1.0
        except ValueError:
            continue
        if name.strip() and weight > 0:
            out[name.strip()] = weight
    return out


def worst_fast_burn(report=None) -> float:
    """Worst fast-window burn rate across all SLO objectives, 0.0 when
    the SLO engine is off (shedding never triggers without live SLOs)."""
    if report is None:
        from ..monitor import slo as mslo
        report = mslo.report()
    if not report or not report.get("enabled"):
        return 0.0
    worst = 0.0
    for obj in report.get("objectives", ()):
        rate = (obj.get("burn_rate") or {}).get("fast")
        if rate is not None:
            worst = max(worst, float(rate))
    return worst


def should_shed(priority, burn: Optional[float] = None) -> bool:
    """SLO-aware admission control: shed `priority`-class work right now?

    Only "best-effort" is ever shed; interactive and batch classes defer
    (stay queued).  The input is the worst fast-window burn rate of the
    live `monitor.slo` engine (``burn`` injects it), against the
    ``PTPU_SHED_BURN`` threshold."""
    if priority_rank(priority) < priority_rank("best-effort"):
        return False
    if burn is None:
        burn = worst_fast_burn()
    try:
        threshold = float(os.environ.get("PTPU_SHED_BURN",
                                         _SHED_DEFAULT_BURN))
    except ValueError:
        threshold = _SHED_DEFAULT_BURN
    return burn >= threshold


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling controls."""

    max_new_tokens: int = 16
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: Optional[int] = None
    # wall-clock budget from admission; an expired request is aborted at
    # the next engine step via release_request() (resilience.Deadline;
    # None = no deadline)
    deadline_s: Optional[float] = None
    # multi-tenant scheduling: the tenant for weighted fair share (None =
    # the shared default pool) and the priority class
    tenant: Optional[str] = None
    priority: str = "interactive"


class Request:
    """One in-flight generation: prompt, sampling state, and progress."""

    WAITING, RUNNING, PREEMPTED, FINISHED = range(4)

    def __init__(self, req_id, prompt_ids, params: SamplingParams):
        self.req_id = req_id
        self.prompt_ids = list(int(t) for t in prompt_ids)
        self.params = params
        self.state = Request.WAITING
        self.output_ids: list = []         # generated tokens (incl. eos)
        self.num_computed = 0              # prompt tokens prefilled so far
        self.key = None                    # per-request PRNG key (engine;
        #                                    int64 host tensor [2])
        self.swap = None                   # host KV snapshot while evicted
        self.prefix_keys = None            # chained block keys (engine;
        #                                    set only with prefix caching)
        self.prefix_hit_tokens = 0         # prompt tokens adopted cached
        self.arrival = None                # admission tiebreak (set by add)
        self.deadline = None               # resilience.Deadline (engine)
        # -- telemetry (engine-owned) --------------------------------------
        self.trace = None                  # root Span, or None (trace off)
        self.queue_span = None             # open queue-wait child Span
        self.arrival_t = None              # perf_counter at add_request
        self.first_token_t = None          # perf_counter of token 1 (TTFT)
        self.last_token_t = None           # perf_counter of latest token
        self.arrival_ts = None             # wall clock at add_request
        self.queue_wait_s = None           # arrival to first compute
        self.tpot_max = None               # worst inter-token gap, seconds
        self.prefill_chunks = 0            # prefill passes this prompt took
        self.num_preemptions = 0           # times evicted mid-flight
        self.peak_kv_blocks = 0            # high-water KV blocks held
        self.spec_proposed = 0             # draft tokens proposed
        self.spec_accepted = 0             # draft tokens accepted
        self.finish_reason = None          # stop|abort|deadline|released|
        #                                    migrated|shed, set once at
        #                                    finish

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_ids)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.output_ids)

    @property
    def prefill_done(self) -> bool:
        return self.num_computed >= self.prompt_len

    @property
    def finished(self) -> bool:
        return self.state == Request.FINISHED

    def record_token(self, tok: int) -> None:
        self.output_ids.append(int(tok))
        p = self.params
        if len(self.output_ids) >= p.max_new_tokens or (
                p.eos_token_id is not None and int(tok) == p.eos_token_id):
            self.state = Request.FINISHED

    def __repr__(self):
        names = {0: "WAITING", 1: "RUNNING", 2: "PREEMPTED", 3: "FINISHED"}
        return (f"Request({self.req_id}, state={names[self.state]}, "
                f"prompt={self.prompt_len}, out={len(self.output_ids)})")


@dataclasses.dataclass
class SchedulerOutput:
    """What the engine must run this step."""

    kind: str                      # "prefill" | "decode" | "idle"
    prefill_request: Optional[Request] = None
    chunk_start: int = 0           # prefill: first prompt position of chunk
    chunk_len: int = 0
    decode_requests: tuple = ()    # decode: rows of the batch
    preempted: tuple = ()          # requests evicted while scheduling


class Scheduler:
    def __init__(self, cache, max_num_seqs=8, max_num_batched_tokens=2048,
                 spec_tokens=0, max_model_len=None, weights=None):
        self.cache = cache
        self.max_num_seqs = int(max_num_seqs)
        self.max_num_batched_tokens = int(max_num_batched_tokens)
        self.tenant_weights = (dict(weights) if weights is not None
                               else tenant_weights())
        self.tenant_served: dict = {}
        # speculative decoding: a decode step may write up to spec_tokens
        # draft positions past each row's last token, so the decode branch
        # reserves blocks for that extent (clamped so no write position
        # reaches max_model_len)
        self.spec_tokens = max(0, int(spec_tokens))
        self.max_model_len = (None if max_model_len is None
                              else int(max_model_len))
        self.waiting: deque = deque()
        self.running: list = []
        self._arrival = 0
        self.num_evictions = 0
        self.num_swap_ins = 0

    def _decode_reserve_len(self, req) -> int:
        """Token coverage the decode step needs for `req`: total_len (the
        write of position total_len - 1) plus the row's real draft budget,
        the engine proposer's clamp: sampling rows and rows within one
        token of max_new_tokens or max_model_len reserve nothing extra."""
        extra = self.spec_tokens
        if extra:
            p = req.params
            if p.do_sample:
                extra = 0
            else:
                extra = min(extra,
                            p.max_new_tokens - len(req.output_ids) - 1)
                if self.max_model_len is not None:
                    extra = min(extra, self.max_model_len - req.total_len)
        return req.total_len + max(0, extra)

    # -- request lifecycle --------------------------------------------------

    def add(self, req: Request) -> None:
        req.arrival = self._arrival
        self._arrival += 1
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- multi-tenant fair share --------------------------------------------

    @staticmethod
    def _tenant_of(req) -> str:
        return req.params.tenant or "default"

    def _charge(self, req, tokens: int) -> None:
        """Charge `tokens` of service against the request's tenant,
        normalized by its configured weight."""
        if tokens <= 0:
            return
        tenant = self._tenant_of(req)
        weight = self.tenant_weights.get(tenant, 1.0)
        self.tenant_served[tenant] = (self._served_of(tenant)
                                      + tokens / weight)

    def _served_of(self, tenant) -> float:
        got = self.tenant_served.get(tenant)
        if got is None:
            # a never-seen tenant starts at the current minimum, not 0
            got = min(self.tenant_served.values(), default=0.0)
        return got

    def _admission_key(self, req):
        return (priority_rank(req.params.priority),
                self._served_of(self._tenant_of(req)),
                req.arrival)

    # -- the policy ---------------------------------------------------------

    def schedule(self) -> SchedulerOutput:
        preempted = []
        # 1) continue a partially-prefilled running request
        part = next((r for r in self.running if not r.prefill_done), None)
        if part is not None:
            if self._ensure_blocks(
                    part, min(part.prompt_len,
                              part.num_computed
                              + self.max_num_batched_tokens),
                    preempted, protect=part):
                return self._emit_prefill(part, preempted)
            return SchedulerOutput(kind="idle", preempted=tuple(preempted))
        # 2) admit / resume the best waiting request (no eviction on
        #    behalf of admission)
        if self.waiting and len(self.running) < self.max_num_seqs:
            order = sorted(self.waiting, key=self._admission_key)
            got = self._admit_or_resume(order[0], preempted)
            if isinstance(got, SchedulerOutput):
                return got
            if got is None and not self.running:
                for req in order[1:]:
                    got = self._admit_or_resume(req, preempted)
                    if isinstance(got, SchedulerOutput):
                        return got
                    if got:
                        break
                else:
                    head = self.waiting[0]
                    if head.swap is not None:
                        raise RuntimeError(
                            "KV cache too small: an evicted request can "
                            "never be restored "
                            f"(free={self.cache.num_free_blocks} blocks, "
                            f"needs {len(head.swap['k'][0])})")
                    raise RuntimeError(
                        "KV cache too small: cannot hold a single request "
                        f"(free={self.cache.num_free_blocks} blocks, "
                        "prompt chunk needs "
                        f"{self.cache.blocks_needed(min(head.prompt_len, self.max_num_batched_tokens))})")
        # 3) decode every running request, reserving one slot per row
        if self.running:
            rows = []
            for req in list(self.running):   # oldest first
                if req.state != Request.RUNNING or not req.prefill_done:
                    continue
                # this step writes position total_len - 1, plus the
                # draft extent with speculative decoding (rolled back to
                # the accepted length by the engine after the step)
                reserve = self._decode_reserve_len(req)
                if not self._ensure_blocks(req, reserve, preempted,
                                           protect=req):
                    continue                 # req itself was evicted
                self.cache.grow_to(req.req_id, reserve)
                rows.append(req)
            # a later row's reservation may have evicted an earlier row
            rows = [r for r in rows if r.state == Request.RUNNING]
            if rows:
                for r in rows:
                    self._charge(r, 1)
                return SchedulerOutput(kind="decode",
                                       decode_requests=tuple(rows),
                                       preempted=tuple(preempted))
        return SchedulerOutput(kind="idle", preempted=tuple(preempted))

    def _admit_or_resume(self, req, preempted):
        """A SchedulerOutput to emit (a prefill step), True when a
        swap-resume landed in `running` with no step to emit, or None when
        `req` cannot start right now."""
        if req.swap is not None:
            if not self._can_swap_in(req):
                return None
            self.waiting.remove(req)
            self.cache.swap_in(req.req_id, req.swap)
            req.swap = None
            req.state = Request.RUNNING
            self.running.append(req)
            self.num_swap_ins += 1
            return True
        start = req.num_computed    # > 0 only for forked children, which
        #                             already hold (shared) prefix blocks
        forked = req.req_id in self.cache._tables
        # prefix caching: adopt the longest cached run, capped below the
        # whole prompt and block-aligned, only when the rest of the chunk
        # fits too (a failed admission holds no blocks)
        hit_blocks = 0
        if (not forked and start == 0 and req.prefix_keys
                and not req.prefix_hit_tokens):
            hit_blocks = self.cache.match_prefix(
                req.prefix_keys,
                max_blocks=(req.prompt_len - 1) // self.cache.block_size)
        # the chunk budget counts only uncached tokens
        hit_tokens = hit_blocks * self.cache.block_size
        chunk = min(req.prompt_len - start - hit_tokens,
                    self.max_num_batched_tokens)
        target = start + hit_tokens + chunk
        if hit_blocks:
            need = self.cache.blocks_needed(target) - hit_blocks
            fits = need <= self.cache.adoptable_free_blocks(
                req.prefix_keys, hit_blocks)
        elif forked:
            fits = self.cache.can_grow_to(req.req_id, target)
        else:
            fits = (self.cache.blocks_needed(target)
                    <= self.cache.num_free_blocks)
        if not fits:
            return None
        self.waiting.remove(req)
        if hit_blocks:
            req.prefix_hit_tokens = self.cache.adopt_prefix(
                req.req_id, req.prefix_keys, hit_blocks)
            req.num_computed = req.prefix_hit_tokens
            start = req.num_computed
            self.cache.grow_to(req.req_id, target)
        elif forked:
            self.cache.grow_to(req.req_id, target)
        else:
            self.cache.allocate(req.req_id, target)
        req.state = Request.RUNNING
        self.running.append(req)
        self._charge(req, chunk)
        return SchedulerOutput(kind="prefill", prefill_request=req,
                               chunk_start=start, chunk_len=chunk,
                               preempted=tuple(preempted))

    def _emit_prefill(self, req, preempted) -> SchedulerOutput:
        start = req.num_computed
        chunk = min(req.prompt_len - start, self.max_num_batched_tokens)
        self.cache.grow_to(req.req_id, start + chunk)
        self._charge(req, chunk)
        return SchedulerOutput(
            kind="prefill", prefill_request=req, chunk_start=start,
            chunk_len=chunk, preempted=tuple(preempted))

    # -- eviction -----------------------------------------------------------

    def _can_swap_in(self, req) -> bool:
        return len(req.swap["k"][0]) <= self.cache.num_free_blocks

    def _ensure_blocks(self, req, target_len, preempted, protect=None) -> bool:
        """Make the pool able to cover `target_len` for `req`, evicting as
        needed.  Returns False if `req` itself had to be evicted."""
        while not self.cache.can_grow_to(req.req_id, target_len):
            victim = self._pick_victim(exclude=protect)
            if victim is None:
                need = self.cache.blocks_needed(target_len) + (
                    1 if self.cache._needs_cow(req.req_id, target_len)
                    else 0)
                if need > self.cache.num_blocks:
                    raise RuntimeError(
                        "KV cache too small: request needs "
                        f"{self.cache.blocks_needed(target_len)} blocks "
                        f"for {target_len} tokens but the pool holds only "
                        f"{self.cache.num_blocks}; raise "
                        "EngineConfig.num_blocks or lower max_new_tokens")
                if protect is not None and protect in self.running:
                    self._evict(protect, preempted)
                    return False
                raise RuntimeError(
                    "KV cache too small: cannot hold a single request "
                    f"(free={self.cache.num_free_blocks} blocks, request "
                    f"needs {self.cache.blocks_needed(target_len)})")
            self._evict(victim, preempted)
        return True

    def _pick_victim(self, exclude=None):
        # lowest priority class first, then youngest arrival
        victims = [r for r in self.running if r is not exclude]
        if not victims:
            return None
        return max(victims, key=lambda r: (
            priority_rank(r.params.priority), r.arrival))

    def _evict(self, req, preempted) -> None:
        req.swap = self.cache.swap_out(req.req_id)
        req.state = Request.PREEMPTED
        self.running.remove(req)
        self.waiting.appendleft(req)             # keeps arrival order
        preempted.append(req)
        self.num_evictions += 1

    # -- completion ---------------------------------------------------------

    def retire_finished(self) -> tuple:
        done = tuple(r for r in self.running if r.finished)
        for req in done:
            self.cache.free(req.req_id)
            self.running.remove(req)
        return done
