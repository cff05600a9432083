"""Automatic prefix caching and speculative decoding of the port's engine,
on the CPU against the JAX package.

- The block allocator: the same seeded random sequence of allocate /
  grow / fork / register / match / adopt / free / swap / truncate /
  privatize on both packages' `BlockKVCache` leaves the same tables,
  refcounts, free list, LRU order and prefix index, and (int8) the same
  codes and scales; chained keys, the n-gram proposer and the draft
  reservation are the JAX package's.
- The engine (the cases of tests/test_prefix_spec.py): a prefix hit and
  prefix plus spec give the JAX engine's tokens (greedy and a seeded
  row, hit tokens as in JAX); spec greedy, seeded and with eos give the
  tokens of the plain engine; the int8 engine's cold, plain and spec
  runs give the JAX int8 engine's tokens, its hit equals its cold run
  and its spec run agrees with its plain run to JAX's 0.9; the static
  steps stay one ``ragged`` and one ``verify`` across rounds (captures,
  on the card); the chunk budget counts only uncached tokens; the
  bucketed fallback gives the ragged path's tokens.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.serving import BlockKVCache as JaxCache
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import prefix_block_keys as jax_keys
from paddle_tpu.serving import propose_ngram as jax_propose

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.serving import (BlockKVCache, EngineConfig,
                                      LLMEngine, Request, SamplingParams,
                                      Scheduler, prefix_block_keys,
                                      propose_ngram)
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


NEW = 6
BS = 4
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)


# ---------------------------------------------------------------------------
# the allocator, host logic against the JAX package
# ---------------------------------------------------------------------------

def _state(c):
    """Everything the allocator decides, as plain Python."""
    return {"tables": {k: list(v) for k, v in c._tables.items()},
            "lengths": dict(c._lengths),
            "refs": [b.ref for b in c._blocks],
            "free": list(c._free),
            "lru": list(c._lru),
            "index": dict(c._prefix_index),
            "counts": c.counts(),
            "hits": (c.prefix_hits, c.prefix_hit_tokens,
                     c.prefix_evictions)}


def _fill(jc, pc, rng):
    """The same random codes (int8) or values in both caches' pools."""
    for l in range(jc.num_layers):
        for pools in (("k_blocks",), ("v_blocks",)):
            name = pools[0]
            shape = getattr(pc, name)[l].shape
            if pc.kv_quant:
                a = rng.integers(-127, 128, shape).astype(np.int8)
            else:
                a = rng.standard_normal(shape).astype(np.float32)
            getattr(jc, name)[l] = jnp.asarray(a)
            getattr(pc, name)[l].copy_(torch.from_numpy(a))
        if pc.kv_quant:
            for i, name in enumerate(("k_scales", "v_scales")):
                s = rng.random((pc.num_blocks, pc.num_heads)).astype(
                    np.float32)
                getattr(jc, name)[l] = jnp.asarray(s)
                pc._scales[i, l].copy_(torch.from_numpy(s))


def _pools_equal(jc, pc):
    for l in range(jc.num_layers):
        assert (np.asarray(jc.k_blocks[l]) == pc.k_blocks[l].numpy()).all()
        assert (np.asarray(jc.v_blocks[l]) == pc.v_blocks[l].numpy()).all()
        if pc.kv_quant:
            assert (np.asarray(jc.k_scales[l])
                    == pc.k_scales[l].numpy()).all()
            assert (np.asarray(jc.v_scales[l])
                    == pc.v_scales[l].numpy()).all()


def _apply(c, op, args, saved):
    """One allocator operation; returns what it returned, or the error's
    type name.  Snapshots of swapped-out sequences live in ``saved``."""
    try:
        if op == "swap_out":
            saved[args[0]] = c.swap_out(*args)
            return None
        if op == "swap_in":
            c.swap_in(args[0], saved[args[0]])
            del saved[args[0]]
            return None
        return getattr(c, op)(*args)
    except RuntimeError as e:   # BlockAllocatorError: both fail alike
        return type(e).__name__


@pytest.mark.parametrize("kv", [None, "int8"])
def test_cache_operation_sequence_matches_jax(kv):
    rng = np.random.default_rng(17)
    jc = JaxCache(2, 14, BS, 2, 4, kv_quant=kv)
    pc = BlockKVCache(2, 14, BS, 2, 4, device="cpu", kv_quant=kv)
    _fill(jc, pc, rng)
    base = [list(rng.integers(0, 5, 24)) for _ in range(3)]
    live, swapped, keys = [], [], {}
    jsaved, psaved = {}, {}
    n_ops = {}
    for step in range(400):
        op = rng.choice(["allocate", "grow_to", "fork", "register_prefix",
                         "adopt", "free", "swap_out", "swap_in",
                         "truncate_to", "privatize_last_block"])
        seq = f"s{step}"
        if op in ("allocate", "adopt"):
            toks = base[rng.integers(3)][:int(rng.integers(4, 24))]
            toks = toks + list(rng.integers(0, 5, int(rng.integers(0, 6))))
            keys[seq] = prefix_block_keys(toks, BS)
            assert keys[seq] == jax_keys(toks, BS)
            if op == "allocate":
                args = (seq, len(toks))
            else:
                hit = jc.match_prefix(keys[seq])
                assert pc.match_prefix(keys[seq]) == hit
                if not hit:
                    continue
                n = int(rng.integers(1, hit + 1))
                assert (pc.adoptable_free_blocks(keys[seq], n)
                        == jc.adoptable_free_blocks(keys[seq], n))
                op, args = "adopt_prefix", (seq, keys[seq], n)
        elif op == "swap_in":
            if not swapped:
                continue
            seq = swapped[int(rng.integers(len(swapped)))]
            args = (seq,)
        else:
            if not live:
                continue
            seq = live[int(rng.integers(len(live)))]
            if op == "grow_to":
                args = (seq, pc._lengths[seq] + int(rng.integers(1, 7)))
            elif op == "truncate_to":
                args = (seq, int(rng.integers(1, pc._lengths[seq] + 1)))
            elif op == "fork":
                child = f"s{step}"
                keys[child] = keys[seq]
                args = (seq, child)
            elif op == "register_prefix":
                args = (seq, keys[seq], pc._lengths[seq])
            else:
                args = (seq,)
        want = _apply(jc, op, args, jsaved)
        got = _apply(pc, op, args, psaved)
        assert got == want, (step, op, got, want)
        if isinstance(got, str):
            continue
        n_ops[op] = n_ops.get(op, 0) + 1
        if op in ("allocate", "adopt_prefix"):
            live.append(seq)
        elif op == "fork":
            live.append(args[1])
        elif op == "free":
            live.remove(seq)
        elif op == "swap_out":
            live.remove(seq)
            swapped.append(seq)
        elif op == "swap_in":
            swapped.remove(seq)
            live.append(seq)
        assert _state(pc) == _state(jc), (step, op)
    _pools_equal(jc, pc)
    # the sequence reached every operation, reclaimed parked blocks and
    # copied shared ones
    assert len(n_ops) == 10, n_ops
    assert pc.prefix_evictions > 0 and pc.prefix_hits > 0


def test_ngram_proposer_is_jaxs():
    rng = np.random.default_rng(3)
    for _ in range(200):
        ctx = list(rng.integers(0, 4, int(rng.integers(0, 40))))
        k, nmax = int(rng.integers(0, 5)), int(rng.integers(1, 4))
        win = int(rng.integers(2, 50))
        assert (propose_ngram(ctx, k, nmax, 1, win)
                == jax_propose(ctx, k, nmax, 1, win))


def test_decode_reserve_clamps_like_jax():
    """tests/test_prefix_spec.py `test_decode_reserve_clamps_like_the_
    proposer`, on both schedulers."""
    cases = [(8, 5, False, [1]), (8, 5, False, [1, 2, 3, 4]),
             (8, 5, True, [1]), (16, 8, False, [1, 2])]
    for n, new, samp, out in cases:
        got = []
        for sched, req, sp, cache in (
                (Scheduler, Request, SamplingParams,
                 BlockKVCache(1, 16, BS, 2, 4, device="cpu")),
                (JaxScheduler, JaxRequest, JaxSamplingParams,
                 JaxCache(1, 16, BS, 2, 4))):
            s = sched(cache, spec_tokens=3, max_model_len=20)
            r = req("r", list(range(n)), sp(max_new_tokens=new,
                                             do_sample=samp))
            r.output_ids = list(out)
            got.append(s._decode_reserve_len(r))
        assert got[0] == got[1]
    assert got[0] == 20


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(stacked_blocks=True,
                                sequence_parallel=False))
    jm.eval()
    arrays = {n: np.asarray(a) for n, a in
              JaxEngine(jm)._param_arrays().items()}
    pm = GPTForCausalLM(gpt_test_config(stacked_blocks=True), device="cpu")
    return jm, pm.load_params(params_from_numpy(arrays, device="cpu"))


@pytest.fixture(scope="module")
def shared_prompts():
    """A 32-token shared prefix with tails of 5, 9 and 5, and a prompt
    that repeats itself (so the n-gram proposer drafts from the start)."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 128, (32,)).astype(np.int32)
    tails = [rng.randint(0, 128, (t,)).astype(np.int32) for t in (5, 9, 5)]
    cyc = np.tile(rng.randint(0, 128, (4,)).astype(np.int32), 3)
    return [np.concatenate([shared, t]) for t in tails] + [cyc]


def _params(pkg_sp, n):
    """Greedy for the first three requests, a seeded sampling row last."""
    return [pkg_sp(max_new_tokens=NEW) for _ in range(n - 1)] + [
        pkg_sp(max_new_tokens=NEW, seed=11, **SAMPLE)]


def _cfg(**kw):
    return {"block_size": 16, "max_num_seqs": 4, **kw}


@pytest.fixture(scope="module")
def jax_hot(models, shared_prompts):
    """The JAX engine with prefix caching and k=3 spec decoding: a cold
    run of the first prompt, then all four (three adopt the prefix)."""
    jm, _ = models
    eng = JaxEngine(jm, JaxEngineConfig(**_cfg(enable_prefix_caching=True,
                                               speculative_tokens=3)))
    cold = eng.generate([shared_prompts[0]],
                        JaxSamplingParams(max_new_tokens=NEW))
    hot = eng.generate(shared_prompts, _params(JaxSamplingParams, 4))
    return {"cold": cold, "hot": hot, "hits": eng.cache.prefix_hits,
            "hit_tokens": eng.cache.prefix_hit_tokens,
            "proposed": eng._spec_proposed_total,
            "accepted": eng._spec_accepted_total}


def _run(pm, prompts, params, warm=None, **cfg):
    eng = LLMEngine(pm, EngineConfig(device="cpu", **_cfg(**cfg)))
    if warm is not None:
        eng.generate(warm, SamplingParams(max_new_tokens=NEW))
    return eng, eng.generate(prompts, params)


def _same(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.mark.parametrize("spec", [0, 3])
def test_prefix_hit_is_jaxs(models, shared_prompts, jax_hot, spec):
    """Prefix hit (and prefix plus spec) against the JAX engine's hot
    run; JAX's spec greedy tokens are its plain ones."""
    _, pm = models
    eng, got = _run(pm, shared_prompts, _params(SamplingParams, 4),
                    warm=[shared_prompts[0]], enable_prefix_caching=True,
                    speculative_tokens=spec)
    _same(got, jax_hot["hot"])
    np.testing.assert_array_equal(got[0], jax_hot["cold"][0])
    assert (eng.cache.prefix_hits, eng.cache.prefix_hit_tokens) == (
        jax_hot["hits"], jax_hot["hit_tokens"]) == (3, 3 * 32)
    if spec:
        assert (eng._spec_proposed_total, eng._spec_accepted_total) == (
            jax_hot["proposed"], jax_hot["accepted"])
        assert eng._spec_accepted_total > 0 and eng.verify_steps > 0
    # finished requests leave their indexed prompt blocks parked
    assert eng.cache.blocks_in_use == eng.cache.num_parked_blocks > 0


def test_spec_greedy_seeded_and_eos_match_plain(models, shared_prompts,
                                                jax_hot):
    _, pm = models
    params = _params(SamplingParams, 4)
    eng, got = _run(pm, shared_prompts, params, speculative_tokens=3)
    _same(got, jax_hot["hot"])
    assert eng.cache.blocks_in_use == 0      # reservations rolled back
    assert 0 < eng._spec_accepted_total <= eng._spec_proposed_total
    # eos inside an accepted run: the tokens of the plain engine
    prompt = shared_prompts[3]
    eos = int(got[3 - 1][len(shared_prompts[2]) + 1])
    eos_params = SamplingParams(max_new_tokens=NEW, eos_token_id=eos)
    _, plain = _run(pm, [shared_prompts[2], prompt], eos_params)
    eng, spec = _run(pm, [shared_prompts[2], prompt], eos_params,
                     speculative_tokens=3)
    _same(spec, plain)
    assert len(spec[0]) < len(shared_prompts[2]) + NEW


def test_spec_requires_ragged(models):
    _, pm = models
    with pytest.raises(ValueError, match="ragged"):
        LLMEngine(pm, EngineConfig(attention_impl="bucketed",
                                   speculative_tokens=2, device="cpu"))


def test_static_steps_flat_across_rounds(models):
    """One ``ragged`` and one ``verify`` step (on the card: one capture
    each, counted in ``compiles``) across batch compositions, hit / miss
    mixes and spec rounds, as JAX's compiles stay flat (the captures
    themselves: tests/test_torch_port_graphs.py, on the card)."""
    _, pm = models
    eng = LLMEngine(pm, EngineConfig(device="cpu", **_cfg(
        max_num_seqs=8, enable_prefix_caching=True, speculative_tokens=3)))
    rng = np.random.RandomState(4)
    sp = SamplingParams(max_new_tokens=4)
    cyc = np.tile(rng.randint(0, 128, (3,)).astype(np.int32), 6)
    mk = lambda ns: [np.concatenate([cyc, rng.randint(0, 128, (n,))])
                     .astype(np.int32) for n in ns]
    steps = [("ragged", 8, 1), ("verify", 8, 4)]
    # distinct tokens: no draft at the first decode step, a plain step
    eng.generate([np.arange(50, 60, dtype=np.int32)], sp)
    for ns in ((4, 6, 4), (4, 6, 4, 6, 4), (5,)):
        eng.generate(mk(ns), sp)
        assert sorted(eng._steps) == steps and eng.compiles == {}
    assert eng.cache.prefix_hits > 0
    assert eng.step_counts["decode"] > eng.verify_steps > 0


def test_chunk_budget_counts_only_uncached_tokens(models):
    """A 48-token prompt with 32 tokens cached admits its 16-token tail
    in one chunk of the 16-token budget (the cold run takes three)."""
    _, pm = models
    rng = np.random.RandomState(12)
    shared = rng.randint(0, 128, (32,)).astype(np.int32)
    mk = lambda: np.concatenate([shared, rng.randint(0, 128, (16,))
                                 .astype(np.int32)])
    eng = LLMEngine(pm, EngineConfig(device="cpu", **_cfg(
        max_num_seqs=2, enable_prefix_caching=True,
        max_num_batched_tokens=16)))
    chunks = []
    real = eng.scheduler.schedule

    def schedule():
        out = real()
        if out.kind == "prefill":
            chunks.append((out.chunk_start, out.chunk_len))
        return out

    eng.scheduler.schedule = schedule
    sp = SamplingParams(max_new_tokens=2)
    cold = [mk()]
    eng.generate(cold, sp)
    assert chunks == [(0, 16), (16, 16), (32, 16)]
    hot = [mk()]
    got = eng.generate(hot, sp)
    assert chunks[3:] == [(32, 16)] and eng.cache.prefix_hits == 1
    want = LLMEngine(pm, EngineConfig(device="cpu", **_cfg(
        max_num_seqs=2))).generate(hot, sp)
    _same(got, want)


@pytest.fixture(scope="module")
def jax_int8(models, shared_prompts):
    """The JAX int8 engine, greedy: plain and k=3 spec runs of the four
    prompts."""
    jm, _ = models
    sp = JaxSamplingParams(max_new_tokens=NEW)
    runs = {}
    for name, k in (("plain", 0), ("spec", 3)):
        eng = JaxEngine(jm, JaxEngineConfig(**_cfg(
            kv_cache_dtype="int8", speculative_tokens=k)))
        runs[name] = eng.generate(shared_prompts, sp)
        runs[name + "_accepted"] = eng._spec_accepted_total
    return runs


def _agree(got, want, prompts):
    """Share of the generated tokens that agree, averaged over rows."""
    return np.mean([float((a[len(p):] == b[len(p):]).mean())
                    for a, b, p in zip(got, want, prompts)])


def test_int8_prefix_hit_equals_cold_and_spec_agrees(models, shared_prompts,
                                                     jax_int8):
    """JAX's int8 tolerances: a hit equals the int8 engine's cold run
    (adopted blocks carry the codes and scales the cold run wrote), and
    the cold run is the JAX int8 engine's; spec gives the JAX int8 spec
    engine's tokens and agrees with plain int8 decoding on at least 0.9
    of them (rejected draft writes may grow a block's scale)."""
    _, pm = models
    sp = SamplingParams(max_new_tokens=NEW)
    greedy = shared_prompts[:3]
    _, cold = _run(pm, greedy, sp, kv_cache_dtype="int8")
    _same(cold, jax_int8["plain"][:3])
    eng, hot = _run(pm, greedy, sp, warm=[greedy[0]], kv_cache_dtype="int8",
                    enable_prefix_caching=True)
    assert eng.cache.prefix_hits == 3
    _same(hot, cold)
    eng, spec = _run(pm, shared_prompts, sp, kv_cache_dtype="int8",
                     speculative_tokens=3)
    assert eng._spec_accepted_total == jax_int8["spec_accepted"] > 0
    _same(spec, jax_int8["spec"])
    _, plain = _run(pm, shared_prompts, sp, kv_cache_dtype="int8")
    _same(plain, jax_int8["plain"])
    assert _agree(spec, plain, shared_prompts) >= 0.9
    assert _agree(jax_int8["spec"], jax_int8["plain"], shared_prompts) >= 0.9


def test_bucketed_fallback_gives_ragged_tokens(models, shared_prompts,
                                               jax_hot):
    _, pm = models
    greedy = [SamplingParams(max_new_tokens=NEW)] * 4
    _, ragged = _run(pm, shared_prompts, greedy)
    eng, bucketed = _run(pm, shared_prompts, greedy,
                         attention_impl="bucketed")
    _same(bucketed, ragged)
    _same(bucketed[:3], jax_hot["hot"][:3])
    assert eng._steps == {} and eng.step_counts["decode"] > 0
    for kv in (None, "int8"):
        _, a = _run(pm, shared_prompts[:3], greedy[0], kv_cache_dtype=kv,
                    max_num_batched_tokens=16)
        _, b = _run(pm, shared_prompts[:3], greedy[0], kv_cache_dtype=kv,
                    max_num_batched_tokens=16, attention_impl="bucketed")
        _same(b, a)


def test_ragged_env_knob_selects_bucketed(models, monkeypatch):
    _, pm = models
    monkeypatch.setenv("PTPU_RAGGED", "off")
    monkeypatch.setenv("PTPU_PREFIX_CACHE", "1")
    monkeypatch.setenv("PTPU_SPEC_TOKENS", "0")
    eng = LLMEngine(pm, EngineConfig(device="cpu"))
    assert (eng.attention_impl, eng.prefix_caching, eng.spec_tokens) == (
        "bucketed", True, 0)
    monkeypatch.setenv("PTPU_SPEC_TOKENS", "2")
    with pytest.raises(ValueError, match="ragged"):
        LLMEngine(pm, EngineConfig(device="cpu"))
