"""Fork, export / adopt and deadlines of the port's engine, on the CPU
against the JAX package.

- Fork (tests/test_serving.py `test_engine_fork_shares_prefix_blocks`):
  the child shares the parent's full blocks, its re-fed last position
  lands in a private copy of the last block (codes and int8 scales), the
  parent's tokens are those of an unforked run, and parent and seeded
  child are the JAX engine's, fp32 and int8 pools.
- Migration: a greedy and a seeded request exported mid-flight from the
  JAX engine continue in the port's, and the other way round, with the
  tokens of a run that never migrated, fp32 and int8 pools (the handoff
  is the JAX package's: numpy key and per-layer numpy KV lists).
- Deadlines: an expired request is released at the next step (blocks
  freed, `generate` returns None in its place); releasing a forked child
  that still waits frees its blocks.
"""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


NEW = 8
STEPS_BEFORE_EXPORT = 5
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)


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
def prompts():
    rng = np.random.RandomState(2)
    return [rng.randint(0, 128, (20,)).astype(np.int32) for _ in range(2)]


def _params(sp_cls):
    """A greedy and a seeded request."""
    return [sp_cls(max_new_tokens=NEW), sp_cls(max_new_tokens=NEW, seed=3,
                                               **SAMPLE)]


def _cfg(kv):
    return {"block_size": 16, "max_num_seqs": 2, "kv_cache_dtype": kv}


def _port(pm, kv):
    return LLMEngine(pm, EngineConfig(device="cpu", **_cfg(kv)))


def _fork(eng, prompt, sp_cls):
    parent = eng.add_request(prompt, sp_cls(max_new_tokens=5))
    eng.step()                         # prefill + first token
    child = eng.fork_request(parent, sp_cls(max_new_tokens=5, seed=5,
                                            **SAMPLE))
    shared = eng.cache.blocks_in_use
    while eng.has_unfinished():
        eng.step()
    out = (eng.request_output(parent), eng.request_output(child), shared,
           eng.cache.peak_blocks_in_use)
    eng.release_request(parent)
    eng.release_request(child)
    return out


def _migrate(src, dst, prompts, src_sp, dst_sp):
    """Run both requests on ``src`` for a few steps, export them, adopt
    them on ``dst`` and run them to the end there."""
    rids = [src.add_request(p, sp) for p, sp in zip(prompts, src_sp)]
    for _ in range(STEPS_BEFORE_EXPORT):
        src.step()
    hands = [src.export_request(r) for r in rids]
    assert not src.has_unfinished() and src.cache.blocks_in_use == 0
    new = [dst.adopt_request(h["prompt_ids"], sp, h["output_ids"],
                             h["key"], h["kv"])
           for h, sp in zip(hands, dst_sp)]
    while dst.has_unfinished():
        dst.step()
    outs = [dst.request_output(r) for r in new]
    for r in new:
        dst.release_request(r)
    return outs, hands


@pytest.fixture(scope="module", params=[None, "int8"])
def jax_runs(request, models, prompts):
    """One JAX engine per pool type: the unmigrated run, the fork run,
    an export for the port, and the engine itself to adopt the port's
    exports."""
    jm, _ = models
    kv = request.param
    eng = JaxEngine(jm, JaxEngineConfig(**_cfg(kv)))
    ref = eng.generate(prompts, _params(JaxSamplingParams))
    fork = _fork(eng, prompts[0], JaxSamplingParams)
    rids = [eng.add_request(p, sp)
            for p, sp in zip(prompts, _params(JaxSamplingParams))]
    for _ in range(STEPS_BEFORE_EXPORT):
        eng.step()
    hands = [eng.export_request(r) for r in rids]
    return {"kv": kv, "engine": eng, "ref": ref, "fork": fork,
            "hands": hands}


def test_fork_is_jaxs(models, prompts, jax_runs):
    _, pm = models
    kv = jax_runs["kv"]
    parent, child, shared, peak = _fork(_port(pm, kv), prompts[0],
                                        SamplingParams)
    want = jax_runs["fork"]
    np.testing.assert_array_equal(parent, want[0])
    np.testing.assert_array_equal(child, want[1])
    # one full block shared, the partial last block privatised at fork
    assert shared == want[2] == 3
    assert peak <= 4                 # below two private copies
    # forking does not perturb the parent
    [solo] = _port(pm, kv).generate([prompts[0]],
                                    SamplingParams(max_new_tokens=5))
    np.testing.assert_array_equal(parent, solo)
    assert len(child) == 21 + 5


def test_fork_privatises_the_last_block_with_its_scales(models, prompts):
    _, pm = models
    eng = _port(pm, "int8")
    parent = eng.add_request(prompts[0], SamplingParams(max_new_tokens=5))
    eng.step()
    before = eng.cache.block_table(parent)
    child = eng.fork_request(parent)
    after = eng.cache.block_table(child)
    assert after[0] == before[0] and after[1] != before[1]
    c = eng.cache
    for l in range(c.num_layers):
        assert c.k_blocks[l][after[1]].equal(c.k_blocks[l][before[1]])
        assert c.v_scales[l][after[1]].equal(c.v_scales[l][before[1]])
        assert c.k_scales[l][after[1]].abs().sum() > 0
    assert [c._blocks[i].ref for i in before] == [2, 1]


def test_jax_export_continues_in_the_port(models, prompts, jax_runs):
    _, pm = models
    kv = jax_runs["kv"]
    dst = _port(pm, kv)
    hands = jax_runs["hands"]
    new = [dst.adopt_request(h["prompt_ids"], sp, h["output_ids"],
                             h["key"], h["kv"])
           for h, sp in zip(hands, _params(SamplingParams))]
    while dst.has_unfinished():
        dst.step()
    for i, r in enumerate(new):
        np.testing.assert_array_equal(dst.request_output(r),
                                      jax_runs["ref"][i])
    # adoption ran no prefill: the requests entered decode-only
    assert dst.step_counts["prefill"] == dst.step_counts["chunk"] == 0


def test_port_export_continues_in_jax(models, prompts, jax_runs):
    _, pm = models
    kv = jax_runs["kv"]
    outs, hands = _migrate(_port(pm, kv), jax_runs["engine"], prompts,
                           _params(SamplingParams),
                           _params(JaxSamplingParams))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, jax_runs["ref"][i])
    h = hands[1]
    assert h["key"].dtype == np.uint32 and h["key"].shape == (2,)
    assert isinstance(h["kv"]["k"][0], np.ndarray)
    assert len(h["kv"]["k"]) == pm.cfg.num_hidden_layers
    if kv:
        assert h["kv"]["ks"][0].shape == (len(h["kv"]["k"][0]),
                                          pm.cfg.num_attention_heads)
    # and within the port
    outs, _ = _migrate(_port(pm, kv), _port(pm, kv), prompts,
                       _params(SamplingParams), _params(SamplingParams))
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, jax_runs["ref"][i])


def test_export_refuses_what_jax_refuses(models, prompts):
    _, pm = models
    eng = _port(pm, None)
    rid = eng.add_request(prompts[0], SamplingParams(max_new_tokens=4))
    with pytest.raises(ValueError, match="fully-prefilled"):
        eng.export_request(rid)
    with pytest.raises(ValueError, match="at least one emitted"):
        eng.adopt_request(prompts[0], None, [], np.zeros(2, np.uint32), {})
    with pytest.raises(ValueError, match="already finished"):
        eng.adopt_request(prompts[0], SamplingParams(max_new_tokens=1),
                          [5], np.zeros(2, np.uint32), {})
    eng.step()
    eng.export_request(rid)
    assert rid not in eng._requests and eng.cache.blocks_in_use == 0


def test_expired_deadline_gives_none_and_frees_its_blocks(models, prompts):
    _, pm = models
    eng = _port(pm, None)
    sps = [SamplingParams(max_new_tokens=NEW),
           SamplingParams(max_new_tokens=NEW, deadline_s=3600.0)]
    ok = eng.generate(prompts, sps)
    assert all(o is not None for o in ok)
    rid = eng.add_request(prompts[0],
                          SamplingParams(max_new_tokens=NEW, deadline_s=1e-6))
    keep = eng.add_request(prompts[1], SamplingParams(max_new_tokens=NEW))
    eng.step()                                   # prefill of rid
    time.sleep(0.01)
    eng.step()                                   # the sweep releases rid
    assert rid not in eng._requests and eng.num_expired == 1
    assert eng.cache._tables.keys() == {keep}
    while eng.has_unfinished():
        eng.step()
    np.testing.assert_array_equal(eng.request_output(keep), ok[1])
    eng.release_request(keep)
    assert eng.cache.blocks_in_use == 0
    got = eng.generate(prompts, [SamplingParams(max_new_tokens=NEW,
                                                deadline_s=1e-6),
                                 SamplingParams(max_new_tokens=NEW)])
    assert got[0] is None
    np.testing.assert_array_equal(got[1], ok[1])
    assert eng.cache.blocks_in_use == 0


def test_release_frees_a_waiting_forked_child(models, prompts):
    _, pm = models
    eng = _port(pm, None)
    parent = eng.add_request(prompts[0], SamplingParams(max_new_tokens=4))
    eng.step()
    held = eng.cache.blocks_in_use
    child = eng.fork_request(parent)
    assert eng.cache.blocks_in_use == held + 1     # the privatised block
    req = eng._requests[child]
    eng.release_request(child)
    assert req.finish_reason == "released"
    assert eng.cache.blocks_in_use == held
    assert [eng.cache._blocks[i].ref
            for i in eng.cache.block_table(parent)] == [1, 1]
    while eng.has_unfinished():
        eng.step()
    req = eng._requests[parent]
    eng.release_request(parent)
    assert req.finish_reason == "stop" and eng.cache.blocks_in_use == 0
