"""The decode steps over static buffers and their CUDA graphs
(`paddle_tpu_torch.graphs`), the kernels' device-resident lengths, and the
kept kernel buffers.

On the CPU (no JAX here; the parity with the JAX package is
`test_torch_port_per_layer_decode.py`):

- `cached_attention_arrays`, `flash_decode_arrays` and
  `fused_decode_layer_arrays` (their plain versions on the CPU) with the
  position or length as an int32 tensor give the bits of the int form, at
  t = 1, 127, 128 and the last ring row;
- a `StepGraph` off the card runs its step every call and captures
  nothing; ``generate`` keeps one decode step a shape key (and a new one
  when the weights move), the engine one ``("ragged", max_num_seqs, 1)``
  step a run;
- `_build.tickets` / `_build.scratch` retire the buffer they replace
  instead of freeing it, and refuse to grow during a capture;
- `ops.add_launches` adds a replay's launches to the wrappers' counts.

On the card (marked ``cuda``; skipped here):

- the flash decode and fused layer kernels with a device length or t
  give the bits of the int form;
- one CUDA graph that holds flash decode and the fused layer at a device
  length, the ragged kernel with fp and int8 pools and the FFN's decode
  design (both programmatic dependent launches), replayed at several
  lengths, gives the bits of the eager launches and leaves the tickets at
  zero;
- ``generate`` (both layouts, default and fused mode, padded) and the
  engine (fp and int8 pools) give the same tokens captured as eager
  (``PTPU_CUDA_GRAPHS=0``), with one capture per key and the same
  replay-counted launches; with prefix caching and speculative decoding
  the engine keeps one ``ragged`` and one ``verify`` capture;
- no garbage collection starts during a capture, with the collector
  run at every allocation, and an engine whose graph is cyclic garbage
  leaves the next engine's tokens alone.

On a machine without JAX run:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_port_graphs.py
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu_torch import graphs, ops
from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import fused_mlp as fm
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


S_MAX = 256
T_EDGES = [1, 127, 128, S_MAX - 1]


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs, kernels)")


def _pos(t, device="cpu"):
    return torch.tensor([t], dtype=torch.int32, device=device)


def _randn(shape, seed, dtype=torch.float32, device="cpu", scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(device, dtype)


def _layer_args(b, h, d, s_max, seed, dtype=torch.float32, device="cpu"):
    hd = h * d
    return [_randn((b, hd), seed, dtype, device),
            1 + _randn((hd,), seed + 1, dtype, device, 0.1),
            _randn((hd,), seed + 2, dtype, device, 0.1),
            _randn((hd, 3 * hd), seed + 3, dtype, device, hd ** -0.5),
            _randn((3 * hd,), seed + 4, dtype, device, 0.1),
            _randn((hd, hd), seed + 5, dtype, device, hd ** -0.5),
            _randn((hd,), seed + 6, dtype, device, 0.1),
            _randn((b, s_max, hd), seed + 7, dtype, device),
            _randn((b, s_max, hd), seed + 8, dtype, device)]


# ---------------------------------------------------------------------------
# device positions, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", T_EDGES)
def test_cached_attention_tensor_t_is_bitwise_the_int_form(t, dtype,
                                                           masked):
    b, h, d = 2, 2, 64
    q, k, v = (_randn((b, 1, h, d), t + i, dtype) for i in range(3))
    kc, vc = (_randn((b, S_MAX, h * d), t + 3 + i, dtype) for i in range(2))
    mask = None
    if masked:
        g = torch.Generator().manual_seed(t)
        mask = torch.where(torch.rand(b, 1, 1, S_MAX, generator=g) < 0.2,
                           -1e30, 0.0)
    want = ops.cached_attention_arrays(q, k, v, kc.clone(), vc.clone(), t,
                                       mask=mask)
    got = ops.cached_attention_arrays(q, k, v, kc.clone(), vc.clone(),
                                      _pos(t), mask=mask)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert torch.equal(want[1][:, t], k.reshape(b, h * d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", T_EDGES)
def test_flash_decode_tensor_length_is_bitwise_the_int_form(t, dtype):
    q = _randn((3, 1, 2, 64), t, dtype)
    kc, vc = (_randn((3, S_MAX, 128), t + i, dtype) for i in (1, 2))
    want = ops.flash_decode_arrays(q, kc, vc, t + 1)
    assert torch.equal(ops.flash_decode_arrays(q, kc, vc, _pos(t + 1)), want)
    assert torch.equal(fd.flash_decode_reference(q, kc, vc, _pos(t + 1)),
                       want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", T_EDGES)
def test_fused_layer_reference_tensor_t_is_bitwise_the_int_form(t, dtype,
                                                                masked):
    args = _layer_args(3, 2, 64, S_MAX, t, dtype)
    mask = None
    if masked:
        g = torch.Generator().manual_seed(t)
        mask = torch.where(torch.rand(3, S_MAX, generator=g) < 0.2, -1e30,
                           0.0)
    rings = [a.clone() for a in args[7:]]
    want = fdl.fused_decode_layer_reference(*args[:7], *rings, t, 2,
                                            cache_mask=mask)
    rings = [a.clone() for a in args[7:]]
    got = fdl.fused_decode_layer_reference(*args[:7], *rings, _pos(t), 2,
                                           cache_mask=mask)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    rings = [a.clone() for a in args[7:]]
    got = fdl.fused_decode_layer_arrays(*args[:7], *rings, _pos(t), 2,
                                        cache_mask=mask)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def test_device_int_arguments():
    assert _build.device_int(5, "cpu", "t") == (0, 5)
    t = _pos(7)
    assert _build.device_int(t, torch.device("cpu"), "t") == (t.data_ptr(),
                                                               0)
    for bad in (torch.tensor([7]), torch.tensor([1, 2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32 tensor of one element"):
            _build.device_int(bad, "cpu", "t")


# ---------------------------------------------------------------------------
# kept buffers, launch counts, step objects, on the CPU
# ---------------------------------------------------------------------------

def test_kept_buffers_are_retired_not_freed(monkeypatch):
    monkeypatch.setattr(_build, "_TICKETS", {})
    monkeypatch.setattr(_build, "_SCRATCH", {})
    monkeypatch.setattr(_build, "_RETIRED", [])
    dev = torch.device("cpu")
    first = _build.tickets(dev, 10)
    assert _build.tickets(dev, 64) is first        # fits: the same buffer
    addr = _build.scratch("k", dev, 1000)
    assert _build.scratch("k", dev, 256) == addr
    second = _build.tickets(dev, 100)
    bigger = _build.scratch("k", dev, 5000)
    assert second is not first and second.numel() == 100
    assert bigger != addr
    # the replaced buffers stay alive for the graphs that hold them
    assert _build._RETIRED[0] is first
    assert _build._RETIRED[1].data_ptr() == addr
    # during a capture a buffer that fits is handed out; one that would
    # have to grow raises
    monkeypatch.setattr(_build, "_capturing", lambda device: True)
    assert _build.tickets(dev, 100) is second
    assert _build.scratch("k", dev, 5000) == bigger
    with pytest.raises(RuntimeError, match="during a CUDA-graph capture"):
        _build.tickets(dev, 101)
    with pytest.raises(RuntimeError, match="during a CUDA-graph capture"):
        _build.scratch("other", dev, 8)
    assert len(_build._RETIRED) == 2


def test_add_launches_adds_to_each_wrapper():
    ops.reset_launch_counts()
    ops.add_launches({fd.KERNEL: 24, rpa.int8.KERNEL: 12})
    ops.add_launches({fd.KERNEL: 24})
    counts = ops.launch_counts()
    assert counts[fd.KERNEL] == 48 and counts[rpa.int8.KERNEL] == 12
    assert sum(counts.values()) == 60
    ops.reset_launch_counts()


def test_step_graph_runs_eagerly_off_the_card(monkeypatch):
    calls, counts = [], {}
    step = graphs.StepGraph(lambda: calls.append(1) or len(calls), "cpu",
                            "decode", counts)
    assert [step() for _ in range(3)] == [1, 2, 3]
    assert step.graph is None and counts == {}
    monkeypatch.delenv(graphs.ENV, raising=False)
    assert not graphs.graphs_on("cpu")
    assert graphs.graphs_on("cuda")
    monkeypatch.setenv(graphs.ENV, "0")
    assert not graphs.graphs_on("cuda")


CFG = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
           max_position_embeddings=256, vocab_size=128)


@pytest.mark.parametrize("stacked", [True, False])
def test_generate_keeps_one_decode_step_a_key(stacked):
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=stacked, **CFG),
                           device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 128, (2, 9)).astype(np.int32))
    a = model.generate(ids, max_new_tokens=6)
    step = next(iter(model._decode_steps.values()))
    assert model.generate(ids, max_new_tokens=6).equal(a)
    # another prompt length in the same 128-row ring: the same step
    assert model.generate(ids[:, 1:], max_new_tokens=7).shape == (2, 15)
    assert list(model._decode_steps.values()) == [step]
    key = next(iter(model._decode_steps))
    assert key[:4] == (2, 128, torch.float32, stacked) and key[5] is False
    assert int(step.t) == 8 + 7 - 1        # the last step wrote row 13
    model.generate(ids[:1], max_new_tokens=3)
    assert len(model._decode_steps) == 2
    assert model.compiles == {}            # no graph off the card
    # weights that moved: a new step (a graph holds their addresses)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    assert model.generate(ids, max_new_tokens=6).equal(a)
    assert model._decode_steps[key] is not step


def test_engine_keeps_one_decode_step():
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                           device="cpu")
    eng = LLMEngine(model, EngineConfig(max_num_seqs=4, device="cpu"))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (3, 17, 40, 9, 60)]
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=5))
    assert [len(o) for o in outs] == [n + 5 for n in (3, 17, 40, 9, 60)]
    assert list(eng._steps) == [("ragged", 4, 1)]
    step = eng._steps[("ragged", 4, 1)]
    assert step.run.warm and step.run.graph is None
    assert eng.compiles == {} and eng.step_counts["decode"] > 1
    assert step.inputs.shape == (4 * 4 + 4 * eng.blocks_per_seq,)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_length_kernels_match_the_int_form(dtype):
    b, h, d, s_max = 8, 12, 64, 1024
    q = _randn((b, 1, 3, h, d), 1, dtype, "cuda")[:, :, 0]
    kc, vc = (_randn((b, s_max, h * d), i, dtype, "cuda") for i in (2, 3))
    for length in (1, 2, 127, 128, 129, 255, 257, 1000, 1024):
        want = fd.flash_decode_arrays(q, kc, vc, length)
        got = fd.flash_decode_arrays(q, kc, vc, _pos(length, "cuda"))
        torch.cuda.synchronize()
        assert torch.equal(got, want), length
    assert int(_build.tickets(q.device, 1).abs().sum()) == 0
    args = _layer_args(b, h, d, s_max, 5, dtype, "cuda")
    for t in (1, 127, 128, 129, 511, 1023):
        r1 = [a.clone() for a in args[7:]]
        r2 = [a.clone() for a in args[7:]]
        want = fdl.fused_decode_layer_arrays(*args[:7], *r1, t, h)
        got = fdl.fused_decode_layer_arrays(*args[:7], *r2,
                                            _pos(t, "cuda"), h)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), t
    assert int(_build.tickets(q.device, 1).abs().sum()) == 0


def _ragged_inputs(dtype, quant, seed):
    """The engine's decode step: 8 rows of 1-700 keys over 16-key blocks
    of a 1024-key table, H=12 D=64; the slots of position pos0."""
    b, h, d, bs, maxb = 8, 12, 64, 16, 64
    nb = b * maxb + 1
    lens = torch.tensor([700, 1, 127, 128, 129, 300, 513, 64],
                        dtype=torch.int32)
    table = torch.arange(b * maxb, dtype=torch.int32).view(b, maxb)
    pos0 = lens - 1
    slots = (table.gather(1, (pos0 // bs).long()[:, None]) * bs
             + (pos0 % bs)[:, None]).to(torch.int32)
    q, kn, vn = (_randn((b, 1, h, d), seed + i, dtype, "cuda")
                 for i in range(3))
    if quant:
        g = torch.Generator().manual_seed(seed)
        pools = [torch.randint(-127, 128, (nb, bs, h, d), generator=g,
                               dtype=torch.int8).cuda() for _ in range(2)]
        scales = [torch.rand(nb, h, generator=g).cuda() * 0.02
                  for _ in range(2)]
    else:
        pools = [_randn((nb, bs, h, d), seed + 5 + i, dtype, "cuda")
                 for i in range(2)]
        scales = [None, None]
    dev = [x.cuda() for x in (table, pos0, lens, slots)]
    return [q, kn, vn, *pools, *dev, *scales]


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_replay_in_one_cuda_graph(dtype):
    """Flash decode and the fused layer (cooperative) at a device length,
    the ragged kernel with fp and int8 pools and the FFN's decode design
    (programmatic dependent launches), captured in one graph and replayed
    at three lengths: the eager launches' bits, tickets left at zero."""
    b, h, d, s_max = 8, 12, 64, 1024
    q = _randn((b, 1, h, d), 1, dtype, "cuda")
    kc, vc = (_randn((b, s_max, h * d), i, dtype, "cuda") for i in (2, 3))
    args = _layer_args(b, h, d, s_max, 4, dtype, "cuda")
    rings = args[7:]
    fp = _ragged_inputs(dtype, False, 20)
    i8 = _ragged_inputs(dtype, True, 30)
    x = _randn((b, 768), 40, dtype, "cuda")
    w1 = _randn((768, 3072), 41, dtype, "cuda", 768 ** -0.5)
    b1 = _randn((3072,), 42, dtype, "cuda", 0.1)
    w2 = _randn((3072, 768), 43, dtype, "cuda", 3072 ** -0.5)
    length = _pos(1, "cuda")
    saved = [t.clone() for t in rings + fp[3:5] + i8[3:5] + i8[9:]]

    def restore():
        for dst, src in zip(rings + fp[3:5] + i8[3:5] + i8[9:], saved):
            dst.copy_(src)

    def body():
        return (fd.flash_decode_arrays(q, kc, vc, length),
                fdl.fused_decode_layer_arrays(*args[:7], *rings, length,
                                              h)[0],
                rpa.ragged_paged_attention_arrays(*fp[:9])[0],
                rpa.ragged_paged_attention_arrays(*i8)[0],
                fm.fused_ffn_arrays(x, w1, b1, w2, act="gelu_tanh"))

    assert fm.ffn_design(b, 768, 3072, dtype) == "decode"
    body()                                   # build, load, size buffers
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    captured = ops.launch_counts()
    for n in (1, 129, 1023):
        restore()
        length.fill_(n)
        torch.cuda.synchronize()
        want = [o.clone() for o in body()]
        restore()
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        for name, got, w in zip(("decode", "fused", "ragged", "int8",
                                 "ffn"), outs, want):
            assert torch.equal(got, w), (name, n)
    assert captured[fd.KERNEL] == captured[fdl.KERNEL] == 1
    assert captured[rpa.KERNEL] == captured[rpa.int8.KERNEL] == 1
    assert int(_build.tickets(q.device, 1).abs().sum()) == 0


CARD_CFG = dict(hidden_size=128, num_attention_heads=2,
                intermediate_size=256, max_position_embeddings=512,
                vocab_size=512)
MODES = {"default": {}, "fused": {"PTPU_FUSED_DECODE": "1",
                                  "PTPU_PALLAS_FFN": "1"},
         "flags": {"PTPU_PALLAS_LN": "1", "PTPU_PALLAS_FFN": "1"}}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("stacked,mode,padded", [
    (True, "default", False), (True, "fused", False),
    (True, "default", True), (True, "fused", True),
    (False, "default", False), (False, "flags", False)])
def test_generate_captured_equals_eager(stacked, mode, padded, monkeypatch):
    for k in ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN", "PTPU_PALLAS_LN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=stacked,
                                           **CARD_CFG), device="cuda")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, 512, (8, 100)).astype(np.int32))
    kw = {}
    if padded:
        for r in range(1, 8, 2):
            ids[r, :9 * r] = 0
        kw["pad_token_id"] = 0
    ids = ids.cuda()
    runs = {}
    for graphs_env in ("0", "1"):
        monkeypatch.setenv(graphs.ENV, graphs_env)
        model.generate(ids, max_new_tokens=3, **kw)     # warm-up
        ops.reset_launch_counts()
        out = model.generate(ids, max_new_tokens=28, **kw)   # same ring
        torch.cuda.synchronize()
        runs[graphs_env] = (out, ops.launch_counts())
    assert torch.equal(runs["0"][0], runs["1"][0])
    assert runs["0"][1] == runs["1"][1]
    assert model.compiles == {"decode": 1}
    step = next(iter(model._decode_steps.values()))
    assert step.run.capture_ms > 0
    # a padded default step takes the masked torch branch: no kernel
    assert (step.run.launches == {}) == (padded and mode == "default")


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_captured_equals_eager(kv, monkeypatch):
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CARD_CFG),
                           device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (7, 64, 200, 31, 150)]
    runs = {}
    for graphs_env in ("0", "1"):
        monkeypatch.setenv(graphs.ENV, graphs_env)
        eng = LLMEngine(model, EngineConfig(
            block_size=16, max_num_seqs=4, max_num_batched_tokens=128,
            device="cuda", kv_cache_dtype=kv))
        ops.reset_launch_counts()
        outs = eng.generate(prompts, SamplingParams(max_new_tokens=24))
        runs[graphs_env] = (outs, ops.launch_counts(), eng)
    for a, b in zip(runs["0"][0], runs["1"][0]):
        np.testing.assert_array_equal(a, b)
    assert runs["0"][1] == runs["1"][1]
    assert runs["1"][2].compiles == {"ragged": 1}
    assert runs["0"][2].compiles == {}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_captures_stay_flat_with_prefix_and_spec(kv, monkeypatch):
    """Prefix caching and k=3 speculative decoding on the card: one
    ``ragged`` and one ``verify`` capture across batch compositions, hit /
    miss mixes and spec rounds (adoption and copy-on-write move only
    tables and pool rows), and the tokens of the same engine run eagerly
    (``PTPU_CUDA_GRAPHS=0``)."""
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CARD_CFG),
                           device="cpu")
    rng = np.random.RandomState(4)
    cyc = np.tile(rng.randint(0, 512, (3,)).astype(np.int32), 6)
    rounds = [[np.concatenate([cyc, rng.randint(0, 512, (n,))]).astype(
        np.int32) for n in ns] for ns in ((4, 6, 4), (4, 6, 4, 6, 4), (5,))]
    params = [SamplingParams(max_new_tokens=8),
              SamplingParams(max_new_tokens=8, do_sample=True, seed=3,
                             temperature=0.8, top_k=20)]
    runs = {}
    for graphs_env in ("0", "1"):
        monkeypatch.setenv(graphs.ENV, graphs_env)
        eng = LLMEngine(model, EngineConfig(
            block_size=16, max_num_seqs=8, device="cuda", kv_cache_dtype=kv,
            enable_prefix_caching=True, speculative_tokens=3))
        outs = [eng.generate(r, [params[i % 2] for i in range(len(r))])
                for r in rounds]
        runs[graphs_env] = (outs, eng)
    for a, b in zip(runs["0"][0], runs["1"][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    eng = runs["1"][1]
    assert eng.compiles == {"ragged": 1, "verify": 1}
    assert eng.cache.prefix_hits > 0 and eng.verify_steps > 0
    assert runs["0"][1].compiles == {}


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
def test_no_collection_during_a_capture():
    # an engine holds its captured graph in a reference cycle, so only a
    # collection frees it; a collection during another capture would
    # free that graph inside it, a CUDA call the capture forbids.  With
    # the collector run at every allocation, none may start while a
    # stream captures, and a dead engine's graph leaves the next
    # engine's tokens alone
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CARD_CFG),
                           device="cuda")
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (5, 9)]
    sp = SamplingParams(max_new_tokens=6)

    def run():
        eng = LLMEngine(model, EngineConfig(device="cuda"))
        out = eng.generate(prompts, sp)
        assert eng.compiles == {"ragged": 1}
        return out

    want = run()                 # its engine is garbage from here on
    during = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        got = run()
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*thresholds)
    assert during == []
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
