"""The flash kernels at head_dim 384, 512 and larger multiples of 128
against their plain versions, on the card.

Needs a CUDA device and nvcc; every test skips where
torch.cuda.is_available() is False.  Imports no JAX, so on a machine
without it run:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_head512_card.py

The forward, dQ and dK/dV at D = 384 and 512 in every branch (causal,
an additive mask, kv_lens, segment ids, non-causal, mask and kv_lens
non-causal) in float32, bfloat16 and float16, q, k and v slices of one
fused qkv tensor and a strided dO, at a ragged S; D = 640 and 1024 (the
runtime D) causal, and D = 640 at a ragged S in three branches; through
autograd; each launch counted under its branch and ``:wide``, never under
a type's counter.  In bfloat16 and float16 the forward and dK/dV run on
the tensor cores (``csrc/flash_wide_tc.cu``) and count once more under
``:wide_tc``; float32, and dQ in every type, run on the CUDA cores
(``csrc/flash_wide_fwd.cu``, ``csrc/flash_wide_bwd.cu``) and do not.  And the decode gates at
D = 512 on the card: ``generate`` (default and fused mode) and the engine
(fp and int8 pools) with their decode steps captured, one graph each,
their attention the plain path (no decode kernel launched), the tokens
those of the eager run.  Limits (`paddle_tpu_torch.ops.tolerance`): float32
forward ``FP32_FWD`` (2e-5; the module docstring derives it for D = 512
and 1024), backward ``1e-4 max|ref|``; bf16 / fp16 the per-element
limits of the flash kernels.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tolerance as tol

TYPES = (torch.float32, torch.bfloat16, torch.float16)
BWD_REL_FP32 = 1e-4     # fp32 backward: of max|ref| (tolerance docstring)
# (name, causal, mask, kv_lens, segments)
BRANCHES = [("causal", True, False, False, False),
            ("mask", True, True, False, False),
            ("kv_lens", True, False, True, False),
            ("segs", True, False, False, True),
            ("noncausal", False, False, False, False),
            ("mask_kv_lens_noncausal", False, True, True, False)]


@pytest.fixture
def needs_cuda():
    """Skip where there is no card; decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (head_dim 384 / 512 kernel vs "
                    "plain)")


def _within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


def _branch(name, b, s):
    _, causal, m, l, sg = next(c for c in BRANCHES if c[0] == name)
    g = torch.Generator().manual_seed(s)
    mask = lens = segs = None
    if m:
        mask = (torch.randn(b, 1, s, s, generator=g) * 2)
        mask[torch.rand(b, 1, s, s, generator=g) < 0.3] = -1e30
        mask[..., 0] = 0.0
        mask = mask.cuda()
    if l:
        lens = torch.tensor([s - 29 * i for i in range(b)],
                            dtype=torch.int32).cuda()
    if sg:
        cuts = torch.randint(0, 6, (b, s), generator=g)
        segs = torch.cumsum((cuts == 0).int(), 1).int().cuda()
    return causal, mask, lens, segs


def _inputs(b, s, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = torch.randn(b, s, 3, h, d, generator=g).to(
        "cuda", dtype).unbind(2)
    do = torch.randn(b, s, 2, h, d, generator=g).to("cuda", dtype)[:, :, 1]
    return q, k, v, do


def _check_forward(d, dtype, name, b, s, h):
    q, k, v, _ = _inputs(b, s, h, d, dtype, s + d)
    causal, mask, lens, segs = _branch(name, b, s)
    scale = d ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    ops.reset_launch_counts()
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    counts = ops.launch_counts()
    want, want_lse = fa.mha_reference(q, k, v, m4, causal, scale, lens,
                                      segs, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    limit = tol.FP32_FWD if dtype == torch.float32 else \
        tol.flash_fwd_limit(out, want, q, k, v, causal, m4, lens, segs)
    _within(out, want, limit, f"forward D={d} {name} S={s} {dtype}")
    if pair is None:
        _within(lse, want_lse, 1e-5, f"lse {name}")
    else:
        rm, ls = fa.softmax_stats(q, k, scale, causal, m4, lens, segs)
        _within(pair[0], rm, 1e-5, f"row max {name}")
        _within(pair[1], ls, 1e-5, f"log l {name}")
    variant = fa.variant_name(causal, m4, lens, segs)
    want_counts = {
        fa.KERNEL if variant is None else f"{fa.KERNEL}:{variant}": 1,
        fa.wide.KERNEL: 1}
    if dtype != torch.float32:      # the tensor-core forward
        want_counts[fa.wide_tc.KERNEL] = 1
    assert {n: c for n, c in counts.items() if c} == want_counts


def _bwd_limits(got, want, q, k, v, out, stat, do, scale, **br):
    if q.dtype == torch.float32:
        return [BWD_REL_FP32 * w.abs().max().item() for w in want]
    return tol.flash_bwd_limits(got, want, q, k, v, out, stat, do, scale,
                                **br)


def _check_backward(d, dtype, name, b, s, h):
    q, k, v, do = _inputs(b, s, h, d, dtype, s + d + 1)
    causal, mask, lens, segs = _branch(name, b, s)
    scale = d ** -0.5
    m4 = None if mask is None else fa.normalize_mask(mask, b, h, s, s)
    out, lse, pair = fa._launch(q, k, v, scale, causal, m4, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    delta = fa.attention_delta(out, do)
    br = dict(causal=causal, mask=m4, lens=lens, segs=segs)
    ops.reset_launch_counts()
    dq = fa.flash_bwd_dq(q, k, v, do, stat, delta, scale, row_max=row_max,
                         **br)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, stat, delta, scale,
                              row_max=row_max, **br)
    counts = ops.launch_counts()
    want = fa.flash_attention_bwd_reference(
        q, k, v, out, stat, do, scale, is_causal=causal, mask=m4,
        kv_lens=lens, segment_ids=segs, row_max=row_max)
    limits = _bwd_limits((dq, dk, dv), want, q, k, v, out, stat, do, scale,
                         row_max=row_max, **br)
    torch.cuda.synchronize()
    for which, got, w, lim in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                  limits):
        assert got.shape == w.shape and got.dtype == dtype
        assert w.abs().max().item() > 0, f"{which}: a reference of zeros"
        _within(got, w, lim, f"backward {which} D={d} {name} S={s} {dtype}")
    variant = fa.variant_name(causal, m4, lens, segs)
    want_counts = {}
    for kern in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        want_counts[kern.KERNEL if variant is None
                    else kern.variants[variant].KERNEL] = 1
        want_counts[kern.wide.KERNEL] = 1
    if dtype != torch.float32:      # the tensor-core dK/dV; dQ's CUDA cores
        want_counts[fa.flash_bwd_dkv.wide_tc.KERNEL] = 1
    assert {n: c for n, c in counts.items() if c} == want_counts


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
@pytest.mark.parametrize("d", [384, 512])
def test_wide_forward_matches_plain(d, name, dtype):
    _check_forward(d, dtype, name, 2, 330, 2)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", [c[0] for c in BRANCHES])
@pytest.mark.parametrize("d", [384, 512])
def test_wide_backward_matches_plain(d, name, dtype):
    """dQ and dK/dV from the kernel forward's statistics, one launch of
    each, counted under its branch and ``:wide``."""
    _check_backward(d, dtype, name, 2, 330, 2)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [640, 1024])
def test_wide_kernels_take_any_multiple_of_128(d, dtype):
    _check_forward(d, dtype, "causal", 1, 200, 2)
    _check_backward(d, dtype, "causal", 1, 200, 2)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", ["causal", "mask", "segs"])
def test_wide_kernels_at_640_and_a_ragged_s(name, dtype):
    """D = 640, a cluster of five blocks on the tensor cores in 16-bit,
    at S = 330 (no multiple of the 64-row tiles)."""
    _check_forward(640, dtype, name, 2, 330, 2)
    _check_backward(640, dtype, name, 2, 330, 2)


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("name", ["causal", "kv_lens", "segs"])
def test_wide_autograd_launches_both_backward_kernels(dtype, name):
    """`flash_attention_arrays` at D = 512 under autograd: the forward and
    both backward kernels launch once each, and the gradients agree with
    the plain backward fed the kernel forward's out and statistics."""
    b, h, s, d = 2, 2, 200, 512
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
               .requires_grad_() for _ in range(3))
    do = torch.randn(b, s, h, d, generator=g).to("cuda", dtype)
    causal, _, lens, segs = _branch(name, b, s)
    ops.reset_launch_counts()
    out = fa.flash_attention_arrays(q, k, v, is_causal=causal, kv_lens=lens,
                                    segment_ids=segs)
    out.backward(do)
    counts = ops.launch_counts()
    for kern in (fa, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        assert counts[kern.wide.KERNEL] == 1
    tc = int(dtype != torch.float32)
    assert counts[fa.wide_tc.KERNEL] == tc
    assert counts[fa.flash_bwd_dkv.wide_tc.KERNEL] == tc
    scale = d ** -0.5
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o2, lse, pair = fa._launch(qd, kd, vd, scale, causal, None, lens, segs)
    row_max, stat = (None, lse) if pair is None else pair
    want = fa.flash_attention_bwd_reference(
        qd, kd, vd, o2, stat, do, scale, is_causal=causal, kv_lens=lens,
        segment_ids=segs, row_max=row_max)
    limits = _bwd_limits((q.grad, k.grad, v.grad), want, qd, kd, vd, o2,
                         stat, do, scale, causal=causal, lens=lens,
                         segs=segs, row_max=row_max)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o2)
    for which, t, w, lim in zip(("dq", "dk", "dv"), (q, k, v), want,
                                limits):
        _within(t.grad, w, lim, f"autograd {which} {name} {dtype}")


def _model(dtype):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_test_config
    cfg = gpt_test_config(stacked_blocks=True, hidden_size=1024,
                          num_attention_heads=2, intermediate_size=1024,
                          num_hidden_layers=2, max_position_embeddings=256,
                          vocab_size=512)
    return GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                          generator=torch.Generator().manual_seed(0))


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("mode", ["default", "fused"])
def test_generate_d512_captures_the_plain_decode(mode, monkeypatch):
    """bf16 ``generate`` at D = 512: one captured decode graph, the prefill
    on the tensor-core wide forward and no decode kernel (the gates' plain path), the
    tokens those of the eager run."""
    if mode == "fused":
        monkeypatch.setenv("PTPU_FUSED_DECODE", "1")
        monkeypatch.setenv("PTPU_PALLAS_FFN", "1")
    model = _model(torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, (8, 40))).cuda()
    outs = {}
    for graphs in ("0", "1"):
        monkeypatch.setenv("PTPU_CUDA_GRAPHS", graphs)
        model._decode_steps.clear()
        model.compiles.clear()
        ops.reset_launch_counts()
        outs[graphs] = model.generate(ids, max_new_tokens=12)
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        assert counts == {fa.KERNEL: 2, fa.wide.KERNEL: 2,
                          fa.wide_tc.KERNEL: 2}, counts
    assert model.compiles == {"decode": 1}
    assert torch.equal(outs["0"], outs["1"])


@pytest.mark.cuda
@pytest.mark.usefixtures("needs_cuda")
@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_d512_captures_the_plain_ragged_step(kv, monkeypatch):
    """The bf16 engine at D = 512 on fp and int8 pools: one captured
    decode graph (``ragged``), no ragged launch, the flash prefill on the
    tensor-core wide forward, the tokens those of the eager run."""
    from paddle_tpu_torch.serving import (EngineConfig, LLMEngine,
                                          SamplingParams)
    model = _model(torch.bfloat16)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 40, 90)]
    outs = {}
    for graphs in ("0", "1"):
        monkeypatch.setenv("PTPU_CUDA_GRAPHS", graphs)
        eng = LLMEngine(model, EngineConfig(
            block_size=16, max_num_seqs=4, max_num_batched_tokens=64,
            device="cuda", dtype=torch.bfloat16, kv_cache_dtype=kv))
        ops.reset_launch_counts()
        outs[graphs] = eng.generate(prompts,
                                    SamplingParams(max_new_tokens=10))
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        assert set(counts) <= {fa.KERNEL, fa.wide.KERNEL,
                               fa.wide_tc.KERNEL}, counts
        assert counts[fa.wide.KERNEL] > 0
        assert counts[fa.wide_tc.KERNEL] == counts[fa.wide.KERNEL]
        assert eng.compiles == ({"ragged": 1} if graphs == "1" else {})
    for a, b in zip(outs["0"], outs["1"]):
        np.testing.assert_array_equal(a, b)
