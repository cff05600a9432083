"""head_dim 384 and 512 through paddle_tpu_torch's attention paths, against
the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

(a) the plain flash forward (out and lse) and backward (dq, dk, dv)
    against the JAX Pallas `_flash_fwd` / `_flash_bwd` in interpret mode
    (``PTPU_PALLAS_INTERPRET=1``, one 128-row block: B=1, H=2, S=128).
    The forward: every branch in float32, bfloat16 and float16 at D = 384
    and 512.  The backward (fed the JAX forward's out and lse, or the
    port's own (row max, log l) pair where a mask or kv_lens is given):
    every branch in the three types, each (branch, type) at one of the
    two head dims, in turns, so that each branch and each type runs at
    both.  Each JAX run happens once, in one module-scoped fixture
    (~0.35 s a forward, ~1 s a backward).
(b) the slice as a whole: a stacked 2-layer GPT of hidden 1024 with two
    heads of 512, the JAX model's weights carried across by
    `convert.params_from_numpy`: the engine's greedy tokens on fp and
    int8 pools and greedy `generate` in the default and the fused mode,
    identical to the JAX package's (whose decode gates send D = 512 to
    XLA: the port's to the plain path, counted under JAX's names), and
    three AdamW steps against the JAX package's compiled step.
(c) the gates: the flash gate takes every multiple of 128 and refuses
    96, 192 and 320; the decode kernels' checks still refuse 384 and 512;
    the decode wrappers send D = 512 to the plain path by shape, before
    any load, count it, and read nothing back to the host (they run on
    the ``meta`` device, where any such read raises).

Limits (`paddle_tpu_torch.ops.tolerance`): float32 forward ``FP32_FWD``
(2e-5, derived for D = 512 and 1024 in the module docstring), backward
``1e-4 max|ref|``; bfloat16 and float16 the per-element limits of each
kernel kind.  Tokens identical; training as
``tests/test_torch_port_head256_bwd.py`` holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.ops import pallas_ops as jpo
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flash_decode as fd
from paddle_tpu_torch.ops import fused_decode as fdl
from paddle_tpu_torch.ops import ragged_paged_attention as rpa
from paddle_tpu_torch.ops import tolerance as tol
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

B, H, S = 1, 2, 128
LSE_TOL = 1e-5
BWD_REL_FP32 = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# name: (causal, mask, kv_lens, segments)
BRANCHES = {"causal": (True, False, False, False),
            "segs_causal": (True, False, False, True),
            "segs_noncausal": (False, False, False, True),
            "mask": (True, True, False, False),
            "kv_lens": (True, False, True, False),
            "noncausal": (False, False, False, False),
            "mask_kv_lens_noncausal": (False, True, True, False)}
FWD_CASES = [(d, name, dt) for d in (384, 512) for name in BRANCHES
             for dt in DTYPES]
# every (branch, type) once, at 512 and 384 in turns: each branch and
# each type at both head dims
BWD_CASES = [(384 if (i + j) % 2 else 512, name, dt)
             for i, name in enumerate(BRANCHES)
             for j, dt in enumerate(DTYPES)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's ops here are small; one intra-op thread a worker keeps
    torch's thread pool from contending with JAX's and with the other
    workers' under ``-n``.  The count is put back after the module."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(d, name, seed=11):
    """q, k, v, dO [B, S, H, d] and the branches of a case, in numpy.  The
    mask: N(0, 2) scores, -1e30 at ~30 % of the keys, column 0 and the
    diagonal open (every row keeps a key); kv_lens S - 37; the ids a
    permutation of three documents."""
    causal, has_mask, has_lens, has_segs = BRANCHES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, H, d).astype(np.float32)
                   for _ in range(4))
    mask = lens = segs = None
    if has_mask:
        mask = (rng.randn(B, 1, S, S) * 2).astype(np.float32)
        mask[rng.rand(B, 1, S, S) < 0.3] = -1e30
        mask[..., 0] = 0.0
        idx = np.arange(S)
        mask[..., idx, idx] = 0.0
    if has_lens:
        lens = np.array([S - 37], np.int32)
    if has_segs:
        row = np.concatenate([np.full(n, i)
                              for i, n in enumerate((50, 40, 38))])
        segs = rng.permutation(row)[None].astype(np.int32)
    return causal, q, k, v, do, mask, lens, segs


@pytest.fixture(scope="module")
def jax_flash():
    """{(d, branch, dtype): (out, lse, (dq, dk, dv) or None)} of the JAX
    Pallas forward (and, for `BWD_CASES`, backward) in interpret mode, one
    128-row block."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PTPU_PALLAS_INTERPRET", "1")
    runs = {}
    try:
        for d, name, dtype in sorted(set(FWD_CASES) | set(BWD_CASES)):
            jdt = DTYPES[dtype][0]
            causal, q, k, v, do, mask, lens, segs = _inputs(d, name)
            qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a).astype(jdt))
                               for a in (q, k, v, do))
            kw = dict(n_heads=H,
                      mask=None if mask is None else jnp.asarray(mask),
                      kv_lens=(None if lens is None
                               else jnp.asarray(lens)[:, None]),
                      segments=None if segs is None else jnp.asarray(segs))
            of, lse = jpo._flash_fwd(qf, kf, vf, causal, d ** -0.5,
                                     block_q=128, block_k=128, **kw)
            assert of.dtype == jdt
            grads = None
            if (d, name, dtype) in BWD_CASES:
                grads = tuple(jpo._unfold_heads(g, B, H) for g in
                              jpo._flash_bwd(qf, kf, vf, of, lse, dof,
                                             causal, d ** -0.5, block_q=128,
                                             block_k=128, **kw))
            runs[d, name, dtype] = (jpo._unfold_heads(of, B, H), lse, grads)
    finally:
        mp.undo()
    return runs


def _assert_within(got, want, limit, what):
    err, ratio, ok = tol.compare(got, want, limit)
    assert ok, f"{what}: max error {err}, {ratio:.3g}x its limit"


@pytest.mark.parametrize("d,name,dtype", FWD_CASES)
def test_plain_forward_matches_jax_kernel(d, name, dtype, jax_flash):
    causal, q, k, v, _, mask, lens, segs = _inputs(d, name)
    tdt = DTYPES[dtype][1]
    want, want_lse, _ = jax_flash[d, name, dtype]
    qt, kt, vt = (_t(a, tdt) for a in (q, k, v))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    ops.reset_launch_counts()
    got, lse = fa.mha_reference(qt, kt, vt, br[0], causal, d ** -0.5,
                                *br[1:], return_lse=True)
    got = got.to(tdt)
    want = _t(_np(want), tdt)
    limit = tol.FP32_FWD if tdt == torch.float32 else tol.flash_fwd_limit(
        got, want, qt, kt, vt, causal, *br)
    _assert_within(got, want, limit, f"forward D={d} {name} {dtype}")
    np.testing.assert_allclose(lse.numpy(), _np(want_lse).reshape(B, H, S),
                               atol=LSE_TOL, rtol=0)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("d,name,dtype", BWD_CASES)
def test_plain_backward_matches_jax_kernels(d, name, dtype, jax_flash):
    """The port's plain backward from the JAX forward's out (and its lse,
    or the port's own (row max, log l) pair with a mask or kv_lens)
    against `_flash_bwd`'s dq, dk, dv, in the case's type."""
    tdt = DTYPES[dtype][1]
    causal, q, k, v, do, mask, lens, segs = _inputs(d, name)
    out, lse, want = jax_flash[d, name, dtype]
    qt, kt, vt, dot = (_t(a, tdt) for a in (q, k, v, do))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    stat = torch.from_numpy(_np(lse).reshape(B, H, S).copy())
    row_max = None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(qt, kt, d ** -0.5, causal, *br)
    outt = _t(_np(out), tdt)
    got = fa.flash_attention_bwd_reference(
        qt, kt, vt, outt, stat, dot, d ** -0.5, is_causal=causal,
        mask=br[0], kv_lens=br[1], segment_ids=br[2], row_max=row_max)
    want = [_t(_np(w), tdt) for w in want]
    if tdt == torch.float32:
        limits = [BWD_REL_FP32 * w.abs().max().item() for w in want]
    else:
        limits = tol.flash_bwd_limits(got, want, qt, kt, vt, outt, stat,
                                      dot, d ** -0.5, causal=causal,
                                      mask=br[0], lens=br[1], segs=br[2],
                                      row_max=row_max)
    for which, g, w, lim in zip(("dq", "dk", "dv"), got, want, limits):
        assert g.dtype == tdt and g.shape == (B, S, H, d)
        _assert_within(g, w, lim, f"{which} D={d} {name} {dtype}")


# ---------------------------------------------------------------------------
# (b) the slice: a GPT with two heads of 512
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=1024, num_attention_heads=2, intermediate_size=1024,
           num_hidden_layers=2, max_position_embeddings=64, vocab_size=128)
P, NEW = 6, 6
ENGINE_NEW = 4
LENS = [5, 12, 5]
STEPS, LR = 3, 1e-3
# the share of a weight's elements whose gradient may be rounding noise
# (`tests/test_torch_port_head256_bwd.py`)
NOISY_SHARE = 5e-3
DECODE_PATHS = ("decode_fallback:head_geometry",
                "ragged_fallback:head_geometry",
                "fused_decode_fallback:head_geometry")


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    m = JaxGPT(jax_test_config(stacked_blocks=True, sequence_parallel=False,
                               **CFG))
    m.eval()
    return m


def _jax_arrays(model):
    return {n: _np(a) for n, a in JaxEngine(model)._param_arrays().items()}


@pytest.fixture(scope="module")
def port_model(jax_model):
    m = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                       device="cpu")
    assert m.cfg.hidden_size // m.cfg.num_attention_heads == 512
    return m.load_params(params_from_numpy(_jax_arrays(jax_model),
                                           device="cpu"))


def _paths(counts):
    return {n: c for n, c in counts.items() if n in DECODE_PATHS}


@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_d512_matches_jax(jax_model, port_model, kv, monkeypatch):
    """Greedy tokens of a mixed batch with a chunked prefill (the 12-token
    prompt in chunks of 8), fp and int8 pools, equal to the JAX engine's;
    every decode and chunk step of the port takes the plain ragged
    attention by its gate (JAX's fallback), counted as JAX names it."""
    monkeypatch.delenv("PTPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32) for n in LENS]
    cfg = dict(block_size=4, max_num_seqs=4, max_num_batched_tokens=8,
               kv_cache_dtype=kv)
    want = JaxEngine(jax_model, JaxEngineConfig(**cfg)).generate(
        prompts, JaxSamplingParams(max_new_tokens=ENGINE_NEW))
    eng = LLMEngine(port_model, EngineConfig(device="cpu", **cfg))
    ops.reset_launch_counts()
    fa.reset_attention_path_counts()
    got = eng.generate(prompts, SamplingParams(max_new_tokens=ENGINE_NEW))
    assert set(ops.launch_counts().values()) == {0}
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert eng.head_dim == 512 and eng.step_counts["chunk"] > 0
    paths = _paths(fa.attention_path_counts())
    assert list(paths) == ["ragged_fallback:head_geometry"], paths
    assert paths["ragged_fallback:head_geometry"] >= (
        eng.step_counts["decode"] + eng.step_counts["chunk"])


def _jax_generate(jax_model, ids):
    jax_model._gen_step = None        # its jit cache ignores the env flags
    return np.asarray(jax_model.generate(paddle.to_tensor(ids),
                                         max_new_tokens=NEW).numpy())


@pytest.mark.parametrize("mode", ["default", "fused"])
def test_generate_d512_matches_jax(jax_model, port_model, mode,
                                   monkeypatch):
    """B=8.  In interpret mode JAX's decode gates see D = 512 and send it
    to XLA (``decode_fallback:head_geometry``, and in the fused mode
    ``fused_decode_fallback:head_geometry`` first); the port's gates take
    the plain path under the same names, and one decode step a key."""
    for name in ("PTPU_PALLAS_INTERPRET", "PTPU_ATTN_DEBUG"):
        monkeypatch.setenv(name, "1")
    if mode == "fused":
        for name in ("PTPU_FUSED_DECODE", "PTPU_PALLAS_FFN"):
            monkeypatch.setenv(name, "1")
    jpo.reset_attention_path_counts()
    ids = np.random.RandomState(2).randint(0, 128, (8, P)).astype(np.int32)
    want = _jax_generate(jax_model, ids)
    jax_paths = _paths(jpo.attention_path_counts())
    ops.reset_launch_counts()
    fa.reset_attention_path_counts()
    port_model._decode_steps.clear()
    got = port_model.generate(torch.from_numpy(ids), max_new_tokens=NEW)
    assert set(ops.launch_counts().values()) == {0}
    np.testing.assert_array_equal(got.numpy(), want)
    paths = _paths(fa.attention_path_counts())
    assert set(paths) == set(jax_paths), (paths, jax_paths)
    assert "decode_fallback:head_geometry" in paths
    assert ("fused_decode_fallback:head_geometry" in paths) == (
        mode == "fused")
    assert len(port_model._decode_steps) == 1


def _jax_params(model):
    """{name: parameter} of the JAX model under the names of
    `JaxEngine._param_arrays` (the port's stacked names)."""
    gpt = model.gpt
    params = {n: getattr(gpt.blocks, n)
              for n in JaxEngine(model)._stack_names}
    params.update(wte=gpt.embeddings.word_embeddings.weight,
                  wpe=gpt.embeddings.position_embeddings.weight,
                  lnf_w=gpt.ln_f.weight, lnf_b=gpt.ln_f.bias)
    return params


def test_three_training_steps_match_jax_d512():
    """Three AdamW steps of the 2 x 512 GPT in both packages (the JAX step
    compiled whole by `paddle_tpu.jit.compile`), held as
    `tests/test_torch_port_head256_bwd.py` holds the 2 x 256 GPT: every
    step's loss within 1e-5; step 1's gradients within 1e-5 of each
    weight's largest; every weight after step 3 within 1e-5, except where
    a step's gradient is rounding noise (``2 * lr * steps``)."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(stacked_blocks=True,
                                    sequence_parallel=False, **CFG))
    jmodel.train()
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                           device="cpu").load_params(
        params_from_numpy(_jax_arrays(jmodel), device="cpu"))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, CFG["vocab_size"], (2, 24)).astype(np.int32)
    labels = rng.randint(0, CFG["vocab_size"], (2, 24)).astype(np.int32)
    labels[1, :4] = -100
    jcrit, crit = JaxCriterion(), GPTPretrainingCriterion()
    jopt = JaxAdamW(learning_rate=LR, parameters=jmodel.parameters())
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    jparams = _jax_params(jmodel)
    names = sorted(jparams)

    def jax_step(x, y):
        loss = jcrit(jmodel(x), y)
        loss.backward()
        grads = [jparams[n].grad for n in names]
        jopt.step()
        jopt.clear_grad()
        return loss, grads

    jstep = paddle.jit.compile(jax_step, models=[jmodel], optimizers=[jopt])
    tparams = dict(model.named_parameters())
    assert set(tparams) == set(names)
    noisy = {n: np.zeros(tuple(tparams[n].shape), bool) for n in names}
    ops.reset_launch_counts()
    for step in range(STEPS):
        jloss, jgrads = jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss = crit(model(torch.from_numpy(ids)), torch.from_numpy(labels))
        loss.backward()
        for name, jg in zip(names, jgrads):
            jg, g = _np(jg.numpy()), tparams[name].grad.numpy()
            if step == 0:
                np.testing.assert_allclose(
                    g, jg, atol=1e-5 * np.abs(jg).max(), rtol=0,
                    err_msg=f"step 1 gradient of {name}")
            noisy[name] |= np.abs(g - jg) > 1e-2 * np.abs(jg)
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(loss.item(), float(jloss.numpy()),
                                   atol=1e-5, rtol=0, err_msg=f"step {step}")
    assert set(ops.launch_counts().values()) == {0}
    want, got = _jax_arrays(jmodel), params_to_numpy(model)
    assert set(got) == set(want) == set(names)
    hidden = CFG["hidden_size"]
    for name in names:
        g, w, nz = got[name], want[name], noisy[name]
        assert g.shape == w.shape, name
        others = int(nz.sum())
        if name == "qkv_b":
            others -= int(nz[:, hidden:2 * hidden].sum())
            nz = nz.copy()
            nz[:, hidden:2 * hidden] = True
        assert others <= NOISY_SHARE * nz.size, (name, others)
        np.testing.assert_allclose(g[nz], w[nz], atol=2 * LR * STEPS, rtol=0,
                                   err_msg=f"{name}, noisy gradients")
        np.testing.assert_allclose(g[~nz], w[~nz], atol=1e-5, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (c) the gates
# ---------------------------------------------------------------------------

def _zeros(*shape, device="cpu"):
    return torch.zeros(*shape, device=device)


@pytest.mark.parametrize("d", [384, 512, 640, 1024])
def test_flash_gate_takes_multiples_of_128(d):
    q, k, v = (_zeros(1, 8, 2, d) for _ in range(3))
    assert fa.head_dim_ok(d)
    fa._check_qkv(q, k, v)


@pytest.mark.parametrize("d", [96, 192, 320])
def test_flash_gate_refuses_other_head_dims(d):
    q, k, v = (_zeros(1, 8, 2, d) for _ in range(3))
    assert not fa.head_dim_ok(d)
    with pytest.raises(ValueError, match="or a larger multiple of 128, got"):
        fa._check_qkv(q, k, v)


@pytest.mark.parametrize("d", [384, 512])
def test_decode_kernel_checks_still_refuse(d):
    q = _zeros(1, 1, 2, d)
    with pytest.raises(ValueError, match="head_dim"):
        fd._check(q, _zeros(1, 16, 2 * d), _zeros(1, 16, 2 * d), 4)
    idx = (torch.zeros(1, 4, dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32),
           torch.ones(1, dtype=torch.int32),
           torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="head_dim"):
        rpa._check(q, q, q, _zeros(4, 16, 2, d), _zeros(4, 16, 2, d), *idx,
                   None, None)
    x = _zeros(8, 2 * d)
    with pytest.raises(ValueError, match="head_dim"):
        fdl._check(x, _zeros(2 * d), _zeros(2 * d), _zeros(2 * d, 6 * d),
                   _zeros(6 * d), _zeros(2 * d, 2 * d), _zeros(2 * d),
                   _zeros(8, 128, 2 * d), _zeros(8, 128, 2 * d), 5, 2, None)


def _refuse_load(monkeypatch):
    def refuse(name):
        raise AssertionError(f"{name} loaded")
    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_decode_wrappers_route_d512_by_shape(device, monkeypatch):
    """D = 512 reaches no kernel (nothing is loaded) and is counted under
    JAX's names; on the ``meta`` device, where a read of a value to the
    host raises, each plain path runs with the position as a device
    tensor, as a captured step calls it."""
    monkeypatch.setenv("PTPU_ATTN_DEBUG", "1")
    monkeypatch.setenv("PTPU_FUSED_DECODE", "1")
    _refuse_load(monkeypatch)
    fa.reset_attention_path_counts()
    b, h, d, smax = 2, 2, 512, 32
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, 1, h, d, generator=g).to(device)
    kc, vc = (torch.randn(b, smax, h * d, generator=g).to(device)
              for _ in range(2))
    t = torch.full((1,), 9, dtype=torch.int32, device=device)
    out = fd.flash_decode_arrays(q, kc, vc, t)
    cached, _, _ = fd.cached_attention_arrays(q, q, q, kc, vc, t)
    nb, bs = 8, 4
    pools = [torch.randn(nb, bs, h, d, generator=g).to(device)
             for _ in range(2)]
    idx = (torch.arange(4, dtype=torch.int32)[None].repeat(b, 1),
           torch.full((b,), 9, dtype=torch.int32),
           torch.full((b,), 10, dtype=torch.int32),
           torch.tensor([[9], [40]], dtype=torch.int32))   # 40: dropped
    ragged = rpa.ragged_paged_attention_arrays(
        q, q, q, *pools, *(a.to(device) for a in idx))[0]
    codes = [torch.randint(-127, 128, (nb, bs, h, d), generator=g,
                           dtype=torch.int8).to(device) for _ in range(2)]
    scales = [torch.rand(nb, h, generator=g).to(device) for _ in range(2)]
    ragged8 = rpa.ragged_paged_attention_arrays(
        q, q, q, *codes, *(a.to(device) for a in idx), *scales)[0]
    x = torch.zeros(b, h * d, device=device)
    assert not fdl.fused_decode_ok(x, torch.zeros(h * d, 3 * h * d), kc, vc,
                                   h)
    assert fa.attention_path_counts() == {
        "decode_fallback:head_geometry": 2,
        "ragged_fallback:head_geometry": 2,
        "fused_decode_fallback:head_geometry": 1}
    for o in (out, cached, ragged, ragged8):
        assert o.shape == (b, 1, h, d) and o.device.type == device
    if device == "cpu":
        # the masked branch over rows [0, 9) is the kernel's plain version
        want = fd.flash_decode_reference(q, kc, vc, 9)
        assert (out - want).abs().max().item() < 1e-6
        # cached attention at t = 9 attends rows 0 .. 9, the new row written
        want = fd.flash_decode_reference(q, kc, vc, 10)
        assert (cached - want).abs().max().item() < 1e-6
