"""float16 through paddle_tpu_torch's serving, generate and training paths,
on the CPU, against the JAX package.

- Serving: the stacked test GPT (hidden 128, two heads of 64, two
  layers), its fp32 weights cast to fp16 by ``amp.decorate(level="O2",
  dtype="float16")`` in both packages, served by each package's
  `LLMEngine` on fp16 pools and on int8 pools: greedy, seeded (threefry)
  and greedy with speculative decoding (k = 3) give the JAX engine's
  tokens.  An fp16 request exported mid-flight from the JAX engine
  continues in the port's, and the other way round, with the tokens of a
  run that never migrated (the handoff carries fp16 pools as numpy
  float16, as JAX's does).
- Dense ``generate`` of the same model, greedy and seeded: the JAX
  `generate` off the TPU (its XLA decode branch) and with its decode
  kernel forced in interpret mode (``PTPU_PALLAS_INTERPRET=1
  PTPU_FLASH_DECODE=1``) give the port's tokens.

  What "the same tokens" can mean in fp16: the two packages' fp16 logits
  differ in the last bit at most positions (XLA computes a fused chain of
  fp16 elementwise ops in fp32 and rounds once, torch rounds each op;
  measured at most 0.00085 on logits up to 1.4, under one fp16 step), so
  a draw whose winner, or whose top-k / top-p cut, sits within that of
  another token can go either way, and the row continues from another
  token.  `check_rows` therefore teacher-forces every port row through
  JAX's dense forward: each generated token must be one the sampler (the
  argmax, or the row's top-k / top-p filter and its gumbel noise from the
  row's threefry key) can draw from JAX's logits of the port's own prefix
  moved by at most `LOGIT_NOISE`, four fp16 steps of max(|logit|, 1) a
  logit (so a gap of at most eight steps between two choices).  A row
  that differs from JAX's does so at a real near-tie: JAX's token there
  passes the same rule under the port's logits of the common prefix.  At
  most one row of a run may differ.  Measured on these runs: every port
  token is the sampler's exact choice under JAX's dense logits (the int8
  pools included); one seeded ``generate`` row of three differs, where
  JAX's token needs the port's logits moved by 0.00146 (1.5 steps).
- Training: three steps of the per-layer test GPT of
  tests/test_torch_port_amp.py with the recipe's clipped AdamW and a
  `GradScaler`, under ``auto_cast(level="O1", dtype="float16")`` over
  fp32 weights and under O2 after ``decorate(dtype="float16")``: the
  losses within 2^-10 relative of JAX's (an fp32 mean of values each
  package computes from activations it rounds to fp16 at the same
  points; one fp16 step, 2^-11 of a value, may land apart in each), the
  loss scale and the steps taken equal.  The scaler starts at 2**26,
  whose scaled gradients pass fp16's 65504 (at 2**15, where it backs off
  to, the largest is ~4240): both packages find the gradients not finite
  at step 1, skip it and back off to 2**15 (``decr_ratio`` 2**-11, one
  bad step); steps 2 and 3 run.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import LLMEngine as JaxEngine
from paddle_tpu.serving import SamplingParams as JaxSamplingParams

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core import random as _random
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.models.gpt import _filter_logits
from paddle_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

CFG = dict(stacked_blocks=True, hidden_size=128, num_attention_heads=2,
           intermediate_size=256, vocab_size=503,
           max_position_embeddings=256)
NEW = 12
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
V = CFG["vocab_size"]
LOGIT_NOISE = 4 * 2.0 ** -10      # fp16 steps of a logit (relative)
MAX_DIFFER = 1                    # rows of a run that may differ from JAX's


def _logits(jm, row):
    """JAX's fp16 logits of every position of ``row`` (one dense forward,
    teacher-forced), as fp32 [len(row) - 1, V]: those of position t give
    token t + 1."""
    ids = paddle.to_tensor(np.asarray(row, np.int32)[None, :-1])
    return np.asarray(jm(ids)._data.astype("float32"))[0]


def _decides(tok, logits, tol, sample=None, noise=None):
    """Whether the sampler can draw ``tok`` from some logits within
    ``tol`` (per entry) of ``logits`` (fp32 [V]).  The most favourable
    such logits raise tok's by tol and lower every other by tol: that
    lifts tok in the argmax, in the top-k rank and in the gumbel argmax,
    and shrinks every other token's share of the top-p mass.  ``sample``
    (temperature, top_k, top_p) and ``noise`` (the draw's gumbel noise
    [V]) for a sampling row, as `_filter_logits` and `categorical`
    use them."""
    fav = logits - tol
    fav[tok] = logits[tok] + tol[tok]
    if sample is None:
        return fav[tok] >= fav.max()
    temp, top_k, top_p = sample
    ll = _filter_logits(torch.from_numpy(fav)[None],
                        torch.tensor([temp], dtype=torch.float32),
                        torch.tensor([top_k]),
                        torch.tensor([top_p], dtype=torch.float32))[0]
    z = (ll + torch.from_numpy(noise)).numpy()
    return ll[tok].item() > -1e29 and z[tok] >= z.max()


def _margin(tok, logits, sample=None, noise=None):
    """The least ``tol`` (relative to max(|logit|, 1)) under which
    `_decides` holds, to 2^-20: how close ``tok`` came to another
    choice (0 for the sampler's own choice)."""
    scale = np.maximum(np.abs(logits), 1.0)
    lo, hi = 0.0, 1.0
    if _decides(tok, logits, 0.0 * scale, sample, noise):
        return 0.0
    if not _decides(tok, logits, hi * scale, sample, noise):
        return np.inf
    while hi - lo > 2.0 ** -20:
        mid = (lo + hi) / 2
        if _decides(tok, logits, mid * scale, sample, noise):
            hi = mid
        else:
            lo = mid
    return hi


def engine_noise(seed, n):
    """The gumbel noise [n, V] of an engine row's n draws: its key
    ``PRNGKey(seed)``, split before each draw (new, sub), noise from sub."""
    key, out = _random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = _random.split(key)
        out.append(_random.gumbel(sub, (V,)).numpy())
    return np.stack(out)


def generate_noise(seed, n, b):
    """The gumbel noise [b, n, V] of dense ``generate``: one key for the
    batch, split before each step, noise [b, V] from sub."""
    key, out = _random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = _random.split(key)
        out.append(_random.gumbel(sub, (b, V)).numpy())
    return np.stack(out, 1)


def check_rows(jm, pm, got, want, prompt_len, draws):
    """The port's rows ``got`` against the JAX package's ``want``.

    - Every generated token of every port row is one the sampler can draw
      from JAX's logits of the port's own prefix (teacher-forced) moved by
      at most `LOGIT_NOISE` of max(|logit|, 1): `_decides`.
    - A row that differs from JAX's first does so at a generated position
      j where the choice is a real near-tie: the port's token at j passes
      under JAX's logits (above) and JAX's token at j passes under the
      port's logits of the common prefix.
    - At most `MAX_DIFFER` rows of a run differ.

    ``draws[i]`` is None for a greedy row, else (sample, noise [n, V]).
    Returns the number of rows that differ."""
    differ = 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        p = prompt_len[i] if isinstance(prompt_len, list) else prompt_len
        assert g.shape == w.shape, f"row {i}: {g.shape} != {w.shape}"
        assert np.array_equal(g[:p], w[:p]), f"row {i}: prompt changed"
        sample, noise = draws[i] or (None, None)
        ref = _logits(jm, g)
        for t in range(p, len(g)):
            nz = None if noise is None else noise[t - p]
            m = _margin(int(g[t]), ref[t - 1], sample, nz)
            assert m <= LOGIT_NOISE, (
                f"row {i}: token {g[t]} at {t} needs JAX's logits moved by "
                f"{m} of max(|logit|, 1) (limit {LOGIT_NOISE})")
        if np.array_equal(g, w):
            continue
        differ += 1
        j = int(np.nonzero(g != w)[0][0])
        with torch.no_grad():
            pl = pm(torch.from_numpy(w[None, :j].astype(np.int32))
                    ).float().numpy()[0, -1]
        m = _margin(int(w[j]), pl, sample,
                    None if noise is None else noise[j - p])
        assert m <= LOGIT_NOISE, (
            f"row {i}: JAX's token {w[j]} at {j} needs the port's logits "
            f"moved by {m} (limit {LOGIT_NOISE})")
    assert differ <= MAX_DIFFER, f"{differ} of {len(got)} rows differ"
    return differ


@pytest.fixture(scope="module")
def models():
    """The JAX and the port's stacked test GPT, the same fp32 weights,
    each cast to fp16 by its package's O2 `decorate`."""
    paddle.seed(0)
    jm = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    jm.eval()
    arrays = {n: np.asarray(a, np.float32) for n, a in
              JaxEngine(jm)._param_arrays().items()}
    jamp.decorate(models=jm, level="O2", dtype="float16")
    pm = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    pm.load_params(params_from_numpy(arrays, device="cpu"))
    tamp.decorate(pm, level="O2", dtype="float16")
    assert all(p.dtype == torch.float16 for p in pm.parameters())
    assert {str(a.dtype) for a in
            JaxEngine(jm)._param_arrays().values()} == {"float16"}
    return jm, pm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 503, (n,)).astype(np.int32) for n in (17, 40)]


def _params(cls, mode):
    if mode == "seeded":
        return cls(max_new_tokens=NEW, seed=7, **SAMPLE)
    return cls(max_new_tokens=NEW)


SAMPLER = (SAMPLE["temperature"], SAMPLE["top_k"], SAMPLE["top_p"])


def _engine_draws(modes):
    return [(SAMPLER, engine_noise(7, NEW)) if m == "seeded" else None
            for m in modes]


def _cfg(kv, mode):
    return dict(block_size=16, max_num_seqs=8, kv_cache_dtype=kv,
                speculative_tokens=3 if mode == "spec" else 0)


@pytest.mark.parametrize("mode", ["greedy", "seeded", "spec"])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_engine_fp16_matches_jax(models, prompts, kv, mode):
    jm, pm = models
    want = JaxEngine(jm, JaxEngineConfig(**_cfg(kv, mode))).generate(
        prompts, _params(JaxSamplingParams, mode))
    eng = LLMEngine(pm, EngineConfig(device="cpu", **_cfg(kv, mode)))
    assert eng.dtype == torch.float16
    assert eng.cache.k_blocks[0].dtype == (torch.int8 if kv
                                           else torch.float16)
    got = eng.generate(prompts, _params(SamplingParams, mode))
    check_rows(jm, pm, got, want, [len(p) for p in prompts],
               _engine_draws([mode] * len(prompts)))
    if mode == "spec":
        assert eng.verify_steps > 0


STEPS_BEFORE_EXPORT = 4


def _migrate(src, dst, prompts, src_sp, dst_sp):
    rids = [src.add_request(p, sp) for p, sp in zip(prompts, src_sp)]
    for _ in range(STEPS_BEFORE_EXPORT):
        src.step()
    hands = [src.export_request(r) for r in rids]
    new = [dst.adopt_request(h["prompt_ids"], sp, h["output_ids"],
                             h["key"], h["kv"])
           for h, sp in zip(hands, dst_sp)]
    while dst.has_unfinished():
        dst.step()
    return [dst.request_output(r) for r in new], hands


@pytest.mark.parametrize("kv", [None, "int8"])
def test_fp16_export_adopt_crosses_the_packages(models, prompts, kv):
    jm, pm = models
    jcfg = dict(block_size=16, max_num_seqs=2, kv_cache_dtype=kv)
    pair = prompts
    modes = ("greedy", "seeded")
    ref = JaxEngine(jm, JaxEngineConfig(**jcfg)).generate(
        pair, [_params(JaxSamplingParams, m) for m in modes])
    outs, hands = _migrate(
        JaxEngine(jm, JaxEngineConfig(**jcfg)),
        LLMEngine(pm, EngineConfig(device="cpu", **jcfg)), pair,
        [_params(JaxSamplingParams, m) for m in modes],
        [_params(SamplingParams, m) for m in modes])
    check_rows(jm, pm, outs, ref, [len(p) for p in pair],
               _engine_draws(modes))
    outs, hands = _migrate(
        LLMEngine(pm, EngineConfig(device="cpu", **jcfg)),
        JaxEngine(jm, JaxEngineConfig(**jcfg)), pair,
        [_params(SamplingParams, m) for m in modes],
        [_params(JaxSamplingParams, m) for m in modes])
    check_rows(jm, pm, outs, ref, [len(p) for p in pair],
               _engine_draws(modes))
    k0 = hands[0]["kv"]["k"][0]
    assert isinstance(k0, np.ndarray)
    assert k0.dtype == (np.int8 if kv else np.float16)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_generate_fp16_matches_jax(models, seeded, kernel, monkeypatch):
    jm, pm = models
    if kernel:
        monkeypatch.setenv("PTPU_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("PTPU_FLASH_DECODE", "1")
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 503, (3, 24)).astype(np.int32)
    kw = dict(SAMPLE, seed=7) if seeded else {}
    jm._gen_step = None                  # its jit cache ignores the flags
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=16,
                                  **kw).numpy())
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=16, **kw)
    assert got.shape == want.shape
    draws = ([(SAMPLER, n) for n in generate_noise(7, 16, len(ids))]
             if seeded else [None] * len(ids))
    check_rows(jm, pm, got.numpy(), want, ids.shape[1], draws)


@pytest.mark.parametrize("wrong", ["constant", "neighbour"])
def test_check_rows_refuses_wrong_tokens(models, wrong):
    """`check_rows` passes JAX's own greedy rows and fails a port whose
    tokens the model would not draw: every generated token of a row one
    constant, or the last token moved to its neighbour in the
    vocabulary."""
    jm, pm = models
    ids = np.random.RandomState(2).randint(0, V, (2, 20)).astype(np.int32)
    jm._gen_step = None
    want = np.asarray(jm.generate(paddle.to_tensor(ids), max_new_tokens=6
                                  ).numpy())
    assert check_rows(jm, pm, want, want, 20, [None, None]) == 0
    got = want.copy()
    if wrong == "constant":
        got[0, 20:] = int(want[0, 20] == 0)
    else:
        got[1, -1] = (want[1, -1] + 1) % V
    with pytest.raises(AssertionError, match="needs JAX's logits moved"):
        check_rows(jm, pm, got, want, 20, [None, None])


# ---------------------------------------------------------------------------
# training under fp16 O1 / O2 with the GradScaler
# ---------------------------------------------------------------------------

TRAIN_CFG = dict(hidden_size=128, num_attention_heads=4,
                 intermediate_size=256, max_position_embeddings=64,
                 vocab_size=128)
STEPS, LR = 3, 1e-3
SCALING = dict(init_loss_scaling=2.0 ** 26, decr_every_n_nan_or_inf=1,
               decr_ratio=2.0 ** -11)


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 128, (2, 32)).astype(np.int32),
            rng.randint(0, 128, (2, 32)).astype(np.int32))


def _recipe(mod, params):
    return mod.AdamW(learning_rate=LR, beta2=0.95, weight_decay=0.1,
                     grad_clip=mod.ClipGradByGlobalNorm(1.0),
                     parameters=params)


def _jax_run(level):
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **TRAIN_CFG))
    jmodel.train()
    init = {k: np.asarray(v.numpy(), np.float32)
            for k, v in jmodel.state_dict().items()}
    if level == "O2":
        jamp.decorate(models=jmodel, level="O2", dtype="float16")
    opt = _recipe(jopt, jmodel.parameters())
    scaler = jamp.GradScaler(**SCALING)
    ids, labels = _batch()
    losses, scales, steps = [], [], []
    for _ in range(STEPS):
        with jamp.auto_cast(level=level, dtype="float16"):
            loss = JaxCriterion()(jmodel(paddle.to_tensor(ids)),
                                  paddle.to_tensor(labels))
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.numpy()))
        scales.append(scaler._scale)
        steps.append(opt._step_count)
    return dict(init=init, losses=losses, scales=scales, steps=steps)


LEVELS = ("O1", "O2")


@pytest.fixture(scope="module")
def jax_runs():
    return {level: _jax_run(level) for level in LEVELS}


@pytest.mark.parametrize("level", LEVELS)
def test_fp16_amp_steps_match_jax(level, jax_runs):
    want = jax_runs[level]
    model = GPTForCausalLM(gpt_test_config(**TRAIN_CFG), device="cpu")
    model.load_params(params_from_numpy(want["init"], device="cpu"))
    if level == "O2":
        tamp.decorate(model, level="O2", dtype="float16")
        assert all(p.dtype == torch.float16 for p in model.parameters())
    opt = _recipe(topt, model.named_parameters())
    scaler = tamp.GradScaler(**SCALING)
    ids, labels = (torch.from_numpy(a) for a in _batch())
    losses, scales, steps = [], [], []
    for _ in range(STEPS):
        with tamp.auto_cast(level=level, dtype="float16"):
            loss = GPTPretrainingCriterion()(model(ids), labels)
        assert loss.dtype == torch.float32
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(loss.item())
        scales.append(scaler._scale)
        steps.append(opt._step_count)
    assert scales == want["scales"] == [2.0 ** 15] * STEPS
    assert steps == want["steps"] == [0, 1, 2]     # step 1 skipped
    np.testing.assert_allclose(losses, want["losses"], rtol=2.0 ** -10)
    assert losses[-1] < losses[0]


def test_ln_ffn_launchers_and_fused_layer_refuse_fp16(monkeypatch):
    """What the fp16 paths leave out: the fused decode layer's gate
    refuses fp16 as JAX's does (`pallas_ops.py:1370-1374`).  The LayerNorm
    and FFN launchers take fp16 (`tests/test_torch_port_fp16_ln_ffn.py`)
    and raise on any type their kernels do not instantiate (float64 here)
    before building anything."""
    from paddle_tpu_torch.ops import fused_decode as fdl
    from paddle_tpu_torch.ops import fused_mlp as fm
    x = torch.zeros(8, 128, dtype=torch.float64)
    w, b = torch.ones(128, dtype=torch.float64), torch.zeros(
        128, dtype=torch.float64)
    with pytest.raises(ValueError, match="float16"):
        fm._ln_launch(x, w, b, 1e-5)
    w1, b1, w2 = (torch.zeros(s, dtype=torch.float64)
                  for s in ((128, 256), (256,), (256, 128)))
    with pytest.raises(ValueError, match="float16"):
        fm._ffn_launch(x, w1, b1, w2, "gelu")
    x = x.half()
    monkeypatch.setenv("PTPU_FUSED_DECODE", "1")
    ring = torch.zeros(8, 16, 128, dtype=torch.float16)
    assert not fdl.fused_decode_ok(x, torch.zeros(128, 384).half(), ring,
                                   ring, 2)
    assert fdl.fused_decode_ok(x.bfloat16(), torch.zeros(128, 384).bfloat16(),
                               ring.bfloat16(), ring.bfloat16(), 2)
