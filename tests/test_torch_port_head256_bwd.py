"""The flash backward at head_dim 256 and the training of a GPT with heads
of 256, paddle_tpu_torch against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages at
D = 256:

(a) the port's plain backward (`flash_attention_bwd_reference`, the
    oracle its dQ and dK/dV kernels are held to on the card) against the
    JAX Pallas backward `_flash_bwd` in interpret mode
    (``PTPU_PALLAS_INTERPRET=1``, one 128-row block: B=1, H=2, S=128), fed
    the JAX forward's out and lse (the port's own (row max, log l) pair
    where a mask or kv_lens is given): causal, an additive mask, kv_lens,
    segment ids and non-causal in bfloat16; causal and the mask in
    float32 and float16.  The JAX forward and backward of each case run
    once, in one module-scoped fixture.
(b) the slice as a whole: a stacked 2-layer GPT of hidden 512 with two
    heads of 256, the JAX model's weights carried across by
    `convert.params_from_numpy`, three AdamW steps in both packages (the
    JAX step compiled whole by `paddle_tpu.jit.compile`): every step's
    loss, step 1's gradients, and every weight after the third step.

Limits: float32 gradients ``1e-4 max|ref|`` (the fp32 backward limit,
derived for D = 256 in `paddle_tpu_torch.ops.tolerance`); bfloat16 and
float16 the per-element backward limits of `tolerance.flash_bwd_limits`.
Training: those of ``tests/test_torch_port_train.py`` -- losses and
weights to 1e-5 absolute, weights whose gradient is rounding noise to
``2 * lr * steps`` (there the key slice of ``qkv_b``, softmax being blind
to the key bias; here also the few elements, ~0.1 % of a weight at these
widths, whose gradient is a near-cancelling sum: see the test); step 1's
gradients to 1e-5 of each weight's largest.
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
from paddle_tpu.serving import LLMEngine as JaxEngine

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM,
                                     GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tolerance as tol
from paddle_tpu_torch.optimizer import AdamW
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


B, H, S, D = 1, 2, 128, 256
BWD_REL_FP32 = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# (name, causal, mask, kv_lens, segments)
BRANCHES = {"causal": (True, False, False, False),
            "mask": (True, True, False, False),
            "kv_lens": (True, False, True, False),
            "segs": (True, False, False, True),
            "noncausal": (False, False, False, False)}
CASES = ([(name, "bfloat16") for name in BRANCHES]
         + [(name, dt) for dt in ("float32", "float16")
            for name in ("causal", "mask")])


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(name, seed=21):
    """q, k, v, dO [B, S, H, D] and the branches of a case, in numpy.  The
    mask: N(0, 2) scores, -1e30 at ~30 % of the keys, column 0 and the
    diagonal open (every row keeps a key); kv_lens S - 37; the ids a
    permutation of three documents."""
    causal, has_mask, has_lens, has_segs = BRANCHES[name]
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, S, H, D).astype(np.float32)
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
def jax_bwd():
    """{(branch, dtype): (out, lse, (dq, dk, dv))} of the JAX Pallas
    forward and backward in interpret mode, one 128-row block."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PTPU_PALLAS_INTERPRET", "1")
    runs = {}
    try:
        for name, dtype in CASES:
            jdt = DTYPES[dtype][0]
            causal, q, k, v, do, mask, lens, segs = _inputs(name)
            qf, kf, vf, dof = (jpo._fold_heads(jnp.asarray(a).astype(jdt))
                               for a in (q, k, v, do))
            kw = dict(n_heads=H,
                      mask=None if mask is None else jnp.asarray(mask),
                      kv_lens=(None if lens is None
                               else jnp.asarray(lens)[:, None]),
                      segments=None if segs is None else jnp.asarray(segs))
            of, lse = jpo._flash_fwd(qf, kf, vf, causal, D ** -0.5,
                                     block_q=128, block_k=128, **kw)
            grads = jpo._flash_bwd(qf, kf, vf, of, lse, dof, causal,
                                   D ** -0.5, block_q=128, block_k=128, **kw)
            assert of.dtype == jdt and all(g.dtype == jdt for g in grads)
            runs[name, dtype] = (jpo._unfold_heads(of, B, H), lse,
                                 tuple(jpo._unfold_heads(g, B, H)
                                       for g in grads))
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("name,dtype", CASES)
def test_plain_backward_matches_jax_kernels_d256(name, dtype, jax_bwd):
    """The port's plain backward from the JAX forward's out (and its lse,
    or the port's own (row max, log l) pair with a mask or kv_lens)
    against `_flash_bwd`'s dq, dk, dv, in the case's type."""
    tdt = DTYPES[dtype][1]
    causal, q, k, v, do, mask, lens, segs = _inputs(name)
    out, lse, want = jax_bwd[name, dtype]
    qt, kt, vt, dot = (_t(a, tdt) for a in (q, k, v, do))
    br = [None if a is None else torch.from_numpy(a)
          for a in (mask, lens, segs)]
    stat = torch.from_numpy(_np(lse).reshape(B, H, S).copy())
    row_max = None
    if mask is not None or lens is not None:
        row_max, stat = fa.softmax_stats(qt, kt, D ** -0.5, causal, *br)
    outt = _t(_np(out), tdt)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd_reference(
        qt, kt, vt, outt, stat, dot, D ** -0.5, is_causal=causal,
        mask=br[0], kv_lens=br[1], segment_ids=br[2], row_max=row_max)
    want = [_t(_np(w), tdt) for w in want]
    if tdt == torch.float32:
        limits = [BWD_REL_FP32 * w.abs().max().item() for w in want]
    else:
        limits = tol.flash_bwd_limits(got, want, qt, kt, vt, outt, stat,
                                      dot, D ** -0.5, causal=causal,
                                      mask=br[0], lens=br[1], segs=br[2],
                                      row_max=row_max)
    for which, g, w, lim in zip(("dq", "dk", "dv"), got, want, limits):
        assert g.dtype == tdt and g.shape == (B, S, H, D)
        err, ratio, ok = tol.compare(g, w, lim)
        assert ok, f"{which} {name} {dtype}: max error {err}, {ratio:.3g}x"
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("kernel", [fa.flash_bwd_dq, fa.flash_bwd_dkv])
def test_backward_wrappers_take_d256_on_the_cpu(kernel):
    """On CPU tensors both wrappers compute the plain backward at D = 256
    (bitwise) and count nothing."""
    causal, q, k, v, do, *_ = _inputs("causal", seed=5)
    qt, kt, vt, dot = (_t(a[:, :40]) for a in (q, k, v, do))
    out, lse = fa.flash_attention_arrays(qt, kt, vt, is_causal=True,
                                         return_lse=True)
    want = fa.flash_attention_bwd_reference(qt, kt, vt, out, lse, dot,
                                            D ** -0.5)
    ops.reset_launch_counts()
    got = kernel(qt, kt, vt, dot, lse, fa.attention_delta(out, dot),
                 D ** -0.5)
    got = (got,) if kernel is fa.flash_bwd_dq else got
    for g, w in zip(got, want if kernel is fa.flash_bwd_dq else want[1:]):
        assert torch.equal(g, w)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# (b) three training steps of a GPT with two heads of 256
# ---------------------------------------------------------------------------

CFG = dict(hidden_size=512, num_attention_heads=2, intermediate_size=1024,
           num_hidden_layers=2, max_position_embeddings=64, vocab_size=128)
STEPS, LR = 3, 1e-3
# the share of a weight's elements whose gradient may be rounding noise
NOISY_SHARE = 5e-3


def _jax_arrays(model):
    return {n: _np(a) for n, a in JaxEngine(model)._param_arrays().items()}


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


def test_three_training_steps_match_jax_d256():
    """Three AdamW steps of the 2 x 256 GPT in both packages (the JAX step
    compiled whole by `paddle_tpu.jit.compile`): every step's loss within
    1e-5; step 1's gradients within 1e-5 of each weight's largest; every
    weight after step 3 within 1e-5, except where a step's gradient is
    rounding noise.  Adam's normalised step turns noise of either sign
    into a step of up to ``lr``, so those elements are held to ``2 * lr *
    steps`` (`tests/test_torch_port_train.py`'s limit for the key slice
    of ``qkv_b``, all noise); an element's gradient counts as noise where
    the two packages' gradients of it differ by more than 1 % of it at
    some step (at step 1, from the same weights, the gradients agree to
    ~1e-6 of each weight's largest: those are elements whose gradient is
    a near-cancelling sum, ~1e-8 against 1e-2), at most `NOISY_SHARE` of
    a weight's elements outside the key slice."""
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(stacked_blocks=True,
                                    sequence_parallel=False, **CFG))
    jmodel.train()
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=True, **CFG),
                           device="cpu").load_params(
        params_from_numpy(_jax_arrays(jmodel), device="cpu"))
    assert model.cfg.hidden_size // model.cfg.num_attention_heads == D
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
