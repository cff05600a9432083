"""paddle_tpu_torch's pretraining recipe (clip, schedule, decoupled decay
without biases and LayerNorms, dropout, recompute) against the JAX package
on the test GPT, on the CPU.

The same numpy inputs, made from a seed, go through both packages; the
weights are carried by the JAX ``state_dict`` (per-layer) or the JAX
engine's stacked arrays.  The recipe is GPT-3's: ``AdamW(beta2=0.95,
weight_decay=0.1, apply_decay_param_fun=<no decay for biases and
LayerNorms>, grad_clip=ClipGradByGlobalNorm(CLIP))`` under
``LinearWarmup(CosineAnnealingDecay(LR, 10, eta_min=LR / 10), 2, 0,
LR)``; ``CLIP`` is below the test GPT's gradient norm, so the clip
scales every step.  Each JAX run is made once per module (a fixture) and
shared.

- both layouts, three steps: losses within 1e-5, weights within 1e-5 but
  for those whose JAX gradient falls below ``GRAD_FLOOR`` at some step,
  held to ``2 * LR * STEPS`` (Adam's normalised step turns fp32 noise in
  a tiny gradient into a step of up to lr; `test_torch_port_ln_train.py`);
- the stacked layout with ``recompute=True`` against JAX's (the same
  limits), and bitwise against the port's own run without it: losses,
  step-1 gradients and weights;
- dropout on the per-layer layout (0.1 at every site) with the same keep
  masks in both packages: ``jax.random.bernoulli`` is patched to return a
  numpy mask looked up by its key (JAX's lazy pullback runs the forward
  again with the same key), and the port's `_keep_mask` returns the same
  masks in the order JAX first drew them; three steps within the limits
  above; p = 0 and eval mode bitwise equal to no dropout; the kept
  fraction near 1 - p;
- the stacked layout refuses dropout with JAX's message; the per-layer
  layout ignores ``recompute``, as JAX's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.serving import LLMEngine as JaxEngine

import paddle_tpu_torch
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy, params_to_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)

CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
STEPS, LR, CLIP, GRAD_FLOOR = 3, 1e-3, 0.25, 1e-5
DROP = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _no_decay(name):
    """Biases and LayerNorms, by the port's parameter names (the JAX
    model's structured names give the same answers)."""
    return "ln" in name or name.endswith(("bias", "_b"))


def _schedule(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, 10, eta_min=LR / 10),
                            2, 0.0, LR)


def _recipe(mod, params, fun):
    return mod.AdamW(learning_rate=_schedule(mod.lr), beta2=0.95,
                     weight_decay=0.1, apply_decay_param_fun=fun,
                     grad_clip=mod.ClipGradByGlobalNorm(CLIP),
                     parameters=params)


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels[1, :3] = -100
    return ids, labels


def _jax_model(stacked, **kw):
    paddle.seed(0)
    return JaxGPT(jax_test_config(sequence_parallel=False,
                                  stacked_blocks=stacked, **CFG, **kw))


def _jax_arrays(jmodel, stacked):
    if stacked:
        return {n: _np(a) for n, a in JaxEngine(jmodel)._param_arrays()
                .items()}
    return {k: _np(v.numpy()) for k, v in jmodel.state_dict().items()}


def _port_model(arrays, stacked, **kw):
    model = GPTForCausalLM(gpt_test_config(stacked_blocks=stacked, **CFG,
                                           **kw), device="cpu")
    return model.load_params(params_from_numpy(arrays, device="cpu"))


# the JAX stacked model's parameter names that are not its blocks', by
# the engine's (and the port's) names
ENGINE_NAMES = {"gpt.embeddings.word_embeddings.weight": "wte",
                "gpt.embeddings.position_embeddings.weight": "wpe",
                "gpt.ln_f.weight": "lnf_w", "gpt.ln_f.bias": "lnf_b"}


def _jax_run(stacked, **kw):
    """Three recipe steps of the JAX test GPT: its initial and final
    arrays, losses, the weights whose gradient fell below the floor, and
    the global gradient norms."""
    jmodel = _jax_model(stacked, **kw)
    jmodel.train()
    init = _jax_arrays(jmodel, stacked)
    structured = {p.name: n for n, p in jmodel.named_parameters()}
    opt = _recipe(jopt, jmodel.parameters(),
                  lambda pname: not _no_decay(structured[pname]))
    ids, labels = _batch()
    crit = JaxCriterion()
    losses, small, norms = [], {}, []
    for _ in range(STEPS):
        loss = crit(jmodel(paddle.to_tensor(ids)), paddle.to_tensor(labels))
        loss.backward()
        grads = {n: _np(p.grad.numpy()) for n, p in jmodel.named_parameters()}
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                       for g in grads.values()))))
        for n, g in grads.items():
            small[n] = small.get(n, False) | (np.abs(g) < GRAD_FLOOR)
        opt.step()
        opt.clear_grad()
        opt._lr_scheduler.step()
        losses.append(float(loss.numpy()))
    final = _jax_arrays(jmodel, stacked)
    if stacked:     # the floor masks by the port's (engine) names
        small = {ENGINE_NAMES.get(n, n.rsplit(".", 1)[-1]): m
                 for n, m in small.items()}
    return dict(init=init, final=final, losses=losses, small=small,
                norms=norms)


def _port_run(arrays, stacked, grads=None, **kw):
    model = _port_model(arrays, stacked, **kw)
    opt = _recipe(topt, model.named_parameters(),
                  lambda name: not _no_decay(name))
    ids, labels = (torch.from_numpy(a) for a in _batch())
    crit = GPTPretrainingCriterion()
    losses = []
    for step in range(STEPS):
        loss = crit(model(ids), labels)
        loss.backward()
        if grads is not None and step == 0:
            grads.update({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        opt._lr_scheduler.step()
        losses.append(loss.item())
    return model, losses


def _check_against(run, model, losses):
    np.testing.assert_allclose(losses, run["losses"], atol=1e-5, rtol=0)
    got, want = params_to_numpy(model), run["final"]
    assert set(got) == set(want)
    for name in sorted(want):
        g, w = got[name], want[name]
        s = run["small"].get(name, np.zeros(w.shape, bool))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[s], w[s], atol=2 * LR * STEPS, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(g[~s], w[~s], atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def per_layer_run():
    return _jax_run(False)


@pytest.fixture(scope="module")
def stacked_recompute_run():
    return _jax_run(True, recompute=True)


def test_recipe_clips_every_step(per_layer_run):
    assert min(per_layer_run["norms"]) > CLIP
    assert per_layer_run["losses"][-1] < per_layer_run["losses"][0]


def test_per_layer_recipe_matches_jax(per_layer_run):
    model, losses = _port_run(per_layer_run["init"], False)
    _check_against(per_layer_run, model, losses)


def test_per_layer_ignores_recompute(per_layer_run):
    """The JAX per-layer layout ignores ``recompute``; so does the
    port's: bitwise the run without it."""
    a, la = _port_run(per_layer_run["init"], False)
    b, lb = _port_run(per_layer_run["init"], False, recompute=True)
    assert la == lb
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_stacked_recompute_recipe_matches_jax(stacked_recompute_run):
    model, losses = _port_run(stacked_recompute_run["init"], True,
                              recompute=True)
    _check_against(stacked_recompute_run, model, losses)


def test_stacked_recompute_is_bitwise_no_recompute(stacked_recompute_run):
    ga, gb = {}, {}
    a, la = _port_run(stacked_recompute_run["init"], True, ga,
                      recompute=True)
    b, lb = _port_run(stacked_recompute_run["init"], True, gb)
    assert a.cfg.recompute and not b.cfg.recompute
    assert la == lb
    assert set(ga) == set(gb) and len(ga) == 16
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_stacked_recipe_without_recompute_matches_jax(
        stacked_recompute_run):
    """JAX's stacked run with recompute against the port's without: the
    same function."""
    model, losses = _port_run(stacked_recompute_run["init"], True)
    _check_against(stacked_recompute_run, model, losses)


# ---------------------------------------------------------------------------
# dropout with shared masks
# ---------------------------------------------------------------------------

class _SharedMasks:
    """``jax.random.bernoulli`` returning a numpy mask looked up by its key
    (drawn from a RandomState seeded by the key at first sight), and
    `keep_mask`, for the port's `_keep_mask`, returning those masks in the
    order JAX first drew them."""

    def __init__(self):
        self.by_key, self.order, self.cursor = {}, [], 0

    def bernoulli(self, key, p, shape):
        k = tuple(np.asarray(key).ravel().tolist())
        if k not in self.by_key:
            seed = (k[0] * 1000003 + k[-1]) % (2 ** 31)
            m = np.random.RandomState(seed).rand(*shape) < p
            self.by_key[k] = m
            self.order.append((m, p))
        assert self.by_key[k].shape == tuple(shape)
        return jnp.asarray(self.by_key[k])

    def keep_mask(self, shape, keep, device, generator=None):
        m, p = self.order[self.cursor]
        self.cursor += 1
        assert m.shape == tuple(shape) and abs(p - keep) < 1e-12
        return torch.from_numpy(m).to(device)


@pytest.fixture(scope="module")
def dropout_run():
    masks = _SharedMasks()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", masks.bernoulli)
        run = _jax_run(False, **DROP)
    run["masks"] = masks
    return run


def test_dropout_recipe_with_shared_masks_matches_jax(dropout_run,
                                                      monkeypatch):
    masks = dropout_run["masks"]
    layers = gpt_test_config().num_hidden_layers
    # per step: the embeddings, then per block the flash output, the
    # attention output and the MLP output
    assert len(masks.order) == STEPS * (1 + 3 * layers)
    kept = np.mean([m.mean() for m, _ in masks.order])
    assert abs(kept - 0.9) < 0.01
    masks.cursor = 0
    monkeypatch.setattr(PF, "_keep_mask", masks.keep_mask)
    model, losses = _port_run(dropout_run["init"], False, **DROP)
    assert masks.cursor == len(masks.order)
    _check_against(dropout_run, model, losses)


def test_dropout_zero_and_eval_are_bitwise_no_dropout(per_layer_run):
    ids = torch.from_numpy(_batch()[0])
    plain = _port_model(per_layer_run["init"], False)
    zero = _port_model(per_layer_run["init"], False,
                       hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    drop = _port_model(per_layer_run["init"], False, **DROP)
    drop.eval()
    want = plain(ids)
    assert torch.equal(zero(ids), want)
    assert torch.equal(drop(ids), want)
    drop.train()
    assert not torch.equal(drop(ids), want)


def test_dropout_function_semantics():
    torch.manual_seed(0)
    x = torch.ones(400, 500)
    y = PF.dropout(x, 0.1)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 5 * (0.9 * 0.1 / x.numel()) ** 0.5
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    y = PF.dropout(x, 0.3, mode="downscale_in_infer")
    assert set(y.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(PF.dropout(x, 0.3, training=False,
                                  mode="downscale_in_infer"), x * 0.7)
    assert PF.dropout(x, 0.3, training=False) is x
    assert PF.dropout(x, 0.0) is x
    # axis: one decision per row, shared along the columns
    y = PF.dropout(x, 0.5, axis=0)
    rows = (y != 0).float()
    assert torch.equal(rows.min(1).values, rows.max(1).values)
    g = torch.Generator().manual_seed(3)
    a = PF.dropout(x, 0.2, generator=g)
    g.manual_seed(3)
    assert torch.equal(PF.dropout(x, 0.2, generator=g), a)


def test_stacked_dropout_raises_jax_message():
    with pytest.raises(ValueError, match="does not support dropout") as want:
        _jax_model(True, hidden_dropout_prob=0.1)
    with pytest.raises(ValueError) as got:
        GPTForCausalLM(gpt_test_config(stacked_blocks=True,
                                       attention_dropout_prob=0.1),
                       device="cpu")
    assert str(got.value) == str(want.value)


def test_recompute_functions_match_plain_autograd():
    """`recompute` and `recompute_sequential` give the outputs and
    gradients of running the functions plainly (keyword arguments pass
    through), and a dropout inside draws the same mask again in the
    backward (the default generator's state is put back)."""
    from paddle_tpu_torch.distributed.fleet.utils import (
        recompute, recompute_sequential)
    torch.manual_seed(0)
    w = [torch.randn(8, 8, requires_grad=True) for _ in range(4)]
    x = torch.randn(3, 8, requires_grad=True)
    fns = [lambda h, w=w_: torch.tanh(h @ w) for w_ in w]

    def plain():
        h = x
        for f in fns:
            h = f(h)
        return h
    want = plain()
    gw = torch.autograd.grad(want.sum(), [x, *w])
    for segments in (1, 2, 4):
        got = recompute_sequential({"segments": segments}, fns, x)
        assert torch.equal(got, want)
        for a, b in zip(torch.autograd.grad(got.sum(), [x, *w]), gw):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)
    got = recompute(lambda h, scale=1.0: fns[0](h) * scale, x, scale=2.0,
                    use_reentrant=True)
    assert torch.equal(got, 2.0 * fns[0](x))

    def drop(h):
        return PF.dropout(h @ w[0], 0.5)
    # dropout draws on the port's key stack (JAX's keys), which
    # `recompute` puts back for the backward's second run
    paddle_tpu_torch.seed(3)
    ref = drop(x)
    (gref,) = torch.autograd.grad(ref.sum(), [w[0]])
    paddle_tpu_torch.seed(3)
    out = recompute(drop, x)
    assert torch.equal(out, ref)
    (g,) = torch.autograd.grad(out.sum(), [w[0]])
    assert torch.equal(g, gref)
