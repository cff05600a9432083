"""paddle_tpu_torch's LR schedulers, gradient clipping and optimizer families
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages.

- every scheduler (all sixteen): its 50-step value sequence equal to
  JAX's, bitwise (both are the same host arithmetic in Python floats); its
  ``state_dict`` after 20 steps equal to JAX's, and a fresh scheduler
  loaded from it continuing as JAX's does;
- the three clip classes on the same gradients, float32 and bfloat16:
  float32 within 1e-6 of each JAX output's largest magnitude (the norms
  are fp32 sums in different orders); bfloat16 within one bf16 step of
  each JAX element (a scale that differs in its last fp32 bit may round an
  element to the neighbouring bf16 value);
- three steps of each optimizer family (with its options that change the
  arithmetic: Nesterov, centred RMSProp, coupled and decoupled decay, a
  clip, a scheduler) in float32: parameters and every slot within 1e-6 of
  each JAX tensor's largest magnitude.  Per element the relative
  difference may be larger where a slot cancels to near zero (a momentum
  of 3e-5 beside values of 0.07 differs by 1e-9 there);
- ``apply_decay_param_fun``, given the parameter's name;
- the ``state_dict`` keys (``<name>.<slot>``, ``.master_weight``,
  ``LR_Scheduler``, ``@step``) equal to JAX's for parameters of the same
  names, and their values;
- two steps, save, load into a fresh optimizer, one step: bitwise the
  three steps of one optimizer, for every family;
- the clip and update a group of tensors at a time (`clip.chunks`):
  groups of one tensor bitwise one group of all, for every family.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import clip as tclip
from paddle_tpu_torch.optimizer import lr as tlr
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


SHAPES = [(5, 3), (4,), (2, 3, 2)]
NAMES = ["w0", "b0", "w1"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

def _warmup(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(6e-4, 30, eta_min=6e-5),
                            8, 0.0, 6e-4)


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 10, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20], [1.0, 0.5, 0.1]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 20, 0.01, 2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(0.5, 20, 0.01, 2.0,
                                                         cycle=True),
    "LinearWarmup": _warmup,
    "LinearWarmup_number": lambda m: m.LinearWarmup(0.3, 10, 0.0, 0.3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [10, 25, 40], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.5, 7, 0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.5, patience=2,
                                                   cooldown=1),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 13,
                                                             eta_min=0.01),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.5,
                                                           lambda e: 0.97),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 40),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(0.1, 40,
                                                anneal_strategy="linear",
                                                three_phase=True),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, 6),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(0.01, 0.1, 5, 3,
                                                 mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(0.01, 0.1, 5,
                                               mode="exp_range",
                                               exp_gamma=0.98),
}
# ReduceOnPlateau's metric: falls, then stalls
METRICS = [10.0 - min(i, 12) * 0.5 + 0.01 * (i % 3) for i in range(80)]


def _advance(s, n, start=0):
    out = []
    for i in range(start, start + n):
        out.append(s())
        if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            s.step(METRICS[i])
        else:
            s.step()
    return out


def test_every_scheduler_is_covered():
    assert set(tlr.__all__) == set(jlr.__all__)
    kinds = {name.split("_")[0] for name in SCHEDULERS}
    assert kinds == set(tlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    make = SCHEDULERS[name]
    want = _advance(make(jlr), 50)
    got = _advance(make(tlr), 50)
    assert got == want
    assert len(set(got)) > 1 or name == "ReduceOnPlateau"


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_state_round_trip_matches_jax(name):
    make = SCHEDULERS[name]
    js, ts = make(jlr), make(tlr)
    _advance(js, 20)
    _advance(ts, 20)
    jstate, tstate = js.state_dict(), ts.state_dict()
    assert tstate == jstate
    jfresh, tfresh = make(jlr), make(tlr)
    jfresh.set_state_dict(jstate)
    tfresh.set_state_dict(tstate)
    assert _advance(tfresh, 10, 20) == _advance(jfresh, 10, 20)


def test_optimizer_reads_the_scheduler():
    p = torch.nn.Parameter(torch.ones(2))
    sched = tlr.StepDecay(0.5, 2, 0.5)
    opt = topt.SGD(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5 and opt._lr_scheduler is sched
    sched.step()
    sched.step()
    assert opt.get_lr() == 0.25
    opt.set_lr_scheduler(tlr.ExponentialDecay(0.1, 0.5))
    assert opt.get_lr() == pytest.approx(0.1)
    opt.set_lr(0.3)
    assert opt.get_lr() == 0.3 and opt._lr_scheduler is None
    loss = (p * p).sum()
    opt.minimize(loss)
    np.testing.assert_allclose(p.detach().numpy(), [1 - 0.3 * 2] * 2,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------------

def _grads(seed, scale):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32) for s in SHAPES]


CLIPS = {"value": ("ClipGradByValue", (0.5,)),
         "value_min": ("ClipGradByValue", (0.5, -0.2)),
         "norm": ("ClipGradByNorm", (1.0,)),
         "global_norm": ("ClipGradByGlobalNorm", (1.0,)),
         "global_norm_above": ("ClipGradByGlobalNorm", (1e3,))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_matches_jax(kind, dtype):
    cls, args = CLIPS[kind]
    grads = _grads(3, 2.0)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = getattr(jopt, cls)(*args).apply(
        [jnp.asarray(g, jdt) for g in grads])
    tin = [torch.from_numpy(g).to(tdt) for g in grads]
    before = [t.clone() for t in tin]
    got = getattr(topt, cls)(*args).apply(tin)
    for t, b in zip(tin, before):
        assert torch.equal(t, b)                # the inputs are untouched
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        wf, gf = _np(w), g.float().numpy()
        if dtype == "float32":
            limit = 1e-6 * np.abs(wf).max()
        else:
            limit = 2.0 ** -8 * np.abs(wf)
        assert np.all(np.abs(gf - wf) <= limit), kind


def test_global_norm_clip_scales_every_gradient_alike():
    grads = [torch.from_numpy(g) for g in _grads(4, 3.0)]
    clip = topt.ClipGradByGlobalNorm(1.0)
    norm = clip.global_norm(grads).item()
    assert norm > 1.0
    out = clip.apply(grads)
    assert clip.global_norm(out).item() == pytest.approx(1.0, rel=1e-6)
    for g, o in zip(grads, out):
        np.testing.assert_allclose(o.numpy(), g.numpy() / norm, rtol=1e-6)
    with pytest.raises(TypeError, match="ClipGradBase"):
        topt.SGD(parameters=[torch.nn.Parameter(torch.ones(1))],
                 grad_clip=1.0)


# ---------------------------------------------------------------------------
# optimizer families
# ---------------------------------------------------------------------------

FAMILIES = {
    "SGD": ("SGD", {}),
    "SGD_l2": ("SGD", dict(weight_decay=0.01)),
    "Momentum": ("Momentum", {}),
    "Momentum_nesterov": ("Momentum", dict(use_nesterov=True,
                                           weight_decay=0.01)),
    "Adam": ("Adam", {}),
    "AdamW": ("AdamW", dict(weight_decay=0.1)),
    "Adamax": ("Adamax", {}),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
    "Adadelta": ("Adadelta", {}),
    "RMSProp": ("RMSProp", dict(momentum=0.9)),
    "RMSProp_centered": ("RMSProp", dict(centered=True, momentum=0.5)),
    "Lamb": ("Lamb", {}),
    "Lars": ("Lars", {}),
}


def _pair(family, seed=7, lr=1e-2, names=None, clip=None, sched=None,
          tdtype=torch.float32, **extra):
    """A JAX and a port optimizer of ``family`` over the same parameters
    (named ``names``), and their parameter lists."""
    cls, kw = FAMILIES[family]
    kw = dict(kw, **extra)
    rng = np.random.RandomState(seed)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    jdt = jnp.bfloat16 if tdtype == torch.bfloat16 else jnp.float32
    jp = [jnn.Parameter(jnp.asarray(a, jdt),
                        name=None if names is None else names[i])
          for i, a in enumerate(init)]
    tp = [torch.nn.Parameter(torch.from_numpy(a).to(tdtype)) for a in init]
    tparams = tp if names is None else list(zip(names, tp))
    jkw, tkw = dict(kw), dict(kw)
    if clip is not None:
        jkw["grad_clip"] = getattr(jopt, clip[0])(*clip[1])
        tkw["grad_clip"] = getattr(topt, clip[0])(*clip[1])
    jlr_, tlr_ = (lr, lr) if sched is None else (sched(jlr), sched(tlr))
    jo = getattr(jopt, cls)(learning_rate=jlr_, parameters=jp, **jkw)
    to = getattr(topt, cls)(learning_rate=tlr_, parameters=tparams, **tkw)
    return jo, to, jp, tp


def _steps(jo, to, jp, tp, n, seed=11, scale=1.0):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        for a, b, s in zip(jp, tp, SHAPES):
            g = (scale * rng.randn(*s)).astype(np.float32)
            a.grad = Tensor(jnp.asarray(g, a._data.dtype))
            b.grad = torch.from_numpy(g).to(b.dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        for o in (jo, to):
            if o._lr_scheduler is not None:
                o._lr_scheduler.step()


def _close(got, want, what):
    want = _np(want)
    got = got.detach().float().numpy()
    limit = 1e-6 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), (what, np.abs(got - want)
                                                 .max(), limit)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_three_steps_match_jax(family):
    jo, to, jp, tp = _pair(family)
    _steps(jo, to, jp, tp, 3)
    assert to._step_count == jo._step_count == 3
    for i, (a, b) in enumerate(zip(jp, tp)):
        _close(b, a._data, f"{family} param {i}")
        js, ts = jo._states[id(a)], to._states[id(b)]
        assert set(ts) == set(js), family
        for slot in js:
            _close(ts[slot], js[slot], f"{family} {slot} {i}")
        assert b.grad is None


@pytest.mark.parametrize("family", ["AdamW", "Momentum", "Lamb"])
def test_family_with_clip_and_schedule_matches_jax(family):
    """The recipe's pieces together: a global-norm clip that scales (the
    gradients' norm is ~6) and a warmup-cosine schedule."""
    jo, to, jp, tp = _pair(family, clip=("ClipGradByGlobalNorm", (1.0,)),
                           sched=_warmup)
    _steps(jo, to, jp, tp, 3, scale=2.0)
    assert to.get_lr() == jo.get_lr() > 0
    for i, (a, b) in enumerate(zip(jp, tp)):
        _close(b, a._data, f"{family} param {i}")


def test_apply_decay_param_fun_matches_jax():
    def fun(name):
        return not name.startswith("b")
    seen = []

    def spy(name):
        seen.append(name)
        return fun(name)
    jo, to, jp, tp = _pair("AdamW", names=NAMES, apply_decay_param_fun=fun)
    to._apply_decay_param_fun = spy
    _steps(jo, to, jp, tp, 2)
    assert sorted(set(seen)) == sorted(NAMES)
    for i, (a, b) in enumerate(zip(jp, tp)):
        _close(b, a._data, f"param {i}")
    # the bias got no decay: the same steps without any decay agree on it
    jo2, to2, jp2, tp2 = _pair("AdamW", names=NAMES, weight_decay=0.0)
    _steps(jo2, to2, jp2, tp2, 2)
    assert torch.equal(tp[1], tp2[1])
    assert not torch.equal(tp[0], tp2[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_dict_keys_and_values_match_jax(dtype):
    jo, to, jp, tp = _pair("AdamW", names=NAMES, sched=_warmup, tdtype=dtype)
    _steps(jo, to, jp, tp, 2)
    want, got = jo.state_dict(), to.state_dict()
    assert set(got) == set(want)
    masters = {f"{n}.master_weight" for n in NAMES}
    assert masters <= set(got) if dtype == torch.bfloat16 \
        else not masters & set(got)
    assert got["@step"] == want["@step"] == 2
    assert got["LR_Scheduler"] == want["LR_Scheduler"]
    for k in want:
        if k not in ("@step", "LR_Scheduler"):
            _close(got[k], want[k]._data, k)
    # unnamed parameters are param_<i>, in both packages
    jo, to, jp, tp = _pair("Momentum")
    _steps(jo, to, jp, tp, 1)
    assert set(to.state_dict()) == set(jo.state_dict())
    assert "param_2.velocity" in to.state_dict()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_save_load_resumes_bitwise(family):
    """Two steps, ``state_dict``, a fresh optimizer (and parameters) loaded
    from it, one step: bitwise the three steps of one optimizer.  bf16
    parameters with fp32 masters, a clip and a scheduler whose state
    round-trips."""
    def make():
        _, to, _, tp = _pair(family, names=NAMES, tdtype=torch.bfloat16,
                             clip=("ClipGradByGlobalNorm", (1.0,)),
                             sched=lambda m: m.CosineAnnealingDecay(1e-2, 5))
        return to, tp

    def grads(n, seed=11):
        rng = np.random.RandomState(seed)
        return [[torch.from_numpy(rng.randn(*s).astype(np.float32))
                 .bfloat16() for s in SHAPES] for _ in range(n)]

    def run(opt, params, gs):
        for step in gs:
            for p, g in zip(params, step):
                p.grad = g.clone()
            opt.step()
            opt.clear_grad()
            opt._lr_scheduler.step()

    gs = grads(3)
    whole, wp = make()
    run(whole, wp, gs)
    first, fp = make()
    run(first, fp, gs[:2])
    saved = first.state_dict()
    resumed, rp = make()
    with torch.no_grad():
        for a, b in zip(rp, fp):
            a.copy_(b)
    resumed.set_state_dict(saved)
    assert resumed._step_count == 2
    run(resumed, rp, gs[2:])
    for a, b in zip(rp, wp):
        assert torch.equal(a, b), family
    sw, sr = whole.state_dict(), resumed.state_dict()
    assert set(sw) == set(sr)
    for k in sw:
        if isinstance(sw[k], torch.Tensor):
            assert torch.equal(sw[k], sr[k]), (family, k)
        else:
            assert sw[k] == sr[k], k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_groups_of_tensors_update_bitwise_as_one(family, monkeypatch):
    """The clip and the update go a group of tensors at a time
    (`clip.chunks`, to bound their temporaries); groups of one tensor
    give the bits of one group of all."""
    def run(limit):
        monkeypatch.setattr(tclip, "CHUNK_ELEMS", limit)
        _, to, _, tp = _pair(family, tdtype=torch.bfloat16,
                             clip=("ClipGradByGlobalNorm", (1.0,)))
        rng = np.random.RandomState(5)
        for _ in range(2):
            for p, s in zip(tp, SHAPES):
                p.grad = torch.from_numpy(
                    rng.randn(*s).astype(np.float32)).bfloat16()
            to.step()
        return tp, to
    one, opt_one = run(1 << 27)
    each, opt_each = run(1)
    assert [list(tclip.chunks(one, n)) for n in (1, 1 << 27)] == [
        [(0, 1), (1, 2), (2, 3)], [(0, 3)]]
    for a, b in zip(one, each):
        assert torch.equal(a, b), family
    for k, v in opt_one.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, opt_each.state_dict()[k]), k


def test_state_dict_is_a_snapshot():
    _, to, _, tp = _pair("Adam", names=NAMES)
    for p in tp:
        p.grad = torch.ones_like(p)
    to.step()
    saved = to.state_dict()
    m = saved["w0.moment1"].clone()
    to.step()
    assert torch.equal(saved["w0.moment1"], m)
    assert not torch.equal(to.state_dict()["w0.moment1"], m)
    assert math.isclose(float(m.flatten()[0]), 0.1, rel_tol=1e-6)
