"""The port optimizer's telemetry against the JAX package's, on the CPU:
three Adam steps of the per-layer test GPT in both packages from the
same weights (the JAX ``state_dict``) and batch, with ``PTPU_MONITOR``
on, ``PTPU_TRAIN_STATS`` on, ``PTPU_TRAIN_STATS_EVERY=1`` and
``PTPU_GRADNORM_EVERY=1`` (the optimizer modules' ``_GRADNORM_EVERY``,
read at import, set to 1), in three cases: plain, with
``ClipGradByGlobalNorm`` below the gradient norm (the gauges read the
clipped gradients), and with ``clear_grad(set_to_zero=True)`` (which
zeroes the port's gradients in place: its gauge holds its own
reduction).  Each step's values are read after ``clear_grad``, as a
scrape between steps reads them:

- ``optimizer/grad_norm`` and each parameter's ``train/grad_norm``,
  ``train/param_norm`` and ``train/update_ratio`` within 1e-5 relative
  (fp32 sums in different orders), plus the slack of ROADMAP's rule for
  weights whose JAX gradient falls below ``GRAD_FLOOR`` = 1e-5 at some
  step ("Differences by design"; among them the key slice of
  ``qkv_proj.bias``, whose gradient is rounding noise in both packages):
  Adam's normalised step turns noise in such a gradient into a step of
  up to lr in either package, so each such weight may move 2 lr apart a
  step.  For ``n`` such weights of a parameter, its update norm may then
  differ by ``2 lr sqrt(n)`` and its norm after ``k`` steps by ``2 lr k
  sqrt(n)``, each over the parameter norm for the ratio;
- the ranking of ``report()`` (parameters by gradient norm) the same,
  the JAX parameters named by their place in its model (their optimizer
  names are process-wide unique names);
- ``optimizer/steps``, ``optimizer/lr`` and ``train/stats_step`` equal;
- with the monitor off, nothing is recorded.

The JAX runs are made once (a module fixture); the gates and both
packages' registries are restored afterwards.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.monitor as jmon
import paddle_tpu.optimizer.optimizer as jopt_mod
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.monitor import train as jtrain

import paddle_tpu_torch.monitor as tmon
import paddle_tpu_torch.optimizer.optimizer as topt_mod
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from paddle_tpu_torch.monitor import train as ttrain
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
STEPS, LR, CLIP, RTOL, GRAD_FLOOR = 3, 1e-3, 0.25, 1e-5, 1e-5
CASES = ("plain", "clip", "set_to_zero")


def _batch():
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int64)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int64)
    labels[0, :4] = -100
    return ids, labels


def _scrape(mon, train, label_of):
    """This step's telemetry, parameters by their names in the model."""
    reg = mon.get_registry()
    rows, step = train.layer_stats()
    layers = {}
    for label, gn, pn, ratio in rows:
        name = label_of[label]
        layers[name] = tuple(reg.get(g).labels(layer=label).value
                             for g in ("train/grad_norm", "train/param_norm",
                                       "train/update_ratio"))
        assert layers[name] == (gn, pn, ratio)
    ranked = [label_of[r[0]] for r in sorted(rows, key=lambda r: -r[1])]
    report = [ln.split()[0] for ln in train.report(top=1000).splitlines()[2:]]
    assert report == [label[:36] for label, *_ in
                      sorted(rows, key=lambda r: -r[1])]
    return {"grad_norm": reg.get("optimizer/grad_norm").value,
            "steps": reg.get("optimizer/steps").value,
            "lr": reg.get("optimizer/lr").value,
            "stats_step": reg.get("train/stats_step").value,
            "layers": layers, "ranked": ranked}


def _run(case, pkg):
    """Three steps in one package; a list of `_scrape`s."""
    ids, labels = _batch()
    paddle.seed(0)
    jmodel = JaxGPT(jax_test_config(sequence_parallel=False, **CFG))
    if pkg == "jax":
        mon, train, mod = jmon, jtrain, jopt
        model, params = jmodel, jmodel.parameters()
        label_of = {p.name: n for n, p in jmodel.named_parameters()}
        crit = JaxCriterion()
        ids, labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    else:
        mon, train, mod = tmon, ttrain, topt
        state = {k: np.asarray(v.numpy(), np.float32)
                 for k, v in jmodel.state_dict().items()}
        model = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
        model.load_params(params_from_numpy(state, device="cpu"))
        params = list(model.named_parameters())
        label_of = {n: n for n, _ in params}
        crit = GPTPretrainingCriterion()
        ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    mon.reset()
    train.reset()
    clip = mod.ClipGradByGlobalNorm(CLIP) if case == "clip" else None
    opt = mod.Adam(learning_rate=LR, parameters=params, grad_clip=clip)
    out, small = [], {}
    for _ in range(STEPS):
        loss = crit(model(ids), labels)
        loss.backward()
        if pkg == "jax":      # the weights under the floor so far
            for n, p in jmodel.named_parameters():
                small[n] = small.get(n, False) | (
                    np.abs(np.asarray(p.grad.numpy())) < GRAD_FLOOR)
        opt.step()
        opt.clear_grad(set_to_zero=case == "set_to_zero")
        out.append(_scrape(mon, train, label_of))
        out[-1]["small"] = {n: int(m.sum()) for n, m in small.items()}
    return out


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PTPU_TRAIN_STATS_EVERY", "1")
        gates = []
        for mon, train, mod in ((jmon, jtrain, jopt_mod),
                                (tmon, ttrain, topt_mod)):
            gates.append((mon, train, mon.enabled(), train.enabled()))
            mp.setattr(mod, "_GRADNORM_EVERY", 1)
            mon.enable(True)
            train.enable(True)
        try:
            yield {case: {pkg: _run(case, pkg) for pkg in ("jax", "port")}
                   for case in CASES}
        finally:
            for mon, train, on, ton in gates:
                mon.enable(on)
                train.enable(ton)
                mon.reset()
                train.reset()


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("case", CASES)
def test_grad_norm_gauge_matches_jax(runs, case):
    for step, (j, t) in enumerate(zip(runs[case]["jax"],
                                      runs[case]["port"])):
        assert j["grad_norm"] > 0
        assert _rel(t["grad_norm"], j["grad_norm"]) < RTOL, step
    if case == "clip":     # every step clipped: the gauge reads CLIP
        for rec in runs[case]["port"]:
            assert _rel(rec["grad_norm"], CLIP) < 1e-6


@pytest.mark.parametrize("case", CASES)
def test_layer_gauges_match_jax(runs, case):
    for step, (j, t) in enumerate(zip(runs[case]["jax"],
                                      runs[case]["port"])):
        assert set(t["layers"]) == set(j["layers"])
        for name, (gn, pn, ratio) in j["layers"].items():
            slack = 2 * LR * np.sqrt(j["small"][name])
            got = t["layers"][name]
            limits = (RTOL * gn, RTOL * pn + step * slack,
                      RTOL * ratio + (slack / pn if pn > 0 else 0.0))
            for what, g, w, lim in zip(("grad", "param", "update_ratio"),
                                       got, (gn, pn, ratio), limits):
                assert abs(g - w) <= lim, (step, name, what, g, w, lim)


@pytest.mark.parametrize("case", CASES)
def test_report_ranking_matches_jax(runs, case):
    for j, t in zip(runs[case]["jax"], runs[case]["port"]):
        assert t["ranked"] == j["ranked"]


@pytest.mark.parametrize("case", CASES)
def test_step_counter_and_lr_match_jax(runs, case):
    for i, (j, t) in enumerate(zip(runs[case]["jax"], runs[case]["port"])):
        assert t["steps"] == j["steps"] == i + 1
        assert t["lr"] == j["lr"] == pytest.approx(LR)
        assert t["stats_step"] == j["stats_step"] == i + 1


def test_nothing_recorded_with_the_monitor_off(monkeypatch):
    """Gates off: no counter, no gauge, no table, and the step's result
    is unchanged."""
    monkeypatch.setattr(topt_mod, "_GRADNORM_EVERY", 1)
    on, ton = tmon.enabled(), ttrain.enabled()
    tmon.enable(False)
    ttrain.enable(False)
    try:
        tmon.reset()
        ttrain.reset()
        w = torch.nn.Parameter(torch.ones(4))
        opt = topt.Adam(learning_rate=0.1, parameters=[w])
        (w * w).sum().backward()
        opt.step()
        assert tmon.snapshot().get("optimizer/steps", 0.0) == 0.0
        assert ttrain.layer_stats() == ([], None)
        assert torch.allclose(w.detach(), torch.full((4,), 0.9))
    finally:
        tmon.enable(on)
        ttrain.enable(ton)
        tmon.reset()
        ttrain.reset()
