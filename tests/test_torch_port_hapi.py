"""paddle_tpu_torch's high-level API and the modules under it (``io``,
``metric``, ``framework.io_``, ``hapi``) against the JAX package, on the
CPU.

- ``io``: each sampler and ``DataLoader`` (``num_workers`` 0 and 2, the
  thread path) yields the same indices and batches as the JAX package's
  under the same ``np.random.seed``, for ``TensorDataset``, ``Subset``,
  ``random_split``, ``ConcatDataset``, ``ComposeDataset``,
  ``ChainDataset`` and dict samples; float64 arrives as float32, integer
  ids keep their type (JAX's without x64 are int32);
- ``metric``: ``Accuracy`` (top-1 and top-3, and on ``[B, S, V]``
  logits, where it counts ``B`` examples but sums hits over every
  position, so it exceeds 1 as JAX's does), ``Precision``, ``Recall``,
  ``Auc`` and ``accuracy`` equal to JAX's on the same inputs;
- ``save`` / ``load``: a file written by either package loads in the
  other bit for bit (float32, bf16 as its bits, int, tuples, lists,
  nested dicts, Python values); ``load(return_numpy=True)`` of a bf16
  leaf is float32 values in the port (ROADMAP, "Differences by design");
- ``Model`` end to end: the per-layer test GPT in both packages from the
  same weights, ``prepare(Adam on a StepDecay schedule,
  GPTPretrainingCriterion(), Accuracy())``, ``fit`` on the same
  ``TensorDataset`` (3 batches of 4 rows, ``shuffle=True`` under one
  ``np.random.seed``) with ``eval_data``, ``save_dir``, ``VisualDL`` and
  ``EarlyStopping(patience=0, min_delta=10)`` over 3 epochs: the same
  history within 1e-5 (losses, the metric, eval), stopped after the
  same epoch; the same checkpoint files, learning rate and scheduler
  state, the same TSV tags and steps; each package's final checkpoint
  loads into the other's ``Model``, whose ``predict`` then agrees with
  the saving model's within 1e-5; ``evaluate`` agrees; ``summary()``
  totals equal; ``prepare(jit_compile=True)`` raises in the port.

The JAX ``fit`` runs once, in a module fixture.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import optimizer as jopt
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_test_config as jax_test_config
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_test_config)
from _torch_port_util import one_torch_thread  # noqa: F401 (autouse)


CFG = dict(hidden_size=128, num_attention_heads=4, intermediate_size=256,
           max_position_embeddings=64, vocab_size=128)
SEED, LR = 3, 1e-3


def _np(x):
    """A batch leaf of either package as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _tree(b):
    if isinstance(b, (list, tuple)):
        return [_tree(x) for x in b]
    if isinstance(b, dict):
        return {k: _tree(v) for k, v in b.items()}
    return _np(b)


def _same_batches(jbatches, tbatches):
    assert len(jbatches) == len(tbatches)
    for j, t in zip(jbatches, tbatches):
        _equal(_tree(j), _tree(t))


def _equal(j, t):
    if isinstance(j, list):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _equal(a, b)
    elif isinstance(j, dict):
        assert set(j) == set(t)
        for k in j:
            _equal(j[k], t[k])
    else:
        np.testing.assert_array_equal(t, j)
        # JAX without x64 holds ids as int32; the port keeps int64
        assert t.dtype == j.dtype or (j.dtype == np.int32
                                      and t.dtype == np.int64)


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

ROWS = np.arange(40, dtype=np.float64).reshape(10, 4) / 7.0
IDS = np.arange(10, dtype=np.int64) * 3


class _Dicts:
    def __init__(self, io):
        self.io = io

    def __len__(self):
        return 7

    def __getitem__(self, i):
        return {"x": ROWS[i], "n": int(i), "pair": (IDS[i], float(i) / 3)}


class _Stream:
    """An iterable dataset of 11 rows, subclassing each package's own."""

    @staticmethod
    def make(io):
        class S(io.IterableDataset):
            def __iter__(self):
                for i in range(11):
                    yield ROWS[i % 10], IDS[i % 10]
        return S()


def _loaders(io, workers):
    ds = io.TensorDataset([ROWS, IDS])
    np.random.seed(SEED)
    parts = io.random_split(ds, [6, 4])
    kw = dict(num_workers=workers, use_shared_memory=False)
    return [
        io.DataLoader(ds, batch_size=3, shuffle=True, **kw),
        io.DataLoader(ds, batch_size=4, shuffle=False, drop_last=True, **kw),
        io.DataLoader(parts[0], batch_size=4, shuffle=True, **kw),
        io.DataLoader(io.ConcatDataset([parts[1], ds]), batch_size=5,
                      shuffle=True, **kw),
        io.DataLoader(io.ComposeDataset([ds, io.Subset(ds, [9, 8, 7, 1])]),
                      batch_size=2, **kw),
        io.DataLoader(_Dicts(io), batch_size=3, shuffle=True, **kw),
        io.DataLoader(_Stream.make(io), batch_size=4, **kw),
        io.DataLoader(io.ChainDataset([_Stream.make(io)] * 2),
                      batch_size=5, drop_last=True, **kw),
        io.DataLoader(ds, batch_sampler=io.BatchSampler(
            sampler=io.RandomSampler(ds, replacement=True, num_samples=7),
            batch_size=3), **kw),
        io.DataLoader(ds, batch_sampler=io.BatchSampler(
            sampler=io.WeightedRandomSampler(np.arange(1.0, 11.0), 9),
            batch_size=4), **kw),
    ]


@pytest.mark.parametrize("workers", [0, 2])
def test_data_loaders_match_jax(workers):
    out = {}
    for name, io in (("jax", jio), ("port", tio)):
        loaders = _loaders(io, workers)
        np.random.seed(SEED + 1)
        out[name] = [list(ld) for ld in loaders]
        lens = []
        for ld in loaders:
            try:
                lens.append(len(ld))
            except TypeError:
                lens.append(None)
        out[name + "_len"] = lens
    assert out["port_len"] == out["jax_len"]
    for jb, tb in zip(out["jax"], out["port"]):
        _same_batches(jb, tb)
    first = out["port"][0][0]
    assert first[0].dtype == torch.float32 and first[1].dtype == torch.int64


def test_samplers_match_jax():
    for io in (jio, tio):
        np.random.seed(SEED)
        ds = io.TensorDataset([ROWS, IDS])
        got = (list(io.SequenceSampler(ds)), list(io.RandomSampler(ds)),
               list(io.RandomSampler(ds, True, 20)),
               list(io.WeightedRandomSampler([1, 0, 3, 0.5], 8)),
               list(io.WeightedRandomSampler([1, 0, 3, 0.5], 3, False)),
               list(io.BatchSampler(ds, shuffle=True, batch_size=4)),
               len(io.BatchSampler(ds, batch_size=4, drop_last=True)))
        if io is jio:
            want = got
    assert got == want
    assert tio.get_worker_info() is None


def test_loader_reports_reader_wait_and_raises_worker_errors():
    import paddle_tpu_torch.monitor as tmon
    on = tmon.enabled()
    tmon.enable(True)
    try:
        tmon.reset()
        ld = tio.DataLoader(tio.TensorDataset([ROWS, IDS]), batch_size=4,
                            num_workers=2)
        assert len(list(ld)) == 3
        assert tmon.snapshot()["reader/wait_time"]["count"] == 4

        class Bad(tio.Dataset):
            def __len__(self):
                return 4

            def __getitem__(self, i):
                raise KeyError(i)
        with pytest.raises(KeyError):
            list(tio.DataLoader(Bad(), batch_size=2, num_workers=2))
    finally:
        tmon.enable(on)
        tmon.reset()


# ---------------------------------------------------------------------------
# metric
# ---------------------------------------------------------------------------

def _metric_inputs():
    rng = np.random.RandomState(5)
    logits = rng.randn(12, 7).astype(np.float32)
    labels = rng.randint(0, 7, (12, 1)).astype(np.int64)
    seq = rng.randn(3, 5, 7).astype(np.float32)
    seq_labels = rng.randint(0, 7, (3, 5)).astype(np.int64)
    seq_labels[:, :2] = np.argmax(seq[:, :2], -1)       # some hits
    probs = rng.rand(40).astype(np.float32)
    binary = (rng.rand(40) < 0.4).astype(np.int64)
    two_col = np.stack([1 - probs, probs], 1)
    return logits, labels, seq, seq_labels, probs, binary, two_col


def _metrics(metric, wrap):
    logits, labels, seq, seq_labels, probs, binary, two_col = \
        _metric_inputs()
    out = {}
    acc = metric.Accuracy(topk=(1, 3))
    for lo in (0, 6):
        c = acc.compute(wrap(logits[lo:lo + 6]), wrap(labels[lo:lo + 6]))
        out[f"acc_update_{lo}"] = acc.update(c)
    out["acc"] = acc.accumulate()
    seq_acc = metric.Accuracy()
    out["seq_update"] = seq_acc.update(seq_acc.compute(wrap(seq),
                                                       wrap(seq_labels)))
    out["seq_acc"] = seq_acc.accumulate()
    for cls in (metric.Precision, metric.Recall):
        m = cls()
        m.update(wrap(probs[:25]), wrap(binary[:25]))
        m.update(wrap(probs[25:]), wrap(binary[25:]))
        out[m.name()] = m.accumulate()
    auc = metric.Auc(num_thresholds=63)
    auc.update(wrap(two_col[:20]), wrap(binary[:20]))
    auc.update(wrap(probs[20:]), wrap(binary[20:]))
    out["auc"] = auc.accumulate()
    out["accuracy_k1"] = float(metric.accuracy(wrap(logits), wrap(labels)))
    out["accuracy_k3"] = float(metric.accuracy(wrap(logits), wrap(labels),
                                               k=3))
    out["names"] = [m.name() for m in (acc, metric.Precision(),
                                       metric.Recall(), auc)]
    return out


def test_metrics_match_jax():
    want = _metrics(jmetric, paddle.to_tensor)
    got = _metrics(tmetric, torch.from_numpy)
    assert set(got) == set(want)
    assert got.pop("names") == want.pop("names")
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float),
                                   np.asarray(want[k], dtype=float),
                                   rtol=1e-7, err_msg=k)
    # the [B, S, V] quirk: 3 examples counted, hits summed over positions
    assert got["seq_acc"] > 1.0


def test_metric_on_bf16_and_numpy_inputs():
    logits, labels = _metric_inputs()[:2]
    acc = tmetric.Accuracy()
    c = acc.compute(torch.from_numpy(logits).bfloat16(), labels)
    acc.update(c)
    ref = tmetric.Accuracy()
    ref.update(ref.compute(logits.astype(np.float32), labels))
    assert acc.accumulate() == ref.accumulate()


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _payload(pkg):
    rng = np.random.RandomState(9)
    f32 = rng.randn(3, 4).astype(np.float32)
    bf = rng.randn(5).astype(np.float32)
    ints = np.arange(6, dtype=np.int32).reshape(2, 3)
    if pkg == "jax":
        t = paddle.to_tensor
        leaves = (t(f32), t(bf).astype("bfloat16"), t(ints))
    else:
        leaves = (torch.from_numpy(f32), torch.from_numpy(bf).bfloat16(),
                  torch.from_numpy(ints))
    return {"w": leaves[0], "nested": {"bf16": leaves[1],
                                       "pair": (leaves[2], 7)},
            "list": [leaves[0], "text", 2.5], "@step": 3,
            "LR_Scheduler": {"last_epoch": 4, "last_lr": 0.001}}


def _bits(x):
    """Raw bits of a loaded leaf (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def _check_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _check_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _check_same(x, y)
    elif isinstance(a, (int, float, str)):
        assert a == b
    else:
        x, y = _bits(a), _bits(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_bit_for_bit(tmp_path, writer):
    path = str(tmp_path / "ck.pdparams")
    (paddle.save if writer == "jax" else pt.save)(_payload(writer), path)
    _check_same(_payload(writer), paddle.load(path))
    _check_same(_payload(writer), pt.load(path))
    got = pt.load(path)
    assert got["nested"]["bf16"].dtype == torch.bfloat16
    assert isinstance(got["nested"]["pair"], tuple)
    as_np = pt.load(path, return_numpy=True)
    bf = as_np["nested"]["bf16"]
    assert bf.dtype == np.float32       # by design: float32 values
    np.testing.assert_array_equal(bf, got["nested"]["bf16"].float().numpy())
    assert isinstance(as_np["w"], np.ndarray)
    with open(path, "rb") as f:
        assert f.read(5) == b"PTPU1"


# ---------------------------------------------------------------------------
# Model end to end
# ---------------------------------------------------------------------------

def _data():
    rng = np.random.RandomState(21)
    ids = rng.randint(0, 128, (12, 16)).astype(np.int64)
    labels = rng.randint(0, 128, (12, 16)).astype(np.int64)
    labels[0, :5] = -100
    eids = rng.randint(0, 128, (4, 16)).astype(np.int64)
    elabels = rng.randint(0, 128, (4, 16)).astype(np.int64)
    return ids, labels, eids, elabels


def _jax_net():
    paddle.seed(0)
    return JaxGPT(jax_test_config(sequence_parallel=False, **CFG))


def _port_net(state):
    net = GPTForCausalLM(gpt_test_config(**CFG), device="cpu")
    return net.load_params(params_from_numpy(state, device="cpu"))


def _fit(pkg, net, root):
    """``prepare`` and ``fit`` with the callbacks of the module docstring;
    returns the model, its history and what the callbacks left."""
    hapi, io, metric, opt, cb, crit = (
        (paddle, jio, jmetric, jopt, jcb, JaxCriterion()) if pkg == "jax"
        else (pt, tio, tmetric, topt, tcb, GPTPretrainingCriterion()))
    ids, labels, eids, elabels = _data()
    model = hapi.Model(net)
    sched = opt.lr.StepDecay(LR, step_size=1, gamma=0.5)
    model.prepare(opt.Adam(learning_rate=sched,
                           parameters=net.parameters()), crit,
                  metric.Accuracy())
    save_dir = os.path.join(root, pkg, "ckpt")
    log_dir = os.path.join(root, pkg, "vdl")
    stop = cb.EarlyStopping(monitor="loss", mode="min", patience=0,
                            min_delta=10, verbose=0)
    np.random.seed(SEED)
    history = model.fit(io.TensorDataset([ids, labels]),
                        io.TensorDataset([eids, elabels]), batch_size=4,
                        epochs=3, save_dir=save_dir, verbose=0,
                        callbacks=[cb.VisualDL(log_dir), stop])
    rows = [ln.split("\t")[1:] for ln in
            open(os.path.join(log_dir, "scalars.tsv")).read().splitlines()]
    return dict(model=model, history=history, stopped=stop.stopped_epoch,
                wait=stop.wait_epoch, files=sorted(os.listdir(save_dir)),
                save_dir=save_dir, lr=model._optimizer.get_lr(),
                sched=sched.state_dict(), tsv=rows,
                evaluate=model.evaluate(io.TensorDataset([eids, elabels]),
                                        batch_size=4, verbose=0),
                predict=model.predict(io.TensorDataset([eids]),
                                      batch_size=2, stack_outputs=True,
                                      verbose=0))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fit"))
    jnet = _jax_net()
    state = {k: np.asarray(v.numpy(), np.float32)
             for k, v in jnet.state_dict().items()}
    return {"jax": _fit("jax", jnet, root),
            "port": _fit("port", _port_net(state), root), "state": state}


def test_fit_history_matches_jax(fits):
    j, t = fits["jax"]["history"], fits["port"]["history"]
    assert len(t) == len(j) == 2          # EarlyStopping after epoch 2
    for hj, ht in zip(j, t):
        assert set(ht) == set(hj) == {"loss", "acc", "eval_loss",
                                      "eval_acc"}
        for k in hj:
            np.testing.assert_allclose(ht[k], hj[k], atol=1e-5, rtol=0,
                                       err_msg=k)
    assert t[1]["loss"] < t[0]["loss"]


def test_callbacks_behave_as_in_jax(fits):
    j, t = fits["jax"], fits["port"]
    assert t["files"] == j["files"] == sorted(
        f"{n}.{ext}" for n in ("0", "1", "best_model", "final")
        for ext in ("pdparams", "pdopt"))
    assert (t["stopped"], t["wait"]) == (j["stopped"], j["wait"])
    assert t["lr"] == j["lr"] == LR / 4       # two epochs of StepDecay
    assert t["sched"] == j["sched"]
    assert [r[:2] for r in t["tsv"]] == [r[:2] for r in j["tsv"]]
    assert [r[0] for r in t["tsv"]][:2] == ["train/loss", "train/acc"]
    np.testing.assert_allclose([float(r[2]) for r in t["tsv"]],
                               [float(r[2]) for r in j["tsv"]], atol=1e-5)


def test_evaluate_and_predict_match_jax(fits):
    j, t = fits["jax"], fits["port"]
    for k in j["evaluate"]:
        np.testing.assert_allclose(t["evaluate"][k], j["evaluate"][k],
                                   atol=1e-5, rtol=0)
    (pj,), (pt_,) = j["predict"], t["predict"]
    assert pt_.shape == pj.shape == (4, 16, 128)
    np.testing.assert_allclose(pt_, np.asarray(pj, np.float32), atol=1e-5,
                               rtol=0)


def test_checkpoints_cross_between_the_models(fits):
    """Each package's ``final`` checkpoint into a fresh ``Model`` of the
    other package: its ``predict`` equals the saving model's."""
    ids = _data()[2]
    for src, dst in (("port", "jax"), ("jax", "port")):
        path = os.path.join(fits[src]["save_dir"], "final")
        if dst == "jax":
            model = paddle.Model(_jax_net())
            model.prepare(jopt.Adam(parameters=model.network.parameters()),
                          JaxCriterion())
        else:
            net = _port_net(fits["state"])
            model = pt.Model(net)
            model.prepare(topt.Adam(parameters=net.parameters()),
                          GPTPretrainingCriterion())
        model.load(path)
        (got,) = model.predict(
            [(x,) for x in np.split(ids, 2)], stack_outputs=True,
            verbose=0)
        (want,) = fits[src]["predict"]
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32), atol=1e-5,
                                   rtol=0, err_msg=f"{src} -> {dst}")
        if dst == "port":   # the scheduler's state came along
            assert model._optimizer._step_count == \
                fits["port"]["model"]._optimizer._step_count


def test_summary_totals_match_jax(fits):
    want = paddle.summary(fits["jax"]["model"].network, (2, 16), "int64")
    got = pt.summary(fits["port"]["model"].network, (2, 16), "int64")
    assert got == want
    assert fits["port"]["model"].summary() == want
    assert got["total_params"] == sum(
        v.size for v in fits["state"].values())


def test_parameters_and_state_names_are_jaxs(fits):
    net = fits["port"]["model"].network
    assert set(net.state_dict()) == set(fits["state"]) == \
        set(net.param_arrays())
    assert len(fits["port"]["model"].parameters()) == len(fits["state"])
    assert fits["port"]["model"].parameters(include_sublayers=False) == []


def test_port_refuses_jit_compile_and_ignores_amp_configs():
    net = torch.nn.Linear(2, 2)
    model = pt.Model(net)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        model.prepare(topt.SGD(parameters=net.parameters()),
                      torch.nn.functional.mse_loss, jit_compile=True)
    with pytest.warns(UserWarning, match="amp_configs"):
        model.prepare(topt.SGD(parameters=net.parameters()),
                      torch.nn.functional.mse_loss, amp_configs={"x": 1})
    with pytest.raises(TypeError):
        model.prepare(loss=3)
    with pytest.raises(TypeError):
        model.prepare(metrics=[object()])


def test_predict_of_a_bf16_network_is_float32():
    net = GPTForCausalLM(gpt_test_config(**CFG), device="cpu",
                         dtype=torch.bfloat16)
    model = pt.Model(net)
    ids = np.arange(32, dtype=np.int64).reshape(2, 16)
    (out,) = model.predict_batch([ids])
    assert out.dtype == np.float32
    with torch.no_grad():
        want = net(torch.from_numpy(ids)).float().numpy()
    np.testing.assert_array_equal(out, want)


def test_inputs_follow_the_network_device_and_dtypes():
    net = torch.nn.Linear(3, 1)
    model = pt.Model(net)
    model.prepare(topt.SGD(learning_rate=0.1, parameters=net.parameters()),
                  torch.nn.functional.mse_loss)
    x = np.ones((4, 3))                       # float64 in
    logs = model.train_batch([x], [np.zeros((4, 1))])
    assert np.isfinite(logs["loss"])
    assert model.eval_batch([x], [np.zeros((4, 1))]).keys() == {"loss"}
    with pytest.raises(RuntimeError, match="is_available"):
        pt.Model(torch.nn.ReLU()).predict_batch([x])   # no parameters: cuda
