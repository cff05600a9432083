"""High-level `Model` API — the port of `paddle_tpu/hapi/model.py`
(reference: python/paddle/hapi/model.py — Model:1004, fit:1696,
evaluate/predict, save/load, summary).

``Model(net).prepare(opt, loss, metrics).fit(loader)`` runs the JAX
package's loops with its callbacks: each train batch is the eager step
forward → loss → ``backward`` → ``optimizer.step()`` → ``clear_grad()``,
its loss read back with ``.item()`` (one host sync a step, as JAX's
``float(loss)``).  In PyTorch's idiom:

- inputs and labels go to the device of the network's first parameter:
  the card, or the CPU where the network is; host tensors and numpy
  arrays are moved once per batch, float64 turned into float32;
- ``train()`` / ``eval()`` and ``torch.no_grad()`` stand for the JAX
  layer modes and ``no_grad``; ``include_sublayers`` is ``recurse``;
  forward post-hooks are ``register_forward_hook``;
- `save` writes the network's ``state_dict()`` under the JAX names (for
  the port's `GPTForCausalLM` that is ``param_arrays()``: the per-layer
  layout is keyed like the JAX model's ``state_dict()``; the stacked
  layout like the JAX engine's arrays, not like the JAX stacked model's
  own names) and the optimizer's JAX-keyed ``state_dict()``, in the JAX
  package's file format (`framework.io_`), so a checkpoint crosses
  between the packages;
- `predict_batch` returns numpy arrays, a bfloat16 output as float32
  values (numpy has no bfloat16 without ml_dtypes; the JAX package
  returns an ml_dtypes bfloat16 array).

Telemetry, as in JAX: under ``PTPU_PERF=1`` each train step reports
synced ``forward`` / ``backward`` / ``optimizer`` segments
(`monitor.perf`); with ``PTPU_MONITOR`` on, `fit` keeps a
`monitor.train.GoodputMeter` (``train/goodput_examples_per_s``,
``train/data_wait_frac``, ``train/step_time``).

``prepare(jit_compile=True)`` raises: the port has no ``jit`` yet.
``amp_configs`` warns and is ignored, as in JAX (use `amp.auto_cast` and
`amp.GradScaler` directly).
"""
from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch
from torch import nn

from .. import monitor
from ..device import resolve_device
from ..framework.io_ import load as _load
from ..framework.io_ import save as _save
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..monitor import perf as mperf
from ..monitor import train as mtrain
from .callbacks import config_callbacks

__all__ = ["Model", "summary"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _device(net):
    """The device of the network's first parameter; the card when it has
    none."""
    p = next(net.parameters(), None)
    return p.device if p is not None else resolve_device(None)


def _to_tensor(x, device):
    """``x`` (a tensor, numpy array or nested Python numbers) as a tensor
    on ``device``, float64 as float32."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(x))
    elif x.dtype == torch.float64:
        x = x.float()
    return x.to(device)


def _to_numpy(t):
    """A tensor on the host as numpy (bfloat16 as float32 values)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _batch_examples(ins) -> int:
    """Leading-dim example count of a batch's first input — shape
    metadata only, never a device transfer."""
    if not ins:
        return 0
    shape = getattr(ins[0], "shape", None)
    if shape is not None and len(shape):
        return int(shape[0])
    try:
        return len(ins[0])
    except TypeError:
        return 0


class Model:
    """Network wrapper with train/eval/predict loops and callback hooks."""

    def __init__(self, network: nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    # -- configuration -----------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=False):
        if jit_compile:
            raise NotImplementedError(
                "prepare(jit_compile=True): paddle_tpu_torch has no jit "
                "yet (ROADMAP Queue 1 item 11); prepare without it to "
                "train eagerly")
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a Layer or a callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metric {m!r} is not a paddle_tpu_torch.metric.Metric")
        if amp_configs is not None:
            warnings.warn("amp_configs: use amp.auto_cast/GradScaler "
                          "directly; ignored here")

    def parameters(self, include_sublayers=True):
        return list(self.network.parameters(recurse=include_sublayers))

    # -- single-batch ops --------------------------------------------------
    def _compute_loss(self, outputs, labels):
        outputs = _to_list(outputs)
        labels = _to_list(labels)
        if self._loss is None:
            raise RuntimeError("loss not set; call prepare(loss=...) first")
        return self._loss(*(outputs + labels))

    def _metric_update(self, outputs, labels):
        outputs = _to_list(outputs)
        labels = _to_list(labels)
        results = {}
        for m in self._metrics:
            computed = m.compute(*(outputs + labels))
            if not isinstance(computed, (list, tuple)):
                computed = [computed]
            results[m.name()] = m.update(*computed)
        return results

    def _split_batch(self, batch):
        """Single source of truth for the inputs/labels split of a loader
        batch: the `labels` spec wins; otherwise a model prepared with a
        loss treats the last element as the label."""
        batch = _to_list(batch)
        if self._labels:
            n_lab = min(len(self._labels), len(batch) - 1)
        elif self._loss is not None and len(batch) > 1:
            n_lab = 1
        else:
            n_lab = 0
        n_in = len(batch) - n_lab
        return batch[:n_in], batch[n_in:]

    def _tensors(self, xs):
        dev = _device(self.network)
        return [_to_tensor(x, dev) for x in _to_list(xs)]

    def _train_step(self, inputs, labels):
        # perf mode (PTPU_PERF=1): synced forward/backward/optimizer
        # segments; with the gate off each `segment` is one global read
        perf_on = mperf.enabled()
        with mperf.segment("train", "forward") as s:
            outputs = self.network(*inputs)
            loss = self._compute_loss(outputs, labels)
            s.sync(loss)
        with mperf.segment("train", "backward") as s:
            loss.backward()
            if perf_on:
                s.sync([p.grad for p in self.network.parameters()
                        if p.grad is not None])
        with mperf.segment("train", "optimizer") as s:
            self._optimizer.step()
            if perf_on:
                s.sync(list(self.network.parameters()))
            self._optimizer.clear_grad()
        return loss, outputs, labels

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        loss, outputs, labels = self._train_step(self._tensors(inputs),
                                                 self._tensors(labels))
        logs = {"loss": float(loss.item())}
        if self._metrics:
            with torch.no_grad():
                logs.update(self._metric_update(outputs, labels))
        return logs

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        outputs = self.network(*inputs)
        logs = {}
        if self._loss is not None and labels:
            logs["loss"] = float(self._compute_loss(outputs, labels).item())
        logs.update(self._metric_update(outputs, labels))
        return logs

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        outputs = self.network(*self._tensors(inputs))
        return [_to_numpy(o) for o in _to_list(outputs)]

    # -- loops -------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None):
        assert train_data is not None, "train_data must be given"
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        metric_names = ["loss"] + [m.name() for m in self._metrics]
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=metric_names,
        )
        self.stop_training = False
        cbks.on_train_begin()
        history = []
        # input-pipeline goodput: time blocked on the reader vs in the
        # train step; with monitor off the loop takes no timings
        meter = mtrain.GoodputMeter() if monitor.enabled() else None
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            step = 0
            it = iter(train_loader)
            while True:
                if meter is not None:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                    meter.wait(time.perf_counter() - t0)
                else:
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                t1 = time.perf_counter() if meter is not None else 0.0
                cbks.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                logs = self.train_batch(ins, labs or None)
                cbks.on_train_batch_end(step, logs)
                if meter is not None:
                    # the step bucket spans batch-acquired -> loop bottom
                    # (split, callbacks included), so wait + step is the
                    # total loop wall; train_batch reads the loss back, so
                    # the wall includes the card's step, not its dispatch
                    meter.step(time.perf_counter() - t1,
                               examples=_batch_examples(ins))
                step += 1
                if self.stop_training:
                    break
            for m in self._metrics:
                logs[m.name()] = m.accumulate()
            cbks.on_epoch_end(epoch, logs)
            history.append(dict(logs))
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks)
                history[-1].update({f"eval_{k}": v
                                    for k, v in eval_logs.items()})
            if self.stop_training:
                break
        cbks.on_train_end(logs if history else {})
        return history

    def _run_eval(self, loader, cbks):
        steps = None
        try:
            steps = len(loader)
        except TypeError:
            pass
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin({"steps": steps})
        logs = {}
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, labs = self._split_batch(batch)
            logs = self.eval_batch(ins, labs or None)
            if "loss" in logs:
                losses.append(logs["loss"])
            cbks.on_eval_batch_end(step, logs)
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        if losses:
            logs["loss"] = float(np.mean(losses))
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(
            callbacks, model=self, log_freq=log_freq, verbose=verbose,
            metrics=["loss"] + [m.name() for m in self._metrics])
        return self._run_eval(loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=[])
        cbks.on_predict_begin()
        outputs = []
        for step, batch in enumerate(loader):
            cbks.on_predict_batch_begin(step)
            # datasets that yield (input, label) pairs: feed inputs only
            ins, _ = self._split_batch(batch)
            if self._inputs:
                ins = ins[: len(self._inputs)]
            outputs.append(self.predict_batch(ins))
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end()
        # transpose to per-output lists
        n_out = len(outputs[0]) if outputs else 0
        result = [[o[i] for o in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r, axis=0) for r in result]
        return result

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams``: the network's ``state_dict()``;
        ``path.pdopt`` (``training``): the optimizer's."""
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Copy ``path.pdparams`` into the network (cast to its device and
        dtypes; names it does not have are ignored, as in JAX) and, unless
        ``reset_optimizer``, ``path.pdopt`` into the optimizer."""
        params = _load(path + ".pdparams")
        if skip_mismatch:
            own = self.network.state_dict()
            dropped = [k for k, v in params.items()
                       if k not in own or tuple(own[k].shape) != tuple(v.shape)]
            for k in dropped:
                warnings.warn(f"load(skip_mismatch=True): skipping {k}")
                params.pop(k)
        self.network.load_state_dict(params, strict=False)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(_load(opt_path))

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtypes=dtype)


def summary(net: nn.Module, input_size=None, dtypes=None, input=None):
    """Module-tree summary with parameter counts and (when an input is
    given) per-module output shapes (reference:
    python/paddle/hapi/model_summary.py); prints the table and returns
    ``{"total_params", "trainable_params"}``."""
    rows = []
    hooks = []
    shapes = {}

    def make_hook(key):
        def hook(layer, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) \
                else outputs
            if isinstance(out, torch.Tensor):
                shapes[key] = list(out.shape)

        return hook

    named = list(net.named_modules())
    if input is None and input_size is not None:
        sizes = input_size if isinstance(input_size, list) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) \
            else [dtypes] * len(sizes)
        dev = _device(net)
        input = [torch.from_numpy(np.zeros(s, dtype=np.dtype(d or "float32")))
                 .to(dev) for s, d in zip(sizes, dts)]
        input = input[0] if len(input) == 1 else input
    if input is not None:
        for key, layer in named:
            hooks.append(layer.register_forward_hook(make_hook(key)))
        try:
            with torch.no_grad():
                net(*(_to_list(input)))
        finally:
            for h in hooks:
                h.remove()

    total, trainable = 0, 0
    for key, layer in named:
        n = sum(p.numel() for p in layer.parameters(recurse=False))
        rows.append((key or net.__class__.__name__, layer.__class__.__name__,
                     shapes.get(key), n))
    for p in net.parameters():
        total += p.numel()
        if p.requires_grad:
            trainable += p.numel()

    lines = [f"{'Layer':40s} {'Type':24s} {'Output Shape':20s} "
             f"{'Param #':>10s}"]
    lines.append("-" * 98)
    for name, cls, shape, n in rows:
        lines.append(f"{name:40s} {cls:24s} {str(shape or '-'):20s} "
                     f"{n:>10d}")
    lines.append("-" * 98)
    lines.append(f"Total params: {total}")
    lines.append(f"Trainable params: {trainable}")
    lines.append(f"Non-trainable params: {total - trainable}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
