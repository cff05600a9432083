"""Training callbacks — the port of `paddle_tpu/hapi/callbacks.py`
(reference: python/paddle/hapi/callbacks.py — ModelCheckpoint:551,
LRScheduler:616, EarlyStopping:716, VisualDL:880).  Host logic only, the
JAX package's line for line: `LRScheduler` steps the optimizer's
scheduler (`optimizer.lr`), `ReduceLROnPlateau` reads and sets its rate,
`ModelCheckpoint` and `EarlyStopping` call ``Model.save``."""
from __future__ import annotations

import numbers
import os
import time
import warnings

import numpy as np

from .progressbar import ProgressBar

__all__ = [
    "Callback",
    "CallbackList",
    "ProgBarLogger",
    "ModelCheckpoint",
    "LRScheduler",
    "EarlyStopping",
    "VisualDL",
    "ReduceLROnPlateau",
    "config_callbacks",
]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-epoch loss/metric console logging."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")
        self.train_progbar = ProgressBar(num=self.steps, verbose=self.verbose)
        self.train_step = 0

    def _metric_items(self, logs):
        out = []
        for k in self.params.get("metrics", []):
            if k in (logs or {}):
                v = logs[k]
                if isinstance(v, numbers.Number):
                    v = float(v)
                out.append((k, v))
        return out

    def on_train_batch_end(self, step, logs=None):
        self.train_step = step + 1
        if self.verbose and self.train_step % self.log_freq == 0:
            self.train_progbar.update(self.train_step, self._metric_items(logs))

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            self.train_progbar.update(self.train_step, self._metric_items(logs))

    def on_eval_begin(self, logs=None):
        self.eval_steps = (logs or {}).get("steps")
        self.eval_progbar = ProgressBar(num=self.eval_steps, verbose=self.verbose)
        if self.verbose:
            print("Eval begin...")

    def on_eval_batch_end(self, step, logs=None):
        if self.verbose and (step + 1) % self.log_freq == 0:
            self.eval_progbar.update(step + 1, self._metric_items(logs))

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = self._metric_items(logs)
            print("Eval samples done - " + ", ".join(f"{k}={v}" for k, v in items))


class ModelCheckpoint(Callback):
    """Save model + optimizer every `save_freq` epochs to `save_dir`."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Step the optimizer's LR scheduler each epoch (or batch)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode not in ("auto", "min", "max"):
            warnings.warn(f"EarlyStopping mode {mode} unknown, using auto")
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in self.monitor):
            self.monitor_op = np.less
            self.min_delta *= -1
        else:
            self.monitor_op = np.greater

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline
        else:
            self.best_value = np.inf if self.monitor_op == np.less else -np.inf
        self.best_weights = None

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current - self.min_delta, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None:
                save_dir = self.params.get("save_dir")
                if save_dir:
                    self.model.save(os.path.join(save_dir, "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            if self.verbose:
                print(f"Early stopping: monitored {self.monitor} did not improve")


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda a, b: np.less(a, b - self.min_delta)
            self.best = np.inf
        else:
            self.monitor_op = lambda a, b: np.greater(a, b + self.min_delta)
            self.best = -np.inf
        self.cooldown_counter = 0
        self.wait = 0

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.monitor_op(current, self.best):
            self.best = current
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    old = opt.get_lr()
                    new = max(old * self.factor, self.min_lr)
                    if old - new > 1e-12:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old} -> {new}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalar logging to a directory as TSV (the reference logs to VisualDL;
    that dashboard isn't available here, so the same scalars land in
    `log_dir/scalars.tsv` for any plotting frontend)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self.epoch = 0

    def _write(self, tag, step, value):
        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.tsv"), "a")
        self._fh.write(f"{time.time()}\t{tag}\t{step}\t{value}\n")
        self._fh.flush()

    def on_epoch_end(self, epoch, logs=None):
        self.epoch = epoch
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            if isinstance(v, numbers.Number):
                self._write(f"train/{k}", epoch, v)

    def on_eval_end(self, logs=None):
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)):
                v = v[0] if v else None
            if isinstance(v, numbers.Number):
                self._write(f"eval/{k}", self.epoch, v)

    def on_train_end(self, logs=None):
        if self._fh:
            self._fh.close()
            self._fh = None


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cb_list = CallbackList(cbks)
    cb_list.set_model(model)
    params = {
        "batch_size": batch_size,
        "epochs": epochs,
        "steps": steps,
        "verbose": verbose,
        "metrics": metrics or [],
        "save_dir": save_dir,
    }
    cb_list.set_params(params)
    return cb_list
