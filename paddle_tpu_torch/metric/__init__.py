"""Metrics — the port of `paddle_tpu/metric/__init__.py` (reference:
python/paddle/metric/metrics.py).

The class metrics count on the host in numpy, with the JAX package's
arithmetic: a tensor (on the card or the host; bf16 read as float32) is
brought to the host once per call.  Note `Accuracy.update`: it counts
``correct.shape[0]`` examples but sums the hits over every position, so
on ``[B, S, V]`` logits (a language model's) it can exceed 1, as the
reference's does.  `accuracy` is the tensor function, on the tensors'
device.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    """``x`` as a numpy array on the host (a bf16 tensor as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """The top-``maxk`` hits ``[..., maxk]`` (bool, numpy)."""
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim:
            label_np = label_np.squeeze(-1)
        topk_idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            accs.append(num / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fp += int(((pred_cls == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_cls = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_cls == 1) & (l == 1)).sum())
        self.fn += int(((pred_cls == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


def _histogram_auc(pos, neg, empty=0.0):
    """AUC from score-bucket histograms: sweep buckets high-score-first and
    integrate TP against FP, including the ROC origin (without a leading
    (0, 0) point, mass in the top bucket loses its trapezoid half-credit:
    a constant predictor would score 0.0 instead of 0.5)."""
    pos = np.asarray(pos, np.float64)
    neg = np.asarray(neg, np.float64)
    tot_pos, tot_neg = pos.sum(), neg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return float(empty)
    tp = np.concatenate([[0.0], np.cumsum(pos[::-1])])
    fp = np.concatenate([[0.0], np.cumsum(neg[::-1])])
    trap = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
    return float(trap(tp, fp) / (tot_pos * tot_neg))


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        idx = np.minimum((p * self.num_thresholds).astype(np.int64),
                         self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        return _histogram_auc(self._stat_pos, self._stat_neg, empty=0.0)

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The fraction of rows whose label is among the top ``k`` of
    ``input`` (a float32 0-d tensor on the inputs' device)."""
    l = torch.as_tensor(label, device=input.device)
    if l.dim() == input.dim():
        l = l.squeeze(-1)
    topk = torch.argsort(-input, dim=-1)[..., :k]
    correct = (topk == l[..., None]).any(-1)
    return correct.float().mean()
