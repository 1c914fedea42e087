"""Metrics — counterpart of ``paddle_tpu.metric`` (``Metric``,
``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and the functional
``accuracy``).

``accuracy`` stays on the tensor's device (``torch.topk``). The metric
objects accumulate on the host, as the reference's do: they take tensors
(or arrays), compute with numpy (``Accuracy`` ranks with a stable
``argsort`` of the negated scores, so a tie goes to the lower class, as in
the reference) and keep Python numbers.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of scores ``input`` [N, C] against ``label``
    ([N] or [N, 1]) as an f32 0-d tensor on ``input``'s device (``k`` is
    clamped to C)."""
    input, label = input.detach(), label.detach()
    idx = torch.topk(input, min(k, input.shape[-1]), dim=-1).indices
    if label.dim() == idx.dim() - 1:
        label = label[..., None]
    hit = (idx == label.to(idx.dtype)).any(dim=-1)
    return hit.float().mean()


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``: ``compute`` gives each
    sample's hits [N, maxk] (f32), ``update`` adds them up and returns this
    batch's accuracy, ``accumulate`` the running one."""

    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np, lbl = _np(pred), _np(label)
        topk_idx = np.argsort(-pred_np, axis=-1, kind="stable")[
            ..., :self.maxk]
        if lbl.ndim == 1 or (lbl.ndim == topk_idx.ndim
                             and lbl.shape[-1] == 1):
            lbl2 = lbl.reshape(-1, 1)
        else:
            lbl2 = np.argmax(lbl, axis=-1).reshape(-1, 1)
        correct = (topk_idx.reshape(lbl2.shape[0], -1) == lbl2).astype(
            np.float32)
        return torch.from_numpy(np.ascontiguousarray(correct))

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = c[:, :k].sum()
            self.total[i] += num
            self.count[i] += c.shape[0]
            accs.append(num / c.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of scores thresholded at 0.5."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_bin = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).reshape(-1).astype(np.int32)
        self.tp += int(((pred_bin == 1) & (lab == 1)).sum())
        self.fp += int(((pred_bin == 1) & (lab == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of scores thresholded at 0.5."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_bin = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _np(labels).reshape(-1).astype(np.int32)
        self.tp += int(((pred_bin == 1) & (lab == 1)).sum())
        self.fn += int(((pred_bin == 0) & (lab == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from histograms of the positive-class score over
    ``num_thresholds + 1`` buckets (a [N, 2] input's column 1)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, lab = _np(preds), _np(labels)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p, lab = p.reshape(-1), lab.reshape(-1)
        idx = np.clip((p * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        pos = lab.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self._num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_neg - tot_neg) * (new_pos + tot_pos) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        denom = tot_pos * tot_neg
        return float(auc / denom) if denom else 0.0

    def name(self):
        return self._name
