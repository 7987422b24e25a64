"""Streaming metrics on the host (counterpart of paddle_tpu/metrics.py;
reference python/paddle/fluid/metrics.py: MetricBase, CompositeMetric,
Precision, Recall, Accuracy, EditDistance, Auc).

Accumulators fed with fetched values (numpy arrays, or tensors, which are
read back with np.asarray) that aggregate across steps and epochs on the
host, as in the reference; the in-graph metric ops are ops/metrics.py's
`accuracy` and `auc`."""

from __future__ import annotations

import numpy as np


def _host(x):
    """x as a numpy array: a CUDA tensor is copied to the host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")}


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise TypeError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1.0):
        self.value += float(_host(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no updates yet")
        return self.value / self.weight


def _binary(preds, labels):
    preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
    labels = _host(labels).astype(np.int64).reshape(-1)
    return preds, labels


class Precision(MetricBase):
    """Binary precision over {0, 1} predictions and labels."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds, labels = _binary(preds, labels)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Streaming ROC AUC from bucketed confusion counts (the `auc` op's
    estimator)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num + 1, np.int64)
        self._stat_neg = np.zeros(self._num + 1, np.int64)

    def update(self, preds, labels):
        preds = _host(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _host(labels).reshape(-1)
        idx = np.clip((preds * self._num).astype(np.int64), 0, self._num)
        np.add.at(self._stat_pos, idx[labels > 0.5], 1)
        np.add.at(self._stat_neg, idx[labels <= 0.5], 1)

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * (new_neg - tot_neg) / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return float(auc / (tot_pos * tot_neg))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, distances, seq_num=None):
        d = _host(distances).reshape(-1)
        self.total += float(d.sum())
        self.count += int(seq_num if seq_num is not None else d.size)

    def eval(self):
        if not self.count:
            raise ValueError("EditDistance: no updates yet")
        return self.total / self.count
