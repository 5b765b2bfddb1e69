"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``, a copy:
``Metric``, ``Accuracy``, ``Precision``, ``Recall``, ``Auc`` and
``accuracy``).  They count on the host in numpy: ``compute`` and
``update`` read their Tensor arguments with ``numpy()``, which waits for
the device."""

from __future__ import annotations

import numpy as np

from ..tensor.tensor import Tensor

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x):
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np = _to_np(pred)
        label_np = _to_np(label)
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim:
            if label_np.shape[-1] == 1:
                # conventional [N, 1] integer labels (reference squeezes
                # the trailing dim: metric/metrics.py Accuracy.compute) —
                # NOT one-hot; argmax here would zero every label
                label_np = label_np[..., 0]
            else:
                label_np = np.argmax(label_np, axis=-1)
        correct = idx == label_np[..., None]
        return correct.astype("float32")

    def update(self, correct, *args):
        correct = _to_np(correct)
        num = correct.shape[0] if correct.ndim > 0 else 1
        accs = []
        for i, k in enumerate(self.topk):
            c = correct[..., :k].sum()
            self.total[i] += float(c)
            self.count[i] += int(np.prod(correct.shape[:-1]))
            accs.append(float(c) / max(np.prod(correct.shape[:-1]), 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / c if c > 0 else 0.0
               for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_to_np(preds) > 0.5).astype("int32").reshape(-1)
        labels = _to_np(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_to_np(preds) > 0.5).astype("int32").reshape(-1)
        labels = _to_np(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        bins = np.round(preds * self.num_thresholds).astype(int)
        bins = np.clip(bins, 0, self.num_thresholds)
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over thresholds descending
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of a batch, as a 0-D f32 Tensor on the current
    place."""
    from ..tensor.tensor import to_tensor
    pred = _to_np(input)
    lab = _to_np(label).reshape(-1)
    idx = np.argsort(-pred, axis=-1)[:, :k]
    correct_ = (idx == lab[:, None]).any(axis=1).mean()
    return to_tensor(np.float32(correct_))
