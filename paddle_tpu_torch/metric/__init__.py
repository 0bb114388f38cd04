"""Metrics (`paddle_tpu/metric/__init__.py`; reference
`python/paddle/metric/metrics.py`): host-side numpy over the predictions
and labels. A bf16 Tensor is read as its float32 values (the port's
`Tensor.numpy()` gives a bf16 tensor's raw bits)."""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor


def _np(x):
    if isinstance(x, Tensor):
        d = x._data.detach()
        return (d.float() if d.dtype == torch.bfloat16 else d).cpu().numpy()
    return np.asarray(x)


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
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]
        order = np.argsort(-p, axis=-1)[..., : self.maxk]
        correct = order == l[..., None]
        return Tensor(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        num = c.shape[0] if c.ndim > 0 else 1
        res = []
        for i, k in enumerate(self.topk):
            acc_k = c[..., :k].sum() / num
            self.total[i] += c[..., :k].sum()
            self.count[i] += num
            res.append(acc_k)
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = np.rint(_np(preds)).astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = np.rint(_np(preds)).astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
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
            p = p[:, -1]
        idx = np.minimum((p * self.num_thresholds).astype(int), self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            new_pos = pos + self._stat_pos[i]
            new_neg = neg + self._stat_neg[i]
            area += (new_neg - neg) * (pos + new_pos) / 2
            pos, neg = new_pos, new_neg
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    p = input._data
    l = label._data
    if l.ndim == p.ndim and l.shape[-1] == 1:
        l = l[..., 0]
    topk_idx = torch.argsort(-p, dim=-1, stable=True)[..., :k]
    correct_mask = torch.any(topk_idx == l[..., None], dim=-1)
    return Tensor(torch.mean(correct_mask.float()))
