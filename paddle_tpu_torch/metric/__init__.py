"""paddle.metric for the port (counterpart of `paddle_tpu/metric/__init__.py`).

`compute` runs on the tensors' device (Accuracy's top-k hits, the
functional `accuracy`); `update` and `accumulate` are host numpy, as in
the reference.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, _wrap, apply_op

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _raw(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x):
    return x.numpy() if isinstance(x, Tensor) else np.asarray(x)


def _topk_indices(p, k):
    """The k largest along the last axis, ties to the lower index (a
    stable descending sort, as numpy's argsort of -p)."""
    return torch.argsort(-p, dim=-1, stable=True)[..., :k]


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

    def compute(self, pred, label, *args):
        p, lab = _raw(pred), _raw(label)
        if lab.dim() == p.dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        elif lab.dim() == p.dim() and lab.shape[-1] != 1:
            # one-hot labels
            lab = torch.argmax(lab, dim=-1)
        top = _topk_indices(p.detach(), self.maxk)
        correct = top == lab.to(device=top.device, dtype=top.dtype)[..., None]
        return _wrap(correct.to(torch.float32))

    def update(self, correct, *args):
        c = _host(correct)
        num_samples = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = c[..., :k].sum()
            self.total[i] += num_corrects
            self.count[i] += num_samples
            accs.append(float(num_corrects) / num_samples)
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
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        pred_pos = (p.round() if p.dtype.kind == "f" else p) == 1
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fp += int(np.sum(pred_pos & (l == 0)))

    def reset(self):
        self.tp = 0
        self.fp = 0

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

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        pred_pos = (p.round() if p.dtype.kind == "f" else p) == 1
        self.tp += int(np.sum(pred_pos & (l == 1)))
        self.fn += int(np.sum(~pred_pos & (l == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args, **kwargs):
        super().__init__()
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        if p.ndim == 2:
            p = p[:, 1]
        l = l.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(int), self.num_thresholds - 1)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, dtype=np.int64)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoidal over threshold bins, descending threshold
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Share of rows whose label is among the k largest scores, on the
    tensors' device."""
    def fn(p, lab):
        topk = _topk_indices(p, k)
        ll = lab if lab.dim() == topk.dim() - 1 else lab[..., 0]
        hit = torch.any(topk == ll.to(topk.dtype)[..., None], dim=-1)
        return torch.mean(hit.to(torch.float32))
    return apply_op(fn, input, label, name="accuracy")
