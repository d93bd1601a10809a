"""LookAhead and ModelAverage of the port (counterpart of
`paddle_tpu/incubate/optimizer/wrappers.py`). Parameters change through
`_rebind` (value semantics, ROADMAP C.14), as the optimizers' steps do."""
import torch

from ...core.tensor import Tensor, _wrap


def _assign(p, value):
    p._rebind(lambda d: value.to(dtype=d.dtype), tracked=False)


class LookAhead:
    """k-step lookahead (Zhang et al. 2019): the inner ("fast") optimizer
    steps; every k steps the slow weights move alpha of the way toward the
    fast ones and the fast weights are reset to them."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._count = 0
        self._slow = {}

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def step(self):
        if not self._slow:
            # slow weights start from the initial parameters
            for p in self.inner_optimizer._parameters:
                self._slow[id(p)] = p._data.detach()
        self.inner_optimizer.step()
        self._count += 1
        if self._count % self.k:
            return
        for p in self.inner_optimizer._parameters:
            slow = self._slow.get(id(p))
            cur = p._data.detach()
            if slow is None:
                slow = cur
            slow = slow + self.alpha * (cur - slow)
            self._slow[id(p)] = slow
            _assign(p, slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    def state_dict(self):
        out = dict(self.inner_optimizer.state_dict())
        out["LookAhead"] = {"count": self._count,
                            "slow": {str(i): _wrap(self._slow[id(p)])
                                     for i, p in enumerate(
                                         self.inner_optimizer._parameters)
                                     if id(p) in self._slow}}
        return out

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        la = state_dict.pop("LookAhead", None)
        self.inner_optimizer.set_state_dict(state_dict)
        if la:
            self._count = int(la.get("count", 0))
            params = list(self.inner_optimizer._parameters)
            for i_str, v in la.get("slow", {}).items():
                i = int(i_str)
                if i < len(params):
                    self._slow[id(params[i])] = (
                        v._data if isinstance(v, Tensor)
                        else torch.as_tensor(v)).to(params[i]._data.device)


class ModelAverage:
    """Running average of the parameters over training (one running sum
    and a count, restarted after max_average_window steps), with apply()
    / restore() swapping the averages in and out."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._sum = {}
        self._cnt = 0
        self._backup = {}

    def step(self):
        """Accumulate; call after each optimizer step."""
        self._cnt += 1
        if self._cnt > self._max_w:
            self._sum = {id(p): torch.zeros_like(p._data.detach())
                         for p in self._params}
            self._cnt = 1
        for p in self._params:
            s = self._sum.get(id(p))
            d = p._data.detach()
            self._sum[id(p)] = d if s is None else s + d

    update = step

    def apply(self, executor=None, need_restore=True):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self._backup = {id(p): p._data.detach() for p in self._params}
            n = max(self._cnt, 1)
            for p in self._params:
                if id(p) in self._sum:
                    _assign(p, self._sum[id(p)] / n)
            try:
                yield self
            finally:
                if need_restore:
                    self.restore()
        return ctx()

    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                _assign(p, self._backup[id(p)])
        self._backup = {}
