"""DGC and LocalSGD (counterpart of
`paddle_tpu/distributed/fleet/meta_optimizers.py`; reference:
distributed/fleet/meta_optimizers/dgc_optimizer.py and
localsgd_optimizer.py, program rewrites there, optimizer wrappers over the
same math here).

DGC (Deep Gradient Compression): the accumulated velocity's top
(1 - sparsity) fraction by magnitude is sent and the rest carried as a
local residual, with momentum correction (sent entries clear both the
velocity and the residual); `rampup_begin_step` steps of plain momentum
come first. The sent values are averaged over the dp processes under a
process group (dense, as the reference's compiled collective is); with
one process the average is the value itself.

LocalSGD: each worker steps alone, and every `k_steps` steps the
parameters are averaged over the dp processes; it wraps the raw optimizer
(no per-step gradient all-reduce).
"""
import torch

from ...core.tensor import Tensor, _wrap
from .. import collective as C
from .. import env

__all__ = ["DGCMomentumOptimizer", "LocalSGDOptimizer"]


def _quantile(v, q):
    """numpy.quantile(v, q) (linear interpolation) of a float32 vector."""
    s, _ = v.sort()
    pos = q * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def _dp_mean(x):
    """The mean of `x` over the processes under a process group, else
    `x`."""
    if env.process_group_live():
        return C._world_reduce(x, C.ReduceOp.AVG)
    return x


def _set(p, value):
    p._rebind(lambda d, v=value: v, tracked=False)


class DGCMomentumOptimizer:
    """Momentum with DGC sparsification (reference:
    fleet/meta_optimizers/dgc_optimizer.py:DGCMomentumOptimizer). The
    inner optimizer's grad_clip and weight decay apply first (clip,
    regularize, sparsify, apply); `sparsity` is a rampup list like the
    reference's ([0.75, 0.9375, 0.984375, 0.996, 0.999])."""

    def __init__(self, inner, rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,), momentum=0.9):
        self._inner = inner
        self._begin = int(rampup_begin_step)
        self._rampup = max(int(rampup_step), 1)
        self._sparsity = list(sparsity)
        self._m = float(momentum)
        self._dgc_steps = 0
        self._u = {}     # velocity, by id(param)
        self._v = {}     # residual, by id(param)

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def _current_sparsity(self):
        if self._dgc_steps < self._begin:
            return 0.0
        i = (self._dgc_steps - self._begin) * len(self._sparsity) \
            // self._rampup
        return self._sparsity[min(i, len(self._sparsity) - 1)]

    def step(self):
        s = self._current_sparsity()
        lr = self._inner.get_lr()
        params_grads = [(p, _wrap(p._data.grad))
                        for p in self._inner._parameters
                        if not p.stop_gradient and p._data.grad is not None]
        if self._inner._grad_clip is not None:
            params_grads = self._inner._grad_clip(params_grads)
        with torch.no_grad():
            for p, g in params_grads:
                if g is None:
                    continue
                g = g._data if isinstance(g, Tensor) else g
                g = self._inner._apply_decay(p, g, p._data)
                pid = id(p)
                u = self._u.get(pid)
                u = g if u is None else self._m * u + g
                if s <= 0.0:
                    # the rampup window: plain momentum, the whole velocity
                    _set(p, p._data - lr * _dp_mean(u))
                    self._u[pid] = u
                    continue
                v = self._v.get(pid)
                v = u if v is None else v + u
                thr = _quantile(v.abs().float().reshape(-1), s)
                mask = v.abs() >= thr.to(v.dtype)
                zero = torch.zeros((), dtype=v.dtype, device=v.device)
                sparse = _dp_mean(torch.where(mask, v, zero))
                self._v[pid] = torch.where(mask, zero, v)
                self._u[pid] = torch.where(mask, zero, u)
                _set(p, p._data - lr * sparse)
        self._dgc_steps += 1

    def clear_grad(self, set_to_zero=True):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    # the residuals are training state: a resume must not drop unsent
    # gradients or restart the rampup
    def state_dict(self):
        out = dict(self._inner.state_dict())
        out["DGC"] = {"steps": self._dgc_steps,
                      "u": self._by_key(self._u),
                      "v": self._by_key(self._v)}
        return out

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        dgc = state_dict.pop("DGC", None)
        self._inner.set_state_dict(state_dict)
        if dgc:
            self._dgc_steps = int(dgc.get("steps", 0))
            self._u = self._from_key(dgc.get("u", {}))
            self._v = self._from_key(dgc.get("v", {}))

    def _key(self, p, i):
        return p.name or f"param_{i}"

    def _by_key(self, d):
        return {self._key(p, i): _wrap(d[id(p)])
                for i, p in enumerate(self._inner._parameters)
                if id(p) in d}

    def _from_key(self, d):
        out = {}
        for i, p in enumerate(self._inner._parameters):
            k = self._key(p, i)
            if k in d:
                v = d[k]
                out[id(p)] = (v._data if isinstance(v, Tensor)
                              else torch.as_tensor(v)).to(p._data.device)
        return out


class LocalSGDOptimizer:
    """Local steps and a periodic parameter average (reference:
    fleet/meta_optimizers/localsgd_optimizer.py: k_steps / begin_step)."""

    def __init__(self, inner, k_steps=1, begin_step=1):
        self._inner = inner
        self._k = max(int(k_steps), 1)
        self._begin = int(begin_step)
        self._count = 0

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self):
        self._inner.step()
        self._count += 1
        if self._count >= self._begin and self._count % self._k == 0:
            self._sync_params()

    def _sync_params(self):
        """The parameters' mean over the dp processes (with one process
        the mean is the parameter)."""
        if not env.process_group_live():
            return
        with torch.no_grad():
            for p in self._inner._parameters:
                _set(p, _dp_mean(p._data))

    def clear_grad(self, set_to_zero=True):
        self._inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()

    def state_dict(self):
        out = dict(self._inner.state_dict())
        out["LocalSGD"] = {"count": self._count}
        return out

    def set_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        ls = state_dict.pop("LocalSGD", None)
        self._inner.set_state_dict(state_dict)
        if ls:
            self._count = int(ls.get("count", 0))
