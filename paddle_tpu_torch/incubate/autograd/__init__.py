"""incubate.autograd of the port (counterpart of
`paddle_tpu/incubate/autograd/`): functional `vjp`, `jvp`, the lazy
`Jacobian` and `Hessian`, and the prim switches.

The reference takes `jax.vjp`, `jax.jvp`, `jax.jacrev` and
`jax.hessian`; the port takes `torch.func`'s over a function of plain
tensors, unwrapping and rewrapping the port's Tensor as the reference's
`_raw_fn` does.
"""
import numpy as np
import torch
import torch.func as tf

from ...core.tensor import Tensor, _wrap

__all__ = ["vjp", "jvp", "Jacobian", "Hessian", "enable_prim",
           "disable_prim", "prim_enabled", "forward_grad", "grad"]

_prim_enabled = False


def enable_prim():
    """The prim-op switch: recorded only (torch's ops are already the
    primitives the port runs)."""
    global _prim_enabled
    _prim_enabled = True


def disable_prim():
    global _prim_enabled
    _prim_enabled = False


def prim_enabled():
    return _prim_enabled


def _raw_fn(func):
    def raw(*datas):
        out = func(*[_wrap(d) for d in datas])
        outs = out if isinstance(out, (tuple, list)) else (out,)
        res = tuple(o._data if isinstance(o, Tensor) else o for o in outs)
        return res if len(res) > 1 else res[0]
    return raw


def _datas(xs):
    xs = xs if isinstance(xs, (tuple, list)) else [xs]
    return [x._data.detach() if isinstance(x, Tensor)
            else torch.as_tensor(np.asarray(x)) for x in xs]


def _out(o):
    return [_wrap(t) for t in o] if isinstance(o, tuple) else _wrap(o)


def vjp(func, xs, v=None):
    """(outputs, vjp): the pullback of `func` at xs applied to v (ones
    where v is None)."""
    datas = _datas(xs)
    out, pull = tf.vjp(_raw_fn(func), *datas)
    if v is None:
        cot = torch.ones_like(out) if not isinstance(out, tuple) else \
            tuple(torch.ones_like(o) for o in out)
    else:
        vd = _datas(v)
        cot = vd[0] if len(vd) == 1 and not isinstance(out, tuple) \
            else tuple(vd)
    gs = [_wrap(g) for g in pull(cot)]
    return _out(out), (gs if len(gs) > 1 else gs[0])


def jvp(func, xs, v=None):
    """(outputs, jvp): the pushforward of `func` at xs applied to v (ones
    where v is None)."""
    datas = _datas(xs)
    tangents = _datas(v) if v is not None else \
        [torch.ones_like(d) for d in datas]
    out, tang = tf.jvp(_raw_fn(func), tuple(datas), tuple(tangents))
    return _out(out), _out(tang)


def forward_grad(outputs, inputs, grad_inputs=None):
    """Forward-mode gradients of recorded eager outputs cannot be derived
    from a reverse tape; use `jvp(func, xs, v)`, the function form (the
    reference's primal-transform path has the same requirement)."""
    raise RuntimeError(
        "forward_grad needs the function form: use "
        "paddle.incubate.autograd.jvp(func, xs, v)")


def grad(outputs, inputs, grad_outputs=None):
    """paddle.grad."""
    from ...autograd import grad as _grad
    return _grad(outputs, inputs, grad_outputs)


class Jacobian:
    """Jacobian matrix J[i, j] = d out_i / d in_j (torch.func.jacrev),
    indexed as a matrix whose columns run over every input's flattened
    elements."""

    def __init__(self, func, xs, is_batched=False):
        self._datas = _datas(xs)
        self._J = tf.jacrev(_raw_fn(func),
                            argnums=tuple(range(len(self._datas))))(
            *self._datas)
        if isinstance(self._J, tuple) and len(self._datas) == 1:
            self._J = self._J[0]
        self._batched = is_batched

    def __getitem__(self, idx):
        arr = self._J
        if isinstance(arr, tuple):
            arr = torch.cat([a.reshape(a.shape[0], -1) for a in arr], -1)
        elif arr.dim() > 2:
            arr = arr.reshape(arr.shape[0], -1)
        return _wrap(arr[idx])

    @property
    def shape(self):
        arr = self._J
        if isinstance(arr, tuple):
            return [int(arr[0].shape[0]),
                    sum(int(np.prod(a.shape[1:])) for a in arr)]
        return list(arr.shape)


class Hessian:
    """Hessian of a scalar function (torch.func.hessian), as an (n, n)
    matrix over the input's flattened elements."""

    def __init__(self, func, xs, is_batched=False):
        self._datas = _datas(xs)
        self._H = tf.hessian(_raw_fn(func))(*self._datas)

    def __getitem__(self, idx):
        n = int(np.prod(self._datas[0].shape))
        return _wrap(self._H.reshape(n, n)[idx])

    @property
    def shape(self):
        n = int(np.prod(self._datas[0].shape))
        return [n, n]
