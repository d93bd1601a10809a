"""paddle.autograd for the port: `backward`, `grad`, `PyLayer`,
`jacobian`, `hessian`.

Counterpart of `paddle_tpu/autograd/__init__.py`. The reference walks its
own tape; here torch's autograd does: `backward` and `grad` call
`torch.autograd.backward` / `torch.autograd.grad` (after the engine's
checks in `core/autograd.py`), and a `PyLayer` becomes a
`torch.autograd.Function` whose forward and backward see paddle Tensors.
What the reference's PyLayer promises is kept: the arity check and its
message, `mark_non_differentiable`, `set_materialize_grads`,
`mark_not_inplace`, None for "no gradient", a user backward that runs
with the tape live under `create_graph` (so grads of grads flow through
saved tensors), and `once_differentiable`, whose error fires only when
its grads are differentiated again.
"""
import torch

from ..core import autograd as _engine
from ..core.autograd import (enable_grad, is_grad_enabled,  # noqa: F401
                             no_grad, set_grad_enabled)
from ..core.tensor import Tensor, _wrap, run_backward

__all__ = ["backward", "grad", "PyLayer", "PyLayerContext",
           "once_differentiable", "jacobian", "hessian", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled"]


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    elif not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), list(grad_tensors), retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: gradients of `outputs` with respect to `inputs`,
    leaving every `.grad` alone. create_graph=True makes the results
    differentiable (double grad). An input the outputs do not reach gets
    None with allow_unused=True, zeros otherwise (as in the reference)."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    retain = create_graph if retain_graph is None else retain_graph
    roots, seeds = [], []
    for o, g in zip(outputs, grad_outputs):
        d = o._data
        if d.grad_fn is None and not d.requires_grad:
            continue
        roots.append(d)
        seeds.append(torch.ones_like(d) if g is None else
                     (g._data if isinstance(g, Tensor) else
                      torch.as_tensor(g, dtype=d.dtype, device=d.device)))
    ins = [p._data for p in inputs]
    got = [None] * len(ins)
    want = [i for i, d in enumerate(ins) if d.requires_grad]
    if roots and want:
        _engine.prepare_backward(roots)
        res = torch.autograd.grad(roots, [ins[i] for i in want], seeds,
                                  retain_graph=retain,
                                  create_graph=create_graph,
                                  allow_unused=True)
        for i, g in zip(want, res):
            got[i] = g
    results = []
    for d, g in zip(ins, got):
        if g is None:
            if allow_unused:
                results.append(None)
                continue
            g = torch.zeros_like(d)
        results.append(_wrap(g if create_graph else g.detach()))
    return results


class _SavedTensors(list):
    """`ctx.saved_tensor` is a METHOD in the reference
    (`y, = ctx.saved_tensor()`); a callable list serves both spellings."""

    def __call__(self):
        return self


class PyLayerContext:
    """Reference: autograd/py_layer.py EagerPyLayerContext."""

    def __init__(self):
        self._saved = _SavedTensors()
        self._non_differentiable = []
        self._not_inplace = []
        self._materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = _SavedTensors(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def mark_not_inplace(self, *args):
        """Recorded only: the port's ops never write into a Tensor's
        storage, so no output can alias an input in place."""
        self._not_inplace = list(args)

    def mark_non_differentiable(self, *args):
        """Outputs marked here are stop_gradient: no cotangent flows
        through them."""
        self._non_differentiable = list(args)

    def set_materialize_grads(self, value):
        """When False, backward() receives None (not zeros) for outputs
        that got no incoming gradient."""
        self._materialize_grads = bool(value)


def once_differentiable(backward):
    """Decorator for PyLayer.backward forbidding grad-of-grad through it.
    Works in either order with @staticmethod."""
    fn = backward.__func__ if isinstance(backward, staticmethod) else backward
    fn._once_differentiable = True
    return backward


class _Poison(torch.autograd.Function):
    """Identity on `g` whose backward raises: marks the grads a
    once_differentiable backward produced under create_graph. Its node
    hangs off the layer's inputs, so differentiating those grads with
    respect to them reaches it."""

    @staticmethod
    def forward(ctx, g, name, *inputs):
        ctx.layer = name
        return g.view_as(g)

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError(
            f"grad of grad through once_differentiable backward "
            f"'{ctx.layer}' is not allowed (reference: autograd/py_layer.py "
            f"once_differentiable)")


def _torch_function(cls):
    """The torch.autograd.Function behind a PyLayer subclass (made once)."""
    fn = cls.__dict__.get("_torch_fn")
    if fn is not None:
        return fn

    def forward(ctx, spec, kwargs, *datas):
        pctx = PyLayerContext()
        ctx.pctx = pctx
        args, tensors = [], []
        it = iter(datas)
        for kind in spec:
            if kind is None:
                t = _wrap(next(it))
                tensors.append(t)
                args.append(t)
            else:
                args.append(kind[0])
        ctx.n_tensors = len(tensors)
        if getattr(cls.backward, "_once_differentiable", False):
            ctx.layer_inputs = [d for d in datas if d.requires_grad]
        out = cls.forward(pctx, *args, **kwargs)
        multi = isinstance(out, (tuple, list))
        outs = list(out) if multi else [out]
        ctx.multi = multi
        raw = [o._data if isinstance(o, Tensor) else o for o in outs]
        # a forward that returns an input unchanged gets a view, so the
        # output carries this node
        in_ids = {id(t._data) for t in tensors}
        raw = [r.view_as(r) if isinstance(r, torch.Tensor)
               and id(r) in in_ids else r for r in raw]
        nondiff = [o._data for o in pctx._non_differentiable
                   if isinstance(o, Tensor)]
        by_id = {id(o): r for o, r in zip([o._data if isinstance(o, Tensor)
                                           else o for o in outs], raw)}
        if nondiff:
            ctx.mark_non_differentiable(*[by_id.get(id(d), d)
                                          for d in nondiff])
        ctx.set_materialize_grads(pctx._materialize_grads)
        saved = list(pctx._saved)
        ctx.saved_kinds = [isinstance(s, Tensor) for s in saved]
        ctx.saved_other = [None if isinstance(s, Tensor) else s
                           for s in saved]
        ctx.save_for_backward(*[by_id.get(id(s._data), s._data)
                                for s in saved if isinstance(s, Tensor)])
        return tuple(raw) if multi else raw[0]

    def backward(ctx, *cts):
        pctx = ctx.pctx
        it = iter(ctx.saved_tensors)
        pctx._saved = _SavedTensors(
            _wrap(next(it)) if is_t else other
            for is_t, other in zip(ctx.saved_kinds, ctx.saved_other))
        grads_in = [None if c is None else _wrap(c) for c in cts]
        once = getattr(cls.backward, "_once_differentiable", False)
        poison = once and torch.is_grad_enabled()
        if poison:
            with torch.no_grad():
                gins = cls.backward(pctx, *grads_in)
        else:
            gins = cls.backward(pctx, *grads_in)
        gins = gins if isinstance(gins, (tuple, list)) else (gins,)
        if len(gins) != ctx.n_tensors:
            raise ValueError(
                f"(InvalidArgument) {cls.__name__}.backward returned "
                f"{len(gins)} gradient(s) but forward took {ctx.n_tensors} "
                f"tensor input(s) (reference py_layer arity check; return "
                f"None for inputs that need no gradient)")
        out = [None, None]               # spec, kwargs
        for g in gins:
            g = g._data if isinstance(g, Tensor) else g
            if poison and isinstance(g, torch.Tensor):
                g = _Poison.apply(g.detach(), cls.__name__,
                                  *ctx.layer_inputs)
            out.append(g)
        return tuple(out)

    fn = type(f"{cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    cls._torch_fn = fn
    return fn


class PyLayer:
    """User-defined autograd function (reference: autograd/py_layer.py).

    class Exp(PyLayer):
        @staticmethod
        def forward(ctx, x): ...
        @staticmethod
        def backward(ctx, dy): ...

    forward runs under no_grad and sees paddle Tensors; backward gets one
    gradient per forward output and returns one per Tensor input (None
    for no gradient)."""

    @classmethod
    def apply(cls, *args, **kwargs):
        fn = _torch_function(cls)
        spec, datas = [], []
        for a in args:
            if isinstance(a, Tensor):
                spec.append(None)
                datas.append(a._data)
            else:
                spec.append((a,))
        out = fn.apply(tuple(spec), kwargs, *datas)
        if isinstance(out, tuple):
            return tuple(_wrap(o) if isinstance(o, torch.Tensor) else o
                         for o in out)
        return _wrap(out) if isinstance(out, torch.Tensor) else out

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError


def _functional(func, n):
    def f(*datas):
        out = func(*[_wrap(d) for d in datas]) if n > 1 else \
            func(_wrap(datas[0]))
        return out._data if isinstance(out, Tensor) else out
    return f


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """Functional Jacobian d func(xs) / d xs (out.shape + x.shape), a
    Tensor for one input or a list for several."""
    single = not isinstance(xs, (list, tuple))
    xs_list = [xs] if single else list(xs)
    raw = tuple(x._data.detach() for x in xs_list)
    jac = torch.autograd.functional.jacobian(
        _functional(func, len(raw)), raw, create_graph=create_graph)
    if single:
        return _wrap(jac[0])
    return [_wrap(j) for j in jac]


def hessian(func, xs, create_graph=False, allow_unused=False):
    """Functional Hessian of a scalar-output func of one Tensor."""
    single = not isinstance(xs, (list, tuple))
    x = (xs if single else xs[0])._data.detach()
    f = _functional(func, 1)
    return _wrap(torch.autograd.functional.hessian(
        lambda a: f(a).reshape(()), x, create_graph=create_graph))
