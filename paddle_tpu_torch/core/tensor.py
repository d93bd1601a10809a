"""Tensor: the user-facing eager tensor of the port.

Counterpart of `paddle_tpu/core/tensor.py`. A Tensor wraps one
`torch.Tensor` (`_data`); torch's autograd is the tape, so
`stop_gradient` is `not _data.requires_grad` (paddle's default True) and
every op funnels through `apply_op`, which calls a function on torch
tensors and wraps what it returns. There is no per-op executable cache:
the JAX package's `_build_cached_op` / `_EAGER_CACHE` exist because XLA
compiles each op; torch dispatches eagerly and has nothing to cache.
`apply_op` keeps three pieces of the reference:
  * `_add_op_context`: an error raised inside an op carries a note
    naming the op and its inputs;
  * `_check_finite`: with `FLAGS_check_nan_inf` set, an op whose float
    output holds NaN or Inf raises naming the op (one host sync per op);
  * an Operator span per op while the port's profiler records (and a
    `torch.profiler.record_function` range while a torch profiler
    records). When neither records, the cost is one attribute load.

Value semantics (ROADMAP C.14): JAX arrays never alias, so the
reference's in-place methods rebind `_data` to a new array. The port does
the same: every in-place method computes a new torch tensor and rebinds
`_data`, so storage a Tensor handed out (a view from indexing, `reshape`
or `transpose`, a `.grad`) is never written. `core/autograd.py` keeps the
contracts that depend on it (fresh `.grad` buffers, the version check).
"""
import numbers
import operator

import numpy as np
import torch

from . import autograd as _ag
from . import dtype as _dt
from .device import Place, place_device
from ..framework.flags import _FLAGS
from ..profiler import _tracer as _TRACER

__all__ = ["Tensor", "Parameter", "HookRemoveHelper", "apply_op",
           "to_tensor", "wrap", "unwrap"]

_LEAF_INPLACE = ("a leaf Tensor that requires grad cannot be used in an "
                 "in-place operation; wrap it in no_grad() or use the "
                 "out-of-place op")


class Tensor:
    """Eager tensor over one torch.Tensor. Attributes other than `_data`
    live in the instance dict and default to the class values below, so
    wrapping an op's output stores one attribute."""

    __slots__ = ("_data", "__dict__", "__weakref__")

    name = None
    persistable = False
    trainable = False
    _version = 0                 # bumped by every in-place change
    _hooks = None                # {id: (user hook, torch handle)}
    _want_grad = False           # stop_gradient=False on a non-float tensor

    def __init__(self, data, stop_gradient=True, name=None):
        if isinstance(data, Tensor):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = to_tensor(data)._data
        if stop_gradient:
            if data.requires_grad:
                data = data.detach()
        elif not data.requires_grad:
            data = data.detach()
            if _dt.is_inexact(data.dtype):
                data.requires_grad_(True)
            else:
                self._want_grad = True
        self._data = data
        self.name = name
        self.trainable = not stop_gradient

    # -- basic properties ---------------------------------------------------
    @property
    def data(self):
        return self

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = ndim

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self):
        return Place.of(self._data.device)

    @property
    def stop_gradient(self):
        return not (self._data.requires_grad or self._want_grad)

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        if value:
            self._want_grad = False
            if d.requires_grad:
                if d.grad_fn is None:
                    d.requires_grad_(False)
                else:
                    self._data = d.detach()
        elif not d.requires_grad:
            if _dt.is_inexact(d.dtype):
                d.requires_grad_(True)
            else:
                self._want_grad = True

    @property
    def grad(self):
        d = self._data
        if d.grad_fn is not None or d.grad is None:
            return None                  # only leaves keep a gradient
        _ag.note_grad_read(d)
        return _wrap(d.grad)

    @grad.setter
    def grad(self, value):
        if value is None:
            self._data.grad = None
            return
        g = value._data if isinstance(value, Tensor) else to_tensor(
            value, place=Place.of(self._data.device))._data
        self._data.grad = g.detach().to(self._data.dtype)
        _ag.note_grad_read(self._data)   # shared: the next backward copies

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    def numel(self):
        return self.size

    # -- conversion ---------------------------------------------------------
    def numpy(self, force_int64=False):
        """Host copy (never a view of the tensor's storage). bfloat16
        comes back as float32, which holds it exactly (ROADMAP C.14).
        `force_int64=True` (or FLAGS_int64_numpy_boundary) widens int32
        to int64."""
        d = self._data.detach()
        if d._is_zerotensor():           # some backward formulas make these
            d = torch.zeros(d.shape, dtype=d.dtype, device=d.device)
        if d.dtype == torch.bfloat16:
            d = d.float()
        a = d.cpu().numpy()
        if d.data_ptr() == self._data.data_ptr():
            a = a.copy()                 # a CPU tensor's numpy() is a view
        if a.dtype == np.int32 and (force_int64 or _FLAGS.get(
                "FLAGS_int64_numpy_boundary", False)):
            a = a.astype(np.int64)
        return a

    def item(self):
        return self._data.detach().item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def astype(self, dtype):
        d = _dt.convert_dtype(dtype)
        return apply_op(lambda x: x.to(d), self, name="cast")

    cast = astype

    def detach(self):
        t = _wrap(self._data.detach())
        t.name = self.name
        return t

    def clone(self):
        return apply_op(torch.clone, self, name="clone")

    def cpu(self):
        return _wrap(self._data.cpu())

    def to(self, device=None, dtype=None, blocking=None):
        """x.to(device), x.to(dtype) or x.to(device, dtype)."""
        if dtype is None and _is_dtype(device):
            device, dtype = None, device
        out = self
        if device is not None:
            dev = place_device(device)
            out = apply_op(lambda x: x.to(dev), out, name="to")
        if dtype is not None:
            out = out.astype(dtype)
        return out

    def pin_memory(self):
        return self

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._data.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """hook(grad Tensor) -> new grad or None, fired once this tensor's
        gradient is final (for a leaf: before it is accumulated into
        `.grad`). Returns a handle with `.remove()`."""
        if self.stop_gradient:
            raise RuntimeError(
                "cannot register a grad hook on a tensor with "
                "stop_gradient=True")
        if self._hooks is None:
            self._hooks = {}
        return HookRemoveHelper(self, hook)

    def _attach_hook(self, key, hook):
        def torch_hook(g):
            out = hook(_wrap(g))
            if out is None:
                return None
            return out._data if isinstance(out, Tensor) else torch.as_tensor(
                out, dtype=g.dtype, device=g.device)
        self._hooks[key] = (hook, self._data.register_hook(torch_hook))

    # -- in-place changes -----------------------------------------------------
    def _rebind(self, compute, tracked=True):
        """Replace this tensor's value by compute(value) without writing
        into the old storage.

        tracked=True (the `op_` variants, `__setitem__`): under grad mode
        the change is recorded like an op; a trainable leaf raises, as in
        the reference. tracked=False (set_value, fill_, add_, ...) never
        records, like the reference's raw `_data` rebinds. Either way,
        outside grad recording a trainable tensor stays trainable: a leaf
        stays a leaf (its `.grad` and hooks move to the new value), and a
        non-leaf keeps its place on the graph (gradient passes through as
        identity)."""
        old = self._data
        if old.requires_grad and tracked and torch.is_grad_enabled():
            if old.grad_fn is None:
                raise RuntimeError(_LEAF_INPLACE)
            probe = old.view_as(old)     # the first node made after now
            new = compute(probe)
            _ag.mark_rebound(old, probe.grad_fn._sequence_nr())
        elif old.requires_grad:
            with torch.no_grad():
                new = compute(old)
            if old.grad_fn is None:
                new = new.detach()
                if _dt.is_inexact(new.dtype):
                    new.requires_grad_(True)
                    g = old.grad
                    if g is not None and g.shape == new.shape \
                            and g.dtype == new.dtype:
                        new.grad = g
                _ag.mark_rebound_leaf(old)
            else:
                with torch.enable_grad():
                    new = _Rebase.apply(old, new)
                _ag.mark_rebound(old, new.grad_fn._sequence_nr())
        elif tracked:
            new = compute(old)
        else:
            with torch.no_grad():
                new = compute(old)
        self._data = new
        self._version += 1
        if self._hooks:
            for key, (hook, handle) in list(self._hooks.items()):
                handle.remove()
                if new.requires_grad:
                    self._attach_hook(key, hook)
                else:
                    del self._hooks[key]
        return self

    def set_value(self, value):
        def fn(d):
            v = value._data if isinstance(value, Tensor) else \
                torch.as_tensor(np.asarray(value), device=d.device)
            return v.to(device=d.device, dtype=d.dtype).broadcast_to(
                d.shape).clone()
        return self._rebind(fn, tracked=False)

    def fill_(self, value):
        return self._rebind(lambda d: torch.full_like(d, value),
                            tracked=False)

    def zero_(self):
        return self._rebind(torch.zeros_like, tracked=False)

    def scale_(self, scale):
        return self._rebind(lambda d: d * scale, tracked=False)

    def add_(self, other):
        o = other._data if isinstance(other, Tensor) else other
        return self._rebind(lambda d: d + o, tracked=False)

    def subtract_(self, other):
        o = other._data if isinstance(other, Tensor) else other
        return self._rebind(lambda d: d - o, tracked=False)

    def multiply_(self, other):
        o = other._data if isinstance(other, Tensor) else other
        return self._rebind(lambda d: d * o, tracked=False)

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    # -- operators ----------------------------------------------------------
    def __len__(self):
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __neg__(self):
        return apply_op(operator.neg, self, name="neg")

    def __abs__(self):
        return apply_op(torch.abs, self, name="abs")

    def __add__(self, o):
        return _binop(operator.add, self, o, "add")

    __radd__ = __add__

    def __sub__(self, o):
        return _binop(operator.sub, self, o, "subtract")

    def __rsub__(self, o):
        return _binop(operator.sub, o, self, "subtract")

    def __mul__(self, o):
        return _binop(operator.mul, self, o, "multiply")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return _binop(operator.truediv, self, o, "divide")

    def __rtruediv__(self, o):
        return _binop(operator.truediv, o, self, "divide")

    def __floordiv__(self, o):
        return _binop(operator.floordiv, self, o, "floor_divide")

    def __mod__(self, o):
        return _binop(operator.mod, self, o, "mod")

    def __pow__(self, o):
        return _binop(operator.pow, self, o, "pow")

    def __rpow__(self, o):
        return _binop(operator.pow, o, self, "pow")

    def __matmul__(self, o):
        return _binop(torch.matmul, self, o, "matmul")

    def __rmatmul__(self, o):
        return _binop(torch.matmul, o, self, "matmul")

    def __eq__(self, o):
        return _binop(operator.eq, self, o, "equal")

    def __ne__(self, o):
        return _binop(operator.ne, self, o, "not_equal")

    def __lt__(self, o):
        return _binop(operator.lt, self, o, "less_than")

    def __le__(self, o):
        return _binop(operator.le, self, o, "less_equal")

    def __gt__(self, o):
        return _binop(operator.gt, self, o, "greater_than")

    def __ge__(self, o):
        return _binop(operator.ge, self, o, "greater_equal")

    def __hash__(self):
        return id(self)

    def __invert__(self):
        return apply_op(torch.logical_not, self, name="logical_not")

    def __getitem__(self, idx):
        idx = _convert_index(idx, self._data.device)
        if _is_traced_scalar_index(idx):
            # x[i] for a 0-d integer tensor i being traced (a loop counter
            # of a `jit` program): torch would read i as a Python int
            return apply_op(lambda x: torch.index_select(
                x, 0, idx.reshape(1)).squeeze(0), self, name="getitem")
        return apply_op(lambda x: x[idx], self, name="getitem")

    def __setitem__(self, idx, value):
        idx = _convert_index(idx, self._data.device)
        tracked = not self.stop_gradient and torch.is_grad_enabled()

        def fn(d):
            if isinstance(value, Tensor):
                v = value._data if tracked else value._data.detach()
                v = v.to(dtype=d.dtype, device=d.device)
            elif isinstance(value, numbers.Number):
                v = value
            else:
                v = torch.as_tensor(np.asarray(value), dtype=d.dtype,
                                    device=d.device)
            out = d.clone()
            out[idx] = v
            return out
        self._rebind(fn, tracked=tracked)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        grad_txt = "" if self.stop_gradient else ", stop_gradient=False"
        dev = self._data.device
        return (f"Tensor(shape={self.shape}, dtype="
                f"{_dt.dtype_name(self.dtype)}, place={Place.of(dev)}"
                f"{grad_txt},\n       {self.numpy()!r})")

    # Rich tensor methods (sum/mean/reshape/...) are attached by
    # paddle_tpu_torch.tensor at import time, as the reference patches
    # python/paddle/tensor/* onto its tensor type.


class _Rebase(torch.autograd.Function):
    """Value `new`, gradient passed to `old` as identity: an untracked
    in-place change of a non-leaf keeps its producer on the graph."""

    @staticmethod
    def forward(ctx, old, new):
        ctx.shape = old.shape
        return new.view_as(new)

    @staticmethod
    def backward(ctx, g):
        return g.reshape(ctx.shape), None


class HookRemoveHelper:
    """Handle returned by register_hook (reference:
    python/paddle/fluid/dygraph/base.py HookRemoveHelper)."""

    _next_id = 0

    def __init__(self, tensor, hook):
        self._tensor = tensor
        self._id = HookRemoveHelper._next_id
        HookRemoveHelper._next_id += 1
        tensor._attach_hook(self._id, hook)

    def remove(self):
        hooks = self._tensor._hooks
        entry = hooks.pop(self._id, None) if hooks else None
        if entry is not None:
            entry[1].remove()


class Parameter(Tensor):
    """Trainable tensor (reference: paddle/fluid/framework.py Parameter)."""

    def __init__(self, data, name=None, trainable=True):
        super().__init__(data, stop_gradient=not trainable, name=name)
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False
        self.split_axis = None

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


_new = object.__new__


def _is_dtype(x):
    return isinstance(x, (torch.dtype, np.dtype, type)) or (
        isinstance(x, str) and x.lower() in _dt._STR_ALIASES)


def _wrap(t):
    """An op's output as a Tensor (no copy, autograd state as torch made
    it)."""
    o = _new(Tensor)
    o._data = t
    return o


def is_traced(d):
    """True for a torch tensor being traced (a fake tensor, or a
    functional one over it: `make_fx`, `torch.export`), which has no
    values to read."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch._subclasses.functional_tensor import FunctionalTensor
    return isinstance(d, (FakeTensor, FunctionalTensor))


def _is_traced_scalar_index(idx):
    return is_traced(idx) and idx.dim() == 0 and \
        not idx.is_floating_point() and idx.dtype != torch.bool


def _convert_index(idx, device):
    def conv(i):
        if isinstance(i, Tensor):
            i = i._data
            return i.to(device) if i.device != device else i
        return i
    if isinstance(idx, tuple):
        return tuple(conv(i) for i in idx)
    return conv(idx)


def wrap(data, stop_gradient=True):
    if isinstance(data, (tuple, list)):
        return type(data)(wrap(d, stop_gradient) for d in data)
    return Tensor(data, stop_gradient=stop_gradient)


def unwrap(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, (tuple, list)):
        return type(x)(unwrap(i) for i in x)
    return x


# ---------------------------------------------------------------------------
# scalar promotion (reference `_coerce_pair` / `_promote_scalar_dtype`)
# ---------------------------------------------------------------------------

def _binop(fn, a, b, name=""):
    """Apply torch-level binary `fn` to two operands, at least one a
    Tensor. Python scalars follow the reference's rules, spelled out
    here instead of left to torch's promotion:
      * an int scalar takes the tensor's dtype;
      * a float scalar on an integer or bool tensor gives the default
        float dtype;
      * bool tensors go to the default float dtype in arithmetic with an
        int scalar (`(x > 0) * 3` is float).
    Other non-Tensor operands (lists, arrays) become tensors of the
    Tensor operand's dtype."""
    if isinstance(a, Tensor):
        if not isinstance(b, Tensor):
            a, b = _coerce_scalar(a, b)
    elif isinstance(b, Tensor):
        b, a = _coerce_scalar(b, a)
    else:
        a = to_tensor(a)
        b = to_tensor(b)
    return apply_op(fn, a, b, name=name)


def _coerce_scalar(t, s):
    """(Tensor, operand) -> (Tensor, operand) after the promotion rules."""
    if isinstance(s, np.generic):
        s = s.item()
    td = t._data.dtype
    if isinstance(s, bool):
        return t, s
    if isinstance(s, numbers.Integral):
        if td == torch.bool:
            t = t.astype(_dt.get_default_dtype())
        return t, s
    if isinstance(s, numbers.Real):
        if not (td.is_floating_point or td.is_complex):
            t = t.astype(_dt.get_default_dtype())
        return t, s
    if isinstance(s, numbers.Number):
        return t, s
    return t, to_tensor(s, dtype=td, place=Place.of(t._data.device))


# ---------------------------------------------------------------------------
# apply_op
# ---------------------------------------------------------------------------

def _op_name(fn, name):
    if name:
        return name
    q = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", "op")
    return q.split(".<locals>")[0]


def _check_finite(outs, opname):
    """FLAGS_check_nan_inf per-op scan (reference: eager/nan_inf_utils.cc):
    raise naming the op the moment a float output holds NaN or Inf. Each
    check syncs the host with the device. Values being traced (a `jit`
    program, `torch.export`) have none to read and are skipped, as the
    reference skips tracers under jit."""
    out_list = outs if isinstance(outs, tuple) else (outs,)
    for i, o in enumerate(out_list):
        d = o._data if isinstance(o, Tensor) else o
        if is_traced(d):
            continue
        if isinstance(d, torch.Tensor) and (d.is_floating_point()
                                            or d.is_complex()):
            if not bool(torch.isfinite(d).all()):
                raise RuntimeError(
                    f"FLAGS_check_nan_inf: op '{opname or 'unknown'}' "
                    f"produced NaN/Inf in output {i} (shape "
                    f"{tuple(d.shape)}, dtype {_dt.dtype_name(d.dtype)})")
    return outs


def _add_op_context(e, fn, name, args):
    """Reference-style op error context (enforce.h formats every kernel
    failure with the op name and inputs): an exception note naming the op
    and its eager input signature."""
    sig = ", ".join(
        f"Tensor{tuple(a.shape)}:{_dt.dtype_name(a.dtype)}"
        if isinstance(a, Tensor) else type(a).__name__ for a in args)
    e.add_note(f"  [operator < {_op_name(fn, name)} > error] inputs: "
               f"({sig})")


def _wrap_out(out):
    if isinstance(out, torch.Tensor):
        return _wrap(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap_out(o) for o in out)
    return out


def _apply_observed(fn, args, name, kwargs):
    """apply_op while the profiler records or FLAGS_check_nan_inf is set."""
    opname = _op_name(fn, name)
    rec = ann = None
    if _TRACER.enabled:
        tensors = [a for a in args if isinstance(a, Tensor)]
        rec = _TRACER.begin(opname, "Operator", {
            "input_shapes": [tuple(a._data.shape) for a in tensors],
            "input_dtypes": [_dt.dtype_name(a.dtype) for a in tensors]})
    if rec is not None and torch.autograd._profiler_enabled():
        ann = torch.profiler.record_function(opname)
        ann.__enter__()
    try:
        out = _wrap_out(fn(*[a._data if isinstance(a, Tensor) else a
                             for a in args], **kwargs))
        if _FLAGS["FLAGS_check_nan_inf"]:
            _check_finite(out, opname)
        return out
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        if rec is not None:
            _TRACER.end(rec)


def apply_op(fn, *args, name="", **kwargs):
    """Run `fn` over the torch tensors of `args` and wrap the result.

    `fn` takes torch tensors (Tensor args are unwrapped, other args pass
    through) and returns a torch tensor or a tuple of them; torch's
    autograd records it when grad mode is on and an input requires grad.
    Returns a Tensor or a tuple of Tensors mirroring fn's output."""
    try:
        if _TRACER.enabled or _FLAGS["FLAGS_check_nan_inf"]:
            return _apply_observed(fn, args, name, kwargs)
        return _wrap_out(fn(*[a._data if isinstance(a, Tensor) else a
                              for a in args], **kwargs))
    except Exception as e:
        _add_op_context(e, fn, name, args)
        raise


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _seed_like(g, d):
    if g is None:
        return torch.ones_like(d)
    if isinstance(g, Tensor):
        return g._data
    return torch.as_tensor(np.asarray(g), dtype=d.dtype, device=d.device)


def run_backward(tensors, grad_tensors, retain_graph=False,
                 create_graph=False):
    """Reverse sweep from `tensors` accumulating into leaves' `.grad`.
    A tensor with no recorded producer (a leaf, or made under no_grad)
    contributes nothing, as in the reference engine."""
    roots, seeds = [], []
    for t, g in zip(tensors, grad_tensors):
        d = t._data
        if d.grad_fn is None:
            continue
        roots.append(d)
        seeds.append(_seed_like(g, d))
    if not roots:
        return
    _ag.prepare_backward(roots)
    torch.autograd.backward(roots, seeds, retain_graph=retain_graph,
                            create_graph=create_graph)


# ---------------------------------------------------------------------------
# to_tensor
# ---------------------------------------------------------------------------

def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new leaf on `place` (default: the current
    place, which is the GPU unless `set_device("cpu")` was called).
    float64 host data becomes the default float dtype unless `dtype`
    says otherwise; integers keep 64 bits (ROADMAP C.14)."""
    d = _dt.convert_dtype(dtype)
    if isinstance(data, (Tensor, torch.Tensor)):
        t = data._data.detach() if isinstance(data, Tensor) else \
            data.detach().clone()        # the caller may write into theirs
        if place is not None:
            t = t.to(place_device(place))
        if d is not None and t.dtype != d:
            t = t.to(d)
    else:
        dev = place_device(place)
        a = np.asarray(data)
        if a.dtype.name == "bfloat16":       # an ml_dtypes array
            a = a.astype(np.float32)
            d = d or torch.bfloat16
        if d is None and a.dtype == np.float64:
            d = _dt.get_default_dtype()
        if dev.type == "cpu":
            t = torch.from_numpy(np.array(a, order="C", copy=True))
        else:
            # ascontiguousarray makes a 0-d array 1-d: keep the shape
            t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)
                                 ).to(dev)
        if d is not None and t.dtype != d:
            t = t.to(d)
    out = _wrap(t)
    if not stop_gradient:
        out.stop_gradient = False
    return out
