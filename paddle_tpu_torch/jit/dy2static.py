"""dygraph-to-static transpiler: compile *unmodified* Paddle-style Python —
including tensor-dependent ``if`` / ``while`` / ``for`` / ``break`` /
``continue`` / ``and`` / ``or`` / ``not`` — into one traceable program.

Counterpart of `paddle_tpu/jit/dy2static.py`. The AST passes are the
reference's, copied (pure Python): early returns become a flag and a
value slot, break / continue become flags and guards, and if / while /
for / and / or / not become calls of the runtime converters below with
the branch- and loop-assigned locals hoisted into pure functions.

The converters decide per call, as the reference's do: concrete values
keep plain eager Python semantics; a traced value lowers to torch's
higher-order ops, the counterparts of the reference's `lax` control flow:

  * a traced ``if`` -> `torch.cond` (the HOP `cond`);
  * a traced ``while`` -> `while_loop`;
  * a ``for`` over a traced range -> `while_loop` over a counter;
  * a ``for`` over a traced tensor's rows -> `scan`.

A value is traced when it is a fake tensor: `jit.to_static` and
`static.Program.capture` trace with `make_fx` over fake tensors, and
`torch.export` does too. The HOPs are called below torch.compile (the
public `torch.cond` would hand the branch to dynamo), so the tensors a
branch or loop body reads from its enclosing scope (closures, a Layer's
parameters) are found here: each body is first run once without
recording (`_free_tensors`), every tensor it reads that it did not make
is passed to the HOP as an extra operand, and while the HOP traces the
body a torch function mode swaps each such tensor for its operand.
"""
import ast
import functools
import inspect
import sys
import textwrap
import types
import warnings
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor
from ..core.tensor import is_traced as _tensor_is_traced

__all__ = [
    "Dy2StaticError", "convert_to_static", "convert_call",
    "convert_ifelse", "convert_while", "convert_for", "convert_logical_and",
    "convert_logical_or", "convert_logical_not", "convert_list_append",
    "maybe_range", "assert_not_traced", "ld", "is_traced", "traced_cond",
    "traced_while", "traced_scan",
]


class Dy2StaticError(RuntimeError):
    """Raised when tensor-dependent control flow cannot be lowered; the
    message names the offending construct (reference: dy2static/error.py)."""


# --------------------------------------------------------------------------
# undefined-variable sentinel
# --------------------------------------------------------------------------
class _Undefined:
    """Placeholder for a local that is not yet bound when a tensor-dependent
    construct starts (reference: variable_trans_func.py create_undefined_var).
    Registered as an EMPTY pytree node so it can ride through a HOP's
    operands and results; any use raises with the variable story intact."""
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"

    def _die(self, *a, **k):
        raise Dy2StaticError(
            "a local variable was read before assignment inside "
            "tensor-dependent control flow (it is only assigned on one "
            "branch/path); assign it a value before the if/loop")

    __bool__ = __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = _die
    __rmul__ = __truediv__ = __getitem__ = __call__ = __iter__ = _die
    __neg__ = __lt__ = __le__ = __gt__ = __ge__ = _die
    # eq/ne/hash must die too: object defaults would let `x == y` silently
    # return an identity bool (and `x in {...}` hash) instead of the curated
    # read-before-assignment error
    __eq__ = __ne__ = __hash__ = _die


UNDEF = _Undefined()
pytree.register_pytree_node(
    _Undefined, lambda u: ([], None), lambda ch, aux: UNDEF,
    serialized_type_name="paddle_tpu_torch.jit.dy2static._Undefined")


def ld(name, lcls):
    """Load ``name`` from a locals() snapshot, or the undefined sentinel."""
    return lcls.get(name, UNDEF)


# --------------------------------------------------------------------------
# small runtime utilities
# --------------------------------------------------------------------------
def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def is_traced(x):
    """True for a tensor (or Tensor) being traced (`core.tensor`)."""
    return _tensor_is_traced(_raw(x))


def _is_leaf(x):
    return isinstance(x, (Tensor, _Undefined))


def _unwrap_tree(tree):
    return pytree.tree_map(_raw, tree, is_leaf=_is_leaf)


def _wrap_like(new, old):
    """Re-wrap torch tensors as Tensor where the original value was a
    Tensor OR where tracing promoted a python scalar to a tensor."""
    def one(n, o):
        if isinstance(o, Tensor):
            return Tensor(n) if isinstance(n, torch.Tensor) else n
        if isinstance(n, torch.Tensor) and not isinstance(o, torch.Tensor):
            return Tensor(n)
        return n
    return pytree.tree_map(one, new, old, is_leaf=_is_leaf)


def _tree_has_tracer(tree):
    return any(is_traced(l) for l in pytree.tree_leaves(_unwrap_tree(tree)))


def _scalar_bool(x):
    r = _raw(x)
    if isinstance(r, torch.Tensor):
        return bool(r.reshape(()))
    if isinstance(r, (np.ndarray, np.generic)):
        return bool(np.asarray(r).reshape(()))
    return bool(r)   # python values (lists, dicts, None, ...): plain truth


def _pred(x):
    """A traced predicate as the 0-d bool tensor a HOP takes."""
    p = _raw(x)
    if not isinstance(p, torch.Tensor):
        p = torch.tensor(bool(p))
    p = p.reshape(())
    return p if p.dtype == torch.bool else p != 0


def assert_not_traced(value, construct):
    """Guard for constructs the transpiler leaves as plain Python: fine
    eagerly, a clear error under trace (reference: error.py suggestions)."""
    if is_traced(value):
        raise Dy2StaticError(
            f"dy2static: {construct} depends on a traced tensor and cannot "
            f"be lowered to a traced control-flow op; restructure the code "
            f"(e.g. move the 'return' out of the branch/loop) or use "
            f"paddle.static.nn.cond / while_loop directly")
    return value


# --------------------------------------------------------------------------
# traced control flow on torch's higher-order ops
# --------------------------------------------------------------------------
# >0 while a body runs once unrecorded to find what it reads: nested
# constructs then run as plain Python (both arms, one iteration)
_discovering = 0


class _FindFree(TorchFunctionMode):
    """Records every tensor a torch function reads that is neither an
    operand nor made inside the body."""

    def __init__(self, known):
        super().__init__()
        self.known = known
        self.free = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # an attribute read (x.dtype, x.shape) reads no data
        if getattr(func, "__name__", "") != "__get__":
            for a in pytree.tree_leaves((args, kwargs)):
                if isinstance(a, torch.Tensor) and id(a) not in self.known:
                    self.free.setdefault(id(a), a)
        out = func(*args, **kwargs)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self.known.add(id(o))
        return out


# the substitution tables of the HOP bodies being traced, outermost first
_ACTIVE = []


class _Substitute(TorchFunctionMode):
    """Swaps each free tensor for the HOP operand that carries it."""

    def __init__(self, table):
        super().__init__()
        self.table = table

    def __enter__(self):
        _ACTIVE.append(self.table)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def sub(a):
            return self.table.get(id(a), a) if isinstance(a, torch.Tensor) \
                else a
        args, kwargs = pytree.tree_map(sub, (args, kwargs or {}))
        return func(*args, **kwargs)


def _resolve(t):
    """What the tensor the code names is inside the bodies being traced;
    a real tensor (a constant of the program) is copied into the trace,
    so every HOP operand is a traced value."""
    for table in _ACTIVE:
        t = table.get(id(t), t)
    return t if is_traced(t) else t.clone()


def _unrecorded(fn, *args):
    """Run fn(*args) on the trace's fake tensors without recording it
    (what jax.eval_shape is to the reference)."""
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
    global _discovering
    _discovering += 1
    try:
        with disable_proxy_modes_tracing():
            return fn(*args)
    finally:
        _discovering -= 1


def _free_tensors(calls, operands):
    """The traced tensors the bodies in `calls` [(fn, args)] read (or
    return) from outside, as the code names them."""
    finder = _FindFree({id(o) for o in operands})
    for fn, args in calls:
        with finder:
            out = _unrecorded(fn, *args)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor) and id(o) not in finder.known:
                finder.free.setdefault(id(o), o)
    # only values of the trace count: a real tensor becomes a constant of
    # the body, as anywhere else, and one the unrecorded run made is not
    # in the program at all
    return [t for t in finder.free.values()
            if _in_trace(t) and not any(t is o for o in operands)]


def _in_trace(t):
    """True for a tensor the running make_fx trace (or one it nests in)
    has recorded."""
    from torch.fx.experimental import proxy_tensor as px
    mt = px._CURRENT_MAKE_FX_TRACER
    while mt is not None:
        if mt.fx_tracer is not None and px.has_proxy_slot(t, mt.fx_tracer):
            return True
        mt = mt.parent_tracer
    return False


def _lifted(fn, n, free):
    """fn over its first n operands, with the free tensors arriving as the
    operands after them; outputs that alias an input are cloned (a HOP
    body may not return its input)."""
    def body(*args):
        table = {id(f): a for f, a in zip(free, args[n:])}
        with _Substitute(table):
            out = fn(*args[:n])
        out = tuple(table.get(id(o), o) if isinstance(o, torch.Tensor)
                    else o for o in out)
        ins = {id(a) for a in args}
        return tuple(o.clone() if isinstance(o, torch.Tensor) and (
            id(o) in ins or o._is_view()) else o for o in out)
    return body


def traced_cond(pred, true_fn, false_fn, operands):
    """cond over torch tensors: true_fn / false_fn take the operands and
    return a tuple of tensors."""
    from torch._higher_order_ops.cond import cond_op
    ops = tuple(operands)
    if _discovering:
        _pred(pred)
        true_fn(*ops)
        return tuple(false_fn(*ops))
    free = _free_tensors([(true_fn, ops), (false_fn, ops)], ops)
    n = len(ops)
    return tuple(cond_op(_resolve(_pred(pred)), _lifted(true_fn, n, free),
                         _lifted(false_fn, n, free),
                         tuple(_resolve(t) for t in ops + tuple(free))))


def traced_while(cond_fn, body_fn, carry):
    """while_loop over a tuple of torch tensors."""
    from torch._higher_order_ops.while_loop import while_loop_op
    carry = tuple(carry)
    if _discovering:
        _pred(cond_fn(*carry))
        return tuple(body_fn(*carry))
    free = _free_tensors([(cond_fn, carry), (body_fn, carry)], carry)
    n = len(carry)

    def c(*args):
        table = {id(f): a for f, a in zip(free, args[n:])}
        with _Substitute(table):
            p = _pred(cond_fn(*args[:n]))
        return table.get(id(p), p)

    return tuple(while_loop_op(c, _lifted(body_fn, n, free),
                               tuple(_resolve(t) for t in carry),
                               tuple(_resolve(t) for t in free)))


def traced_scan(step_fn, init, xs):
    """scan of step_fn(*carry, *rows) -> (*carry, *ys) over the leading
    axis of the tensors xs; returns (*carry, *stacked ys)."""
    from torch._higher_order_ops.scan import scan_op
    init, xs = tuple(init), tuple(xs)
    n = len(init)
    if _discovering:
        out = tuple(step_fn(*init, *[x[0] for x in xs]))
        return out[:n] + tuple(y.unsqueeze(0).expand(
            (xs[0].shape[0],) + tuple(y.shape)) for y in out[n:])
    rows = _unrecorded(lambda: tuple(x[0] for x in xs))
    free = _free_tensors([(step_fn, init + rows)], init + xs + rows)
    return tuple(scan_op(_lifted(step_fn, n + len(xs), free),
                         [_resolve(t) for t in init],
                         [_resolve(t) for t in xs],
                         tuple(_resolve(t) for t in free)))


# --------------------------------------------------------------------------
# carries: locals <-> the tensors a HOP takes
# --------------------------------------------------------------------------
def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool, device=device)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64, device=device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=torch.get_default_dtype(),
                            device=device)
    return x


class _Flat:
    """A pytree of locals split into its tensor leaves (numbers become
    tensors) and the rest, which stays in the structure."""

    def __init__(self, tree, device):
        leaves, self.spec = pytree.tree_flatten(_unwrap_tree(list(tree)))
        leaves = [_as_tensor(l, device) for l in leaves]
        self.is_t = [isinstance(l, torch.Tensor) for l in leaves]
        self.consts = [None if t else l for l, t in zip(leaves, self.is_t)]
        self.tensors = tuple(l for l, t in zip(leaves, self.is_t) if t)

    def key(self):
        return (self.spec, self.is_t, [repr(c) for c in self.consts])

    def build(self, tensors):
        it = iter(tensors)
        leaves = [next(it) if t else c
                  for t, c in zip(self.is_t, self.consts)]
        return pytree.tree_unflatten(leaves, self.spec)


def _as_traced(vals, device):
    """Locals as a traced construct leaves them: numbers become tensors
    (made in the trace's fake mode), as the HOP's outputs are. Keeps a
    body run unrecorded on the path the real trace takes."""
    return tuple(Tensor(_as_tensor(v, device))
                 if isinstance(v, (bool, int, float)) else v for v in vals)


def _device_of(*xs):
    for x in pytree.tree_leaves(_unwrap_tree(list(xs))):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _friendly(names):
    """Generated return-slot names -> readable tags in error messages."""
    return ["<return value>" if n == _RET_VALUE else
            "<return flag>" if n == _RET_FLAG else n for n in names]


_RET_FLAG = "__dy2s_ret0"
_RET_VALUE = "__dy2s_rv0"


def _materialize_rv(names, vals, probe_fns):
    """For each generated return-value slot still UNDEF on entry to a
    tensor-dependent construct, evaluate the arms/body on the trace's fake
    tensors to find the shape the slot gets on the returning path and
    substitute zeros of it. Sound ONLY for the generated slot: every read
    is guarded by the return flag, so the placeholder is unobservable —
    user locals keep the curated read-before-assignment error instead."""
    vals = list(vals)
    idxs = [i for i, n in enumerate(names)
            if n == _RET_VALUE and isinstance(vals[i], _Undefined)]
    if not idxs:
        return vals
    for fn in probe_fns:
        try:
            outs = list(_unrecorded(fn, *vals))
        except Dy2StaticError:
            raise
        except Exception:                                    # noqa: BLE001
            continue          # the real lowering will name the problem
        for i in list(idxs):
            o = _raw(outs[i]) if i < len(outs) else None
            if isinstance(o, torch.Tensor):
                vals[i] = Tensor(torch.zeros(o.shape, dtype=o.dtype,
                                             device=o.device))
                idxs.remove(i)
        if not idxs:
            break
    return vals


# depth counter: >0 exactly while a loop body/cond is being traced for
# while_loop / scan (single-threaded: tracing is)
_loop_depth = 0


class _loop_scope:
    def __enter__(self):
        global _loop_depth
        _loop_depth += 1

    def __exit__(self, *exc):
        global _loop_depth
        _loop_depth -= 1
        return False


def convert_list_append(seq, item):
    """`x.append(item)` rewritten by the transpiler. A python list cannot
    ride a loop carry (its length is structure, not data), so an append
    reached while a tensor-dependent loop is being lowered gets the
    curated error; everywhere else — eager code, unrolled concrete-bound
    loops — it is a plain append."""
    if isinstance(seq, list):
        if _loop_depth > 0:
            raise Dy2StaticError(
                "dy2static: list mutation (list.append) inside a "
                "tensor-dependent loop cannot be lowered to a traced "
                "while_loop — a loop carry needs a fixed structure, and "
                "appending changes the list's length every iteration. "
                "Preallocate a tensor and index-assign into it, or collect "
                "values with paddle.concat/stack outside the loop")
        return seq.append(item)
    # custom objects: .append is an ordinary method call — keep the
    # recursive convert_call treatment the generic rewrite would have given
    return convert_call(seq.append)(item)


# --------------------------------------------------------------------------
# runtime converters (reference: dy2static/convert_operators.py)
# --------------------------------------------------------------------------
def _mismatch(names, e):
    return Dy2StaticError(
        f"dy2static: the two branches of a tensor-dependent 'if' produced "
        f"mismatched values for locals {_friendly(names)} (each branch "
        f"must leave every assigned local with the same shape/dtype; a "
        f"local assigned on only one branch stays <undefined> on the "
        f"other): {e}")


def convert_ifelse(pred, true_fn, false_fn, names, vals):
    """``if pred: ...`` where both arms assign ``names``.

    Concrete pred -> run the chosen arm as plain Python. Traced pred ->
    cond over the carried locals (reference convert_ifelse builds a
    ConditionalBlock; here both arms are traced by the cond op)."""
    if not is_traced(pred):
        fn = true_fn if _scalar_bool(pred) else false_fn
        return fn(*vals)
    if _discovering:
        # both arms run (the predicate is read, so it is found); a local
        # one arm leaves undefined takes the other's value (the shape the
        # returning path gives it)
        dev = _pred(pred).device
        t, f = tuple(true_fn(*vals)), tuple(false_fn(*vals))
        if len(t) != len(f):
            return _as_traced(f, dev)
        return _as_traced([b if isinstance(a, _Undefined) else a
                           for a, b in zip(t, f)], dev)

    vals = _materialize_rv(names, vals, (true_fn, false_fn))
    dev = _raw(pred).device
    flat_in = _Flat(vals, dev)
    outs_flat = {}

    def arm(tag, fn):
        def inner(*tensors):
            out = fn(*_wrap_like(flat_in.build(tensors), list(vals)))
            f = _Flat(list(out), dev)
            outs_flat[tag] = f
            return f.tensors
        return inner

    try:
        res = traced_cond(pred, arm("t", true_fn), arm("f", false_fn),
                          flat_in.tensors)
    except Dy2StaticError:
        raise
    except Exception as e:                                   # noqa: BLE001
        raise _mismatch(names, e) from None
    ft, ff = outs_flat.get("t"), outs_flat.get("f")
    if ft is None or ff is None or ft.key() != ff.key():
        raise _mismatch(names, "the branches return different structures")
    outs = ft.build(res)
    vals_l = list(vals)
    if len(outs) == len(vals_l):
        return tuple(_wrap_like(outs, vals_l))
    # value-select form (both branches `return expr`): no carried locals
    return tuple(Tensor(o) if isinstance(o, torch.Tensor) else o
                 for o in outs)


def convert_while(cond_fn, body_fn, names, vals):
    """``while cond: body`` over loop-carried locals ``names``.

    Concrete cond every iteration -> plain Python loop (correct dygraph
    semantics, unrolled under trace only if the carry stays concrete).
    The first traced cond switches the remaining iterations to
    while_loop (reference convert_while_loop)."""
    vals = list(vals)
    while True:
        c = cond_fn(*vals)
        if is_traced(c):
            if _discovering:
                return _as_traced(body_fn(*vals), _raw(c).device)
            return _traced_while(cond_fn, body_fn, names, vals,
                                 _raw(c).device)
        if not _scalar_bool(c):
            return tuple(vals)
        vals = list(body_fn(*vals))


def _match_carry(out_flat, init_flat, names):
    """Cast body outputs back to the carry dtypes (promotion drift);
    shape drift is a real error, named."""
    res = []
    for o, i in zip(out_flat, init_flat):
        if not isinstance(i, torch.Tensor):
            res.append(o)
            continue
        o = _as_tensor(_raw(o), i.device)
        if not isinstance(o, torch.Tensor):
            raise Dy2StaticError(
                f"dy2static: a loop-carried local changes from a tensor to "
                f"{type(o).__name__}. Carried locals: {list(names)}")
        if tuple(o.shape) != tuple(i.shape):
            raise Dy2StaticError(
                f"dy2static: a loop-carried local changes shape across "
                f"iterations ({tuple(i.shape)} -> {tuple(o.shape)}); a "
                f"traced while_loop needs fixed shapes. Carried locals: "
                f"{list(names)}")
        res.append(o.to(i.dtype))
    return res


def _dtype_fixpoint(body, init):
    """Promote carry dtypes to the fixed point of the body's output dtypes:
    eager Python promotes on the first iteration (int accumulator + float ->
    float), but a loop carry can't change dtype mid-loop, so promote the
    initial values up front instead of silently truncating."""
    for _ in range(4):
        try:
            outs = _unrecorded(body, *init)
        except Dy2StaticError:
            raise
        except Exception:                                    # noqa: BLE001
            return init   # structural problems surface via the real lowering
        if len(outs) != len(init):
            return init   # so does a local the body defines first
        changed = False
        nxt = []
        for o, i in zip(outs, init):
            o = _raw(o)
            if isinstance(i, torch.Tensor) and isinstance(o, torch.Tensor):
                pd = torch.promote_types(o.dtype, i.dtype)
                if pd != i.dtype:
                    i = i.to(pd)
                    changed = True
            nxt.append(i)
        init = nxt
        if not changed:
            break
    return init


def _loop_error(what, names, e):
    return Dy2StaticError(
        f"dy2static: tensor-dependent {what} could not be lowered "
        f"(carried locals {_friendly(names)} must keep a fixed "
        f"shape/dtype/structure across iterations): {e}")


def _traced_while(cond_fn, body_fn, names, vals, dev):
    with _loop_scope():
        vals = _materialize_rv(names, vals, (body_fn,))
        flat = _Flat(vals, dev)

        def user(tensors):
            return _wrap_like(flat.build(tensors), vals)

        def body_t(*tensors):
            out = _Flat(list(body_fn(*user(tensors))), dev)
            if out.key() != flat.key():
                raise Dy2StaticError(
                    f"dy2static: a tensor-dependent 'while' changes the "
                    f"structure of its carried locals {_friendly(names)}")
            return tuple(_match_carry(out.tensors, tensors, names))

        init = _dtype_fixpoint(
            lambda *t: [_raw(o) for o in _Flat(
                list(body_fn(*user(t))), dev).tensors], flat.tensors)
        try:
            final = traced_while(lambda *t: cond_fn(*user(t)), body_t,
                                 tuple(init))
        except Dy2StaticError:
            raise
        except Exception as e:                               # noqa: BLE001
            raise _loop_error("'while'", names, e) from None
    return tuple(user(final))


class _TracedRange:
    """range() whose bounds include traced scalars (reference: the loop
    transformer turns ``for i in range(n)`` into a while over an index)."""

    def __init__(self, *args):
        a = [_raw(x) for x in args]
        if len(a) == 1:
            self.start, self.stop, self.step = 0, a[0], 1
        elif len(a) == 2:
            self.start, self.stop, self.step = a[0], a[1], 1
        else:
            self.start, self.stop, self.step = a


def maybe_range(*args):
    if any(is_traced(x) for x in args):
        return _TracedRange(*args)
    return range(*(int(_raw(x)) for x in args))


def convert_for(iterable, body_fn, names, vals, tgt0=UNDEF):
    """``for tgt in iterable: body``. body_fn(tgt, *carry) -> (tgt, *carry)
    — the body returns the target's FINAL binding too, because python leaks
    the target (including body reassignments of it) into the enclosing
    scope. Returns ``(tgt_last, *carry)``; tgt0 = the target's pre-loop
    value, leaked back on zero iterations.

    python iterable -> eager loop; _TracedRange -> while_loop over a
    counter; a Tensor, when it or the carry is traced -> scan over its
    leading axis."""
    vals = tuple(vals)

    def split(out):
        out = list(out)
        return out[0], tuple(out[1:])

    if isinstance(iterable, _TracedRange):
        if _discovering:
            dev = _device_of(iterable.stop)
            return _as_traced(body_fn(Tensor(_as_tensor(
                iterable.start, dev)), *vals), dev)
        return _for_range(iterable, body_fn, names, vals)

    if isinstance(iterable, Tensor) and (
            is_traced(iterable) or _tree_has_tracer(vals)):
        xs = _raw(iterable)
        if xs.dim() == 0:
            raise Dy2StaticError(
                "dy2static: cannot iterate a 0-d tensor in a traced 'for'")
        if _discovering:
            return _as_traced(body_fn(Tensor(xs[0]), *vals), xs.device)
        return _for_rows(xs, body_fn, names, vals, tgt0)

    if isinstance(iterable, Tensor):
        it = [Tensor(row) for row in _raw(iterable)]
    else:
        it = iterable
    try:
        iter(it)
    except TypeError:
        raise Dy2StaticError(
            f"dy2static: cannot iterate object of type "
            f"{type(iterable).__name__} in a converted 'for' loop") from None
    tgt = tgt0
    for item in it:
        tgt, vals = split(body_fn(item, *vals))
    return (tgt,) + vals


def _for_range(r, body_fn, names, vals):
    dev = _device_of(r.stop, r.start, r.step)
    start, stop, step = (_as_tensor(_raw(v), dev) for v in
                         (r.start, r.stop, r.step))
    with _loop_scope():
        t0 = Tensor(start.clone())
        vals = tuple(_materialize_rv(
            names, list(vals),
            (lambda *c: list(body_fn(Tensor(start), *c))[1:],)))
        flat = _Flat(vals, dev)

        def user(tensors):
            return _wrap_like(flat.build(tensors), list(vals))

        def run_body(i, tensors):
            out = list(body_fn(Tensor(i), *user(tensors)))
            f = _Flat(out[1:], dev)
            if f.key() != flat.key():
                raise Dy2StaticError(
                    f"dy2static: a tensor-dependent 'for' changes the "
                    f"structure of its carried locals {_friendly(names)}")
            return _raw(out[0]), f.tensors

        init = _dtype_fixpoint(lambda *t: list(run_body(start, t)[1]),
                               flat.tensors)
        n = torch.clamp(-torch.div(-(stop - start), step,
                                   rounding_mode="floor"), min=0)

        def cond(k, tslot, *rest):
            return k < n

        def body(k, tslot, *rest):
            tlast, crest = run_body(start + k * step, rest)
            tlast = _as_tensor(tlast, dev).to(tslot.dtype)
            return (k + 1, tlast) + tuple(_match_carry(crest, rest, names))

        k0 = torch.zeros((), dtype=n.dtype, device=dev)
        try:
            final = traced_while(cond, body, (k0, t0._data) + tuple(init))
        except Dy2StaticError:
            raise
        except Exception as e:                               # noqa: BLE001
            raise _loop_error("'for' over range", names, e) from None
    # zero-trip edge leaks `start` (documented divergence from python's
    # keep-old-value, which a loop carry cannot express)
    return (Tensor(final[1]),) + tuple(user(final[2:]))


def _for_rows(xs, body_fn, names, vals, tgt0):
    dev = xs.device
    with _loop_scope():
        vals = tuple(_materialize_rv(
            names, list(vals),
            (lambda *c: list(body_fn(Tensor(xs[0]), *c))[1:],)))
        flat = _Flat(vals, dev)

        def user(tensors):
            return _wrap_like(flat.build(tensors), list(vals))

        def run_body(row, tensors):
            out = list(body_fn(Tensor(row), *user(tensors)))
            f = _Flat(out[1:], dev)
            if f.key() != flat.key():
                raise Dy2StaticError(
                    f"dy2static: a tensor-dependent 'for' changes the "
                    f"structure of its carried locals {_friendly(names)}")
            return _raw(out[0]), f.tensors

        init = _dtype_fixpoint(lambda *t: list(run_body(xs[0], t)[1]),
                               flat.tensors)

        def step(*args):
            carry, row = args[:-1], args[-1]
            tlast, crest = run_body(row, carry)
            return tuple(_match_carry(crest, carry, names)) + \
                (_as_tensor(tlast, dev),)

        try:
            out = traced_scan(step, tuple(init), (xs,))
            final, hist = out[:-1], out[-1]
        except Dy2StaticError:
            raise
        except Exception as e:                               # noqa: BLE001
            raise _loop_error("'for' over a tensor", names, e) from None
    last = Tensor(hist[-1]) if xs.shape[0] else tgt0
    return (last,) + tuple(user(final))


def convert_logical_and(lhs_fn, rhs_fn):
    """``a and b`` preserving short-circuit for concrete values
    (reference: logical_transformer.py -> convert_logical_and)."""
    a = lhs_fn()
    if not is_traced(a):
        return rhs_fn() if _scalar_bool(a) else a
    b = rhs_fn()
    return Tensor(torch.logical_and(_pred(a), _pred(_as_tensor(
        _raw(b), _raw(a).device))))


def convert_logical_or(lhs_fn, rhs_fn):
    a = lhs_fn()
    if not is_traced(a):
        return a if _scalar_bool(a) else rhs_fn()
    b = rhs_fn()
    return Tensor(torch.logical_or(_pred(a), _pred(_as_tensor(
        _raw(b), _raw(a).device))))


def convert_logical_not(x):
    if not is_traced(x):
        return not _scalar_bool(x)
    return Tensor(torch.logical_not(_pred(x)))


# --------------------------------------------------------------------------
# convert_call: recursively transform user callees
# (reference: convert_call_func.py convert_call)
# --------------------------------------------------------------------------
_SKIP_MODULE_PREFIXES = ("torch", "numpy", "paddle_tpu_torch", "builtins",
                         "math", "functools", "itertools", "operator", "np")
# weak keys: per-call inner functions / temporary Layers must not be pinned
# alive by the cache (reference convert_call_func keeps a module-level dict;
# programs are cached by StaticFunction, so a missed entry only costs at
# trace time).
# A weak entry only works if the VALUE doesn't reference the key, so
# passthrough results are stored as a sentinel and transformed functions
# drop their functools.wraps __wrapped__ back-reference.
_call_cache = weakref.WeakKeyDictionary()
_PASSTHROUGH = object()


def convert_call(f):
    """Return a dy2static-transformed version of a user function so that
    tensor-dependent control flow inside *callees* also lowers; framework,
    numpy and torch callables pass through untouched."""
    try:
        key = f.__func__ if inspect.ismethod(f) else f
        try:
            out = _call_cache[key]
        except (KeyError, TypeError):
            out = _transform_or_passthrough(key)
            try:
                _call_cache[key] = _PASSTHROUGH if out is key else out
            except TypeError:
                pass   # unhashable/unweakrefable: skip caching
        if out is _PASSTHROUGH:
            out = key
        if inspect.ismethod(f):
            return functools.partial(out, f.__self__) if out is not key else f
        return out
    except Exception:
        return f


def _transform_or_passthrough(f):
    if not isinstance(f, types.FunctionType):
        return f
    if getattr(f, "__dy2static_transformed__", False):
        return f
    mod = getattr(f, "__module__", "") or ""
    if mod.split(".")[0] in _SKIP_MODULE_PREFIXES:
        return f
    try:
        return convert_to_static(f)
    except Exception:
        return f


# --------------------------------------------------------------------------
# AST analysis helpers
# --------------------------------------------------------------------------
def _collect_stores(nodes):
    """Names bound (simple Name targets) anywhere in the statement list —
    the loop-carry / branch-output set (reference: loop_transformer.py
    NameVisitor get_loop_var_names)."""
    out = []

    class V(ast.NodeVisitor):
        def visit_Name(self, node):
            if isinstance(node.ctx, (ast.Store, ast.Del)) \
                    and node.id not in out:
                out.append(node.id)

        def visit_Subscript(self, node):
            # x[i] = v rebinds x's storage: carry the BASE name so the
            # functional update stays inside the traced arm/loop
            if isinstance(node.ctx, ast.Store):
                base = node.value
                while isinstance(base, (ast.Subscript, ast.Attribute)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id not in out:
                    out.append(base.id)
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            # own scope; function values can't ride loop carries, so inner
            # defs are recreated in place rather than carried
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    for n in nodes:
        V().visit(n)
    return out


def _has_attr_store(nodes):
    """Object-attribute assignment (self.x = v) inside a tensor-dependent
    construct can't ride a loop carry; detect it so the construct stays
    Python with a clear traced-guard instead of leaking a tracer."""
    class V(ast.NodeVisitor):
        found = False

        def visit_Attribute(self, node):
            if isinstance(node.ctx, ast.Store):
                self.found = True
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    v = V()
    for n in nodes:
        v.visit(n)
    return v.found


def _has(nodes, *kinds):
    """Like ast.walk-any, but does NOT descend into nested function/lambda
    scopes (generated __dy2s_* defs contain their own Returns)."""
    stack = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, kinds):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


def _has_toplevel_loop_escape(body):
    """True if `body` contains Return/Break/Continue not nested inside a
    deeper loop (for break/continue) — i.e. escapes *this* construct."""
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_For(self, node):
            for s in ast.walk(node):
                if isinstance(s, ast.Return):
                    self.found = True

        visit_While = visit_For

        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    v = V()
    for n in body:
        v.visit(n)
    return v.found


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


_JST = "__dy2s_jst__"   # injected helper-module name; must not collide


def _jst(attr, *args):
    return ast.Call(
        func=ast.Attribute(value=_name(_JST), attr=attr, ctx=ast.Load()),
        args=list(args), keywords=[])


def _ld_call(n):
    return _jst("ld", ast.Constant(n),
                ast.Call(func=_name("locals"), args=[], keywords=[]))


def _const_tuple(names):
    return ast.Tuple(elts=[ast.Constant(n) for n in names], ctx=ast.Load())


def _lambda0(expr):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], vararg=None,
                           kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=expr)


def _fn_def(name, params, body, returns_names):
    body = list(body)
    body.append(ast.Return(value=ast.Tuple(
        elts=[_name(n) for n in returns_names], ctx=ast.Load())))
    node = ast.FunctionDef(
        name=name,
        args=ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=p) for p in params],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=body, decorator_list=[], returns=None)
    node.type_params = []   # py3.12+ ast requires the field
    return node


def _sets_flag(nodes, brk, cont):
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name) and t.id in (brk, cont):
                        return True
    return False


# --------------------------------------------------------------------------
# pass 0: early returns -> return flag + value slot
# (reference: return_transformer.py / early_return_transformer.py)
# --------------------------------------------------------------------------
class _EarlyReturnLowering:
    """``return expr`` inside an if/loop becomes ``__dy2s_rv0 = expr;
    __dy2s_ret0 = True`` (plus ``break`` inside loops, which pass 1 then
    lowers through the existing flag machinery); statements that may run
    after a conditional return are guarded by the flag, and the function
    ends with one ``return __dy2s_rv0``. Statically-dead continuations
    (both if-arms return) are dropped so the tracer never has to select
    between a return value and nothing."""

    def transform(self, body):
        if not self._has_construct_return(body):
            return body
        body = list(body)
        if not body or not isinstance(body[-1], ast.Return):
            body.append(ast.Return(value=ast.Constant(None)))
        out, _may, _always = self._block(body, in_loop=False)
        return ([self._assign(_RET_FLAG, ast.Constant(False))] + out +
                [ast.Return(value=_name(_RET_VALUE))])

    @staticmethod
    def _has_construct_return(body):
        return any(isinstance(s, (ast.If, ast.For, ast.While))
                   and _has([s], ast.Return) for s in body)

    @staticmethod
    def _assign(name, value):
        return ast.Assign(targets=[_name(name, ast.Store())], value=value)

    def _block(self, stmts, in_loop):
        """Returns (new_stmts, may_return, always_returns)."""
        out = []
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Return):
                out.append(self._assign(_RET_VALUE,
                                        s.value or ast.Constant(None)))
                out.append(self._assign(_RET_FLAG, ast.Constant(True)))
                if in_loop:
                    out.append(ast.Break())
                return out, True, True      # rest is unreachable
            if isinstance(s, ast.If) and _has([s], ast.Return):
                nb, m1, a1 = self._block(s.body, in_loop)
                no, m2, a2 = (self._block(s.orelse, in_loop)
                              if s.orelse else ([], False, False))
                out.append(ast.If(test=s.test, body=nb, orelse=no))
                if a1 and a2:
                    return out, True, True  # every path returned
                if m1 or m2:
                    return self._guard_rest(out, stmts[i + 1:], in_loop)
                continue
            if isinstance(s, (ast.For, ast.While)) and _has([s], ast.Return):
                nb, _m, _a = self._block(s.body, True)
                if isinstance(s, ast.While):
                    out.append(ast.While(test=s.test, body=nb,
                                         orelse=s.orelse))
                else:
                    out.append(ast.For(target=s.target, iter=s.iter,
                                       body=nb, orelse=s.orelse))
                return self._guard_rest(out, stmts[i + 1:], in_loop)
            out.append(s)
        return out, False, False

    def _guard_rest(self, out, rest_stmts, in_loop):
        """After a construct that may have returned: inside a loop, break
        out (pass 1 turns it into the carry flag); at function level, run
        the continuation only when the flag is still False."""
        rest, _mr, ar = (self._block(rest_stmts, in_loop)
                         if rest_stmts else ([], False, False))
        if in_loop:
            out.append(ast.If(test=_name(_RET_FLAG), body=[ast.Break()],
                              orelse=rest))
        else:
            out.append(ast.If(
                test=ast.UnaryOp(op=ast.Not(), operand=_name(_RET_FLAG)),
                body=rest or [ast.Pass()], orelse=[]))
        return out, True, ar


# --------------------------------------------------------------------------
# pass 1: break/continue -> flag variables + guards
# (reference: break_continue_transformer.py)
# --------------------------------------------------------------------------
class _BreakContinueLowering(ast.NodeTransformer):
    """Within each loop body: ``break`` -> ``__brk_i = True``, ``continue``
    -> ``__cont_i = True``; every statement after a flag-setting statement is
    guarded by ``if not (__brk_i or __cont_i):``; the loop condition gains
    ``and not __brk_i``. The guards are ordinary ifs, which pass 2 then
    lowers when the flags are tensors."""

    def __init__(self):
        self._uid = 0

    def _lower_body(self, body, brk, cont):
        """Rewrite one loop body's statement list with flag guards."""
        def rewrite(stmts):
            out = []
            for i, s in enumerate(stmts):
                s2, sets_flag = self._rewrite_stmt(s, brk, cont)
                out.append(s2)
                if sets_flag and i + 1 < len(stmts):
                    rest = rewrite(stmts[i + 1:])
                    guard = ast.UnaryOp(
                        op=ast.Not(),
                        operand=ast.BoolOp(op=ast.Or(), values=[
                            _name(brk), _name(cont)]))
                    out.append(ast.If(test=guard, body=rest, orelse=[]))
                    break
            return out
        return rewrite(body)

    def _rewrite_stmt(self, s, brk, cont):
        """Returns (new_stmt, may_set_flag). Descends into If statements
        (whose branches may break/continue) but NOT into nested loops —
        those get their own flags via generic visitation later."""
        if isinstance(s, ast.Break):
            return ast.Assign(targets=[_name(brk, ast.Store())],
                              value=ast.Constant(True)), True
        if isinstance(s, ast.Continue):
            return ast.Assign(targets=[_name(cont, ast.Store())],
                              value=ast.Constant(True)), True
        if isinstance(s, ast.If):
            nb = self._lower_body(s.body, brk, cont)
            no = self._lower_body(s.orelse, brk, cont)
            return ast.If(test=s.test, body=nb, orelse=no or []), \
                _sets_flag(nb + no, brk, cont)
        return s, False

    def _transform_loop(self, node):
        self.generic_visit(node)   # inner loops first
        direct = self._direct_break_continue(node.body)
        if not direct:
            return node
        self._uid += 1
        brk = f"__dy2s_brk_{self._uid}"
        cont = f"__dy2s_cont_{self._uid}"
        new_body = [ast.Assign(targets=[_name(cont, ast.Store())],
                               value=ast.Constant(False))]
        new_body += self._lower_body(node.body, brk, cont)
        # both flags init'd BEFORE the loop too: they ride the traced loop
        # carry, which needs a defined value at entry
        init = [ast.Assign(targets=[_name(brk, ast.Store())],
                           value=ast.Constant(False)),
                ast.Assign(targets=[_name(cont, ast.Store())],
                           value=ast.Constant(False))]
        # python for/while-else runs iff the loop did NOT break: hoist the
        # else body behind a flag guard so the semantics survive lowering
        tail = []
        orelse = node.orelse
        if orelse:
            tail = [ast.If(test=ast.UnaryOp(op=ast.Not(),
                                            operand=_name(brk)),
                           body=orelse, orelse=[])]
            orelse = []
        if isinstance(node, ast.While):
            new_test = ast.BoolOp(op=ast.And(), values=[
                ast.UnaryOp(op=ast.Not(), operand=_name(brk)), node.test])
            loop = ast.While(test=new_test, body=new_body, orelse=orelse)
            return init + [loop] + tail
        # For: wrap the body so iterations after break are no-ops
        guarded = [ast.If(
            test=ast.UnaryOp(op=ast.Not(), operand=_name(brk)),
            body=new_body, orelse=[])]
        loop = ast.For(target=node.target, iter=node.iter, body=guarded,
                       orelse=orelse)
        return init + [loop] + tail

    def _direct_break_continue(self, body):
        """break/continue belonging to THIS loop (not a nested one)."""
        class V(ast.NodeVisitor):
            found = False

            def visit_Break(self, n):
                self.found = True

            def visit_Continue(self, n):
                self.found = True

            def visit_For(self, n):
                pass

            def visit_While(self, n):
                pass

            def visit_FunctionDef(self, n):
                pass

            visit_AsyncFunctionDef = visit_FunctionDef

        v = V()
        for s in body:
            v.visit(s)
        return v.found

    def visit_While(self, node):
        return self._transform_loop(node)

    def visit_For(self, node):
        return self._transform_loop(node)


# --------------------------------------------------------------------------
# pass 2: control flow -> runtime converter calls
# (reference: ifelse_transformer.py / loop_transformer.py /
#  logical_transformer.py / call_transformer.py)
# --------------------------------------------------------------------------
class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self._uid = 0

    def _uid_next(self):
        self._uid += 1
        return self._uid

    # ---- logical operators ------------------------------------------------
    def visit_BoolOp(self, node):
        self.generic_visit(node)
        attr = "convert_logical_and" if isinstance(node.op, ast.And) \
            else "convert_logical_or"
        expr = node.values[-1]
        for v in reversed(node.values[:-1]):
            expr = _jst(attr, _lambda0(v), _lambda0(expr))
        return expr

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return _jst("convert_logical_not", node.operand)
        return node

    # ---- calls ------------------------------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("locals", "globals", "super",
                                                "range", "print", "len",
                                                "isinstance", "enumerate",
                                                "zip"):
            return node
        if isinstance(f, ast.Attribute) and f.attr == "append" \
                and len(node.args) == 1 and not node.keywords:
            # route through the list-mutation guard: curated error when a
            # python list is appended inside a traced loop body
            return _jst("convert_list_append", f.value, node.args[0])
        node.func = _jst("convert_call", f)
        return node

    # ---- if ---------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if _has_toplevel_loop_escape(node.body) or \
                _has_toplevel_loop_escape(node.orelse):
            return self._if_with_return(node)
        if _has_attr_store(node.body + node.orelse):
            node.test = _jst("assert_not_traced", node.test,
                             ast.Constant("an 'if' whose branch assigns an "
                                          "object attribute"))
            return node
        uid = self._uid_next()
        assigned = _collect_stores(node.body + node.orelse)
        if not assigned:
            # pure side-effect-free branches still need lowering under
            # trace; carry nothing, return nothing
            assigned = []
        tf = _fn_def(f"__dy2s_tf_{uid}", assigned, node.body, assigned)
        ff = _fn_def(f"__dy2s_ff_{uid}", assigned,
                     node.orelse or [ast.Pass()], assigned)
        call = _jst("convert_ifelse", node.test,
                    _name(tf.name), _name(ff.name),
                    _const_tuple(assigned),
                    ast.Tuple(elts=[_ld_call(n) for n in assigned],
                              ctx=ast.Load()))
        if assigned:
            assign = ast.Assign(
                targets=[ast.Tuple(
                    elts=[_name(n, ast.Store()) for n in assigned],
                    ctx=ast.Store())],
                value=call)
        else:
            assign = ast.Expr(value=call)
        return [tf, ff, assign]

    def _if_with_return(self, node):
        """Both arms end in ``return expr`` -> value-select; anything else
        with an escaping return stays Python with a clear traced-guard
        (reference: return_transformer.py handles the general case with
        return-flag lowering; the guard names the restructure)."""
        body, orelse = node.body, node.orelse
        if (len(body) >= 1 and isinstance(body[-1], ast.Return)
                and orelse and isinstance(orelse[-1], ast.Return)
                and not _has(body[:-1] + orelse[:-1], ast.Return)
                and body[-1].value is not None
                and orelse[-1].value is not None):
            uid = self._uid_next()
            tf = _fn_def(f"__dy2s_rtf_{uid}", [], body[:-1], [])
            tf.body[-1] = ast.Return(value=ast.Tuple(
                elts=[body[-1].value], ctx=ast.Load()))
            ff = _fn_def(f"__dy2s_rff_{uid}", [], orelse[:-1], [])
            ff.body[-1] = ast.Return(value=ast.Tuple(
                elts=[orelse[-1].value], ctx=ast.Load()))
            call = _jst("convert_ifelse", node.test,
                        _name(tf.name), _name(ff.name),
                        _const_tuple(["<return value>"]),
                        ast.Tuple(elts=[], ctx=ast.Load()))
            ret = ast.Return(value=ast.Subscript(
                value=call, slice=ast.Constant(0), ctx=ast.Load()))
            return [tf, ff, ret]
        node.test = _jst("assert_not_traced", node.test,
                         ast.Constant("an 'if' whose branch contains an "
                                      "early 'return'"))
        return node

    # ---- while ------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if _has_toplevel_loop_escape(node.body) or node.orelse or \
                _has_attr_store(node.body):
            what = "a 'while' with an 'else' clause" if node.orelse else (
                "a 'while' whose body assigns an object attribute"
                if _has_attr_store(node.body)
                else "a 'while' whose body contains 'return'")
            node.test = _jst("assert_not_traced", node.test, ast.Constant(what))
            return node
        uid = self._uid_next()
        carried = _collect_stores(node.body)
        if not carried:
            # nothing carried: a tensor-cond loop that changes no locals is
            # either infinite or dead; keep python semantics with a guard
            node.test = _jst("assert_not_traced", node.test,
                             ast.Constant("a 'while' that assigns no locals"))
            return node
        cf = _fn_def(f"__dy2s_wc_{uid}", carried, [], [])
        cf.body = [ast.Return(value=node.test)]
        bf = _fn_def(f"__dy2s_wb_{uid}", carried, node.body, carried)
        call = _jst("convert_while", _name(cf.name), _name(bf.name),
                    _const_tuple(carried),
                    ast.Tuple(elts=[_ld_call(n) for n in carried],
                              ctx=ast.Load()))
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[_name(n, ast.Store()) for n in carried],
                ctx=ast.Store())],
            value=call)
        return [cf, bf, assign]

    # ---- for --------------------------------------------------------------
    def visit_For(self, node):
        self.generic_visit(node)
        if _has_toplevel_loop_escape(node.body) or node.orelse or \
                _has_attr_store(node.body):
            what = "a 'for' with an 'else' clause" if node.orelse else (
                "a 'for' whose body assigns an object attribute"
                if _has_attr_store(node.body)
                else "a 'for' whose body contains 'return'")
            node.iter = _jst("assert_not_traced", node.iter, ast.Constant(what))
            return node
        uid = self._uid_next()
        carried = _collect_stores(node.body)
        # the loop target is rebound each iteration, not carried
        tgt_names = _collect_stores(
            [ast.Assign(targets=[node.target], value=ast.Constant(0))])
        carried = [n for n in carried if n not in tgt_names]
        it = node.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range":
            it = _jst("maybe_range", *it.args)
        # body_fn(target, *carried); the loop target LEAKS into the
        # enclosing scope in python, so convert_for returns (last, *carry)
        # and we rebind it (simple-Name targets; tuple targets discard)
        if isinstance(node.target, ast.Name):
            params = [node.target.id] + carried
            prelude = []
            out_names = [node.target.id]
            tgt0 = _ld_call(node.target.id)
            tgt_ret = node.target.id
        else:
            params = ["__dy2s_item"] + carried
            prelude = [ast.Assign(targets=[node.target],
                                  value=_name("__dy2s_item"))]
            out_names = [f"__dy2s_last_{uid}"]
            tgt0 = ast.Constant(None)
            tgt_ret = "__dy2s_item"
        # body returns (target, *carried): python leaks the target's final
        # binding, including reassignments inside the body
        bf = _fn_def(f"__dy2s_fb_{uid}", params, prelude + node.body,
                     [tgt_ret] + carried)
        call = _jst("convert_for", it, _name(bf.name),
                    _const_tuple(carried),
                    ast.Tuple(elts=[_ld_call(n) for n in carried],
                              ctx=ast.Load()),
                    tgt0)
        assign = ast.Assign(
            targets=[ast.Tuple(
                elts=[_name(n, ast.Store()) for n in out_names + carried],
                ctx=ast.Store())],
            value=call)
        return [bf, assign]


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def convert_to_static(fn):
    """Source -> AST -> (break/continue lowering, control-flow rewrite) ->
    recompiled function. Closure variables are materialized as globals of the
    transformed function (reference: program_translator.py transforms to a
    temp file + exec; same trade-off: closure cells are snapshotted)."""
    if getattr(fn, "__dy2static_transformed__", False):
        return fn
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
        raise Dy2StaticError(f"cannot transform {fn!r}: not a function def")
    # constructs the rewrite cannot preserve -> plain ValueError so
    # maybe_transform falls back to raw tracing with a warning
    for sub in ast.walk(fdef):
        if isinstance(sub, (ast.Yield, ast.YieldFrom, ast.Await)):
            raise ValueError("generator/async function")
        if isinstance(sub, (ast.Global, ast.Nonlocal)):
            raise ValueError("global/nonlocal declaration")
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "super" and not sub.args:
            raise ValueError("zero-argument super() needs its class cell")
    fdef.decorator_list = []
    fdef.body = _apply_passes(fdef.body)
    fdef.name = fn.__name__ + "__dy2static"
    mod = ast.Module(body=[fdef], type_ignores=[])
    ast.fix_missing_locations(mod)
    code = compile(mod, filename=f"<dy2static {fn.__qualname__}>",
                   mode="exec")
    # chain to the LIVE module globals (late rebinding / monkeypatching of
    # module-level helpers keeps working); only the injected helper module
    # and the closure-cell snapshot live in the overlay
    extra = {_JST: _module()}
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                extra[name] = cell.cell_contents
            except ValueError:
                pass
    glb = _ChainGlobals(fn.__globals__, extra)
    ns = {}
    exec(code, glb, ns)
    new = ns[fdef.name]
    new = functools.wraps(fn)(new)
    del new.__wrapped__   # a back-ref to fn would defeat the weak caches
    new.__defaults__ = fn.__defaults__
    new.__kwdefaults__ = fn.__kwdefaults__
    new.__dy2static_transformed__ = True
    return new


def _apply_passes(body):
    body = _EarlyReturnLowering().transform(body)
    holder = ast.Module(body=body, type_ignores=[])
    holder = _BreakContinueLowering().visit(holder)
    holder = _ControlFlowTransformer().visit(holder)
    return holder.body


class _ChainGlobals(dict):
    """exec globals overlay: generated names resolve here, everything else
    falls through to the function's live module globals (CPython honors
    __missing__ on dict subclasses for LOAD_GLOBAL)."""

    def __init__(self, base, extra):
        super().__init__(extra)
        self._base = base

    def __missing__(self, key):
        return self._base[key]


def _module():
    return sys.modules[__name__]


# one transform per underlying function object, shared by every Layer
# instance / StaticFunction binding (deepcopied encoder stacks would
# otherwise re-parse the same source N times)
_transform_cache = weakref.WeakKeyDictionary()


def maybe_transform(fn):
    """Best-effort entry used by @to_static: transform when source is
    available; fall back to the raw function (plain tracing) otherwise."""
    from . import ProgramTranslator
    if not ProgramTranslator.enable_to_static:
        return fn
    try:
        out = _transform_cache[fn]
        return fn if out is _PASSTHROUGH else out
    except (KeyError, TypeError):
        pass
    try:
        out = convert_to_static(fn)
    except Dy2StaticError:
        raise
    except Exception as e:  # source unavailable, exotic syntax, ...
        warnings.warn(f"dy2static: falling back to plain tracing for "
                      f"{getattr(fn, '__qualname__', fn)}: {e}")
        out = fn
    try:
        _transform_cache[fn] = _PASSTHROUGH if out is fn else out
    except TypeError:
        pass
    return out
