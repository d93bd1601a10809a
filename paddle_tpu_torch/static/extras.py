"""paddle.static surface completion (reference: python/paddle/static/
__init__.py __all__): scopes, autodiff entry points, serialization,
place helpers, EMA, metrics.

Counterpart of `paddle_tpu/static/extras.py`. The static "program" here
is the traced computation (see static/__init__.py); these helpers keep
the reference's call sites working on top of that model. `py_func`
under a trace is the op `paddle_tpu_torch::py_func`, which calls the
Python function on host copies of its inputs when the program runs (the
counterpart of the reference's `jax.pure_callback`).
"""
import contextlib
import pickle

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.tensor import Parameter, Tensor, _wrap, apply_op, to_tensor

__all__ = [
    "append_backward", "gradients", "global_scope", "scope_guard", "Scope",
    "Print", "py_func", "ParallelExecutor", "ExponentialMovingAverage",
    "save", "load", "serialize_program", "serialize_persistables",
    "save_to_file", "deserialize_program", "deserialize_persistables",
    "load_from_file", "normalize_program", "load_program_state",
    "set_program_state", "cpu_places", "cuda_places", "xpu_places",
    "npu_places", "mlu_places", "Variable", "create_global_var",
    "create_parameter", "accuracy", "auc", "device_guard",
    "exponential_decay", "ctr_metric_bundle", "ipu_shard_guard",
    "IpuCompiledProgram", "IpuStrategy", "set_ipu_shard",
]

Variable = Tensor          # reference framework.Variable ≙ eager Tensor here


# ------------------------------------------------------------------ scopes
class Scope:
    """Name -> Tensor map (reference: framework/scope.h Scope). Static
    programs here execute as traced functions, so the scope holds the
    persistable tensors users park in it (create_global_var etc.)."""

    def __init__(self):
        self._vars = {}

    def var(self, name):
        return self._vars.setdefault(name, to_tensor(np.zeros((),
                                                              np.float32)))

    def find_var(self, name):
        return self._vars.get(name)

    def set_var(self, name, value):
        self._vars[name] = value


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


# ------------------------------------------------------------- autodiff
def _collect_params(loss):
    """The leaves that require grad and contribute to `loss`, found by
    walking torch's autograd graph (the reference walks its tape)."""
    seen, out = set(), []
    fn = loss._data.grad_fn
    stack = [fn] if fn is not None else []
    while stack:
        f = stack.pop()
        if f is None or id(f) in seen:
            continue
        seen.add(id(f))
        var = getattr(f, "variable", None)
        if var is not None:
            out.append(_wrap(var))
            continue
        stack.extend(nf for nf, _ in f.next_functions)
    return out


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Static autodiff entry (reference: fluid/backward.py append_backward).
    The traced program IS differentiable eagerly: runs backward from `loss`
    and returns [(param, grad)] like the reference."""
    params = parameter_list
    if params is None:
        params = _collect_params(loss)
    loss.backward()
    return [(p, p.grad) for p in params if p is not None]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: paddle.static.gradients -> d(targets)/d(inputs)."""
    from ..autograd import grad as _grad
    return _grad(targets, inputs, grad_outputs=target_gradients,
                 allow_unused=True)


# ------------------------------------------------------------------ debug
def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """reference: fluid/layers/control_flow.py Print op — echoes the tensor
    and passes it through. A traced value has no data: its shape and
    dtype are printed while tracing."""
    from ..jit.dy2static import is_traced
    if message:
        print(message, end=" ")
    d = input._data if isinstance(input, Tensor) else input
    if is_traced(d):
        print(f"<traced {tuple(d.shape)} {_dt.dtype_name(d.dtype)}>")
    else:
        a = d.detach().cpu().numpy()
        print(a[:summarize] if a.ndim else a)
    return input


_PY_FUNCS = {}


@torch.library.custom_op("paddle_tpu_torch::py_func", mutates_args=())
def _py_func_op(xs: list[torch.Tensor], key: int) -> torch.Tensor:
    func, shape, dtype = _PY_FUNCS[key]
    res = np.asarray(func(*[x.detach().cpu().numpy() for x in xs]))
    return torch.as_tensor(res).to(device=xs[0].device, dtype=dtype) \
        .reshape(shape).clone()


@_py_func_op.register_fake
def _(xs, key):
    _, shape, dtype = _PY_FUNCS[key]
    return xs[0].new_empty(shape, dtype=dtype)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """reference: fluid/layers/nn.py py_func — run a python callable on
    tensors. Eager execution calls it directly on numpy copies; under a
    trace it becomes the op `paddle_tpu_torch::py_func`, with `out`'s
    shape/dtype as the result spec, and calls it when the program runs."""
    from ..jit.dy2static import is_traced
    xs = x if isinstance(x, (list, tuple)) else [x]
    datas = [t._data if isinstance(t, Tensor) else t for t in xs]
    if any(is_traced(d) for d in datas):
        key = len(_PY_FUNCS)
        _PY_FUNCS[key] = (func, tuple(out.shape),
                          _dt.convert_dtype(out.dtype))
        return Tensor(_py_func_op(list(datas), key))
    res = func(*[d.detach().cpu().numpy() for d in datas])
    return to_tensor(np.asarray(res), place=datas[0].device)


# ------------------------------------------------------ EMA (real feature)
class ExponentialMovingAverage:
    """EMA of trainable parameters (reference: fluid/optimizer.py
    ExponentialMovingAverage: shadow vars + apply()/restore() swap, with
    Adam-style bias correction when thres_steps is None).

    update() after each optimizer step; `with ema.apply(params)` swaps the
    EMA weights in for evaluation and restores on exit.
    """

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._step = 0
        self._shadow = {}      # id(param) -> ema tensor
        self._backup = {}
        self._params = []

    def update(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        self._step += 1
        with torch.no_grad():
            for p in self._params:
                d = p._data.detach()
                prev = self._shadow.get(id(p))
                if prev is None:
                    prev = torch.zeros_like(d)
                self._shadow[id(p)] = (self._decay * prev
                                       + (1.0 - self._decay) * d)

    def _debiased(self, p):
        corr = 1.0 - self._decay ** self._step
        return self._shadow[id(p)] / corr

    @contextlib.contextmanager
    def apply(self, parameters=None, need_restore=True):
        params = list(parameters) if parameters is not None else self._params
        self._backup = {id(p): p._data.detach().clone() for p in params}
        with torch.no_grad():
            for p in params:
                if id(p) in self._shadow:
                    p.set_value(Tensor(self._debiased(p)))
        try:
            yield self
        finally:
            if need_restore:
                self.restore(params)

    def restore(self, parameters=None):
        params = list(parameters) if parameters is not None else self._params
        with torch.no_grad():
            for p in params:
                if id(p) in self._backup:
                    p.set_value(Tensor(self._backup[id(p)]))
        self._backup = {}


# ----------------------------------------------------------- serialization
def _pdparams(path):
    return path if path.endswith(".pdparams") else path + ".pdparams"


def save(program, model_path, protocol=4, **configs):
    """reference paddle.static.save: persist a program's persistables. Here
    the state lives on the Layer/Program owner: accepts anything with
    state_dict() (Layer, Model) or a dict of tensors."""
    from ..framework.io import save as _save
    state = program.state_dict() if hasattr(program, "state_dict") \
        else program
    _save({k: v._data if isinstance(v, Tensor) else v
           for k, v in state.items()}, _pdparams(model_path))


def load(program, model_path, executor=None, var_list=None):
    from ..framework.io import load as _load
    state = _load(_pdparams(model_path), return_numpy=True)
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state)
        return program
    return state


def serialize_program(feed_vars, fetch_vars, **kwargs):
    """Serialized form of the feed / fetch names (reference:
    static/io.py serialize_program -> ProgramDesc bytes; the program
    itself is `jit.save`'s)."""
    return pickle.dumps({"feed": [getattr(v, "name", None)
                                  for v in feed_vars],
                         "fetch": [getattr(v, "name", None)
                                   for v in fetch_vars]})


def serialize_persistables(feed_vars, fetch_vars, **kwargs):
    params = {}
    for v in fetch_vars:
        for p in _collect_params(v) if isinstance(v, Tensor) else []:
            params[p.name or f"param_{id(p)}"] = p.numpy()
    return pickle.dumps(params)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    return pickle.loads(data)


def deserialize_persistables(program, data, executor=None):
    return {k: to_tensor(v) for k, v in pickle.loads(data).items()}


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """reference: static/io.py normalize_program prunes to the feed->fetch
    subgraph; the traced graph is already pruned by construction."""
    return program


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load
    return dict(_load(_pdparams(model_path), return_numpy=True))


def set_program_state(program, state_dict):
    if hasattr(program, "set_state_dict"):
        program.set_state_dict(state_dict)
    return program


# ------------------------------------------------------------- places
def cpu_places(device_count=None):
    from ..core.device import CPUPlace
    return [CPUPlace(i) for i in range(device_count or 1)]


def cuda_places(device_ids=None):
    """reference: cuda_places -> one CUDAPlace per card."""
    from ..core.device import CUDAPlace
    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    return cuda_places(device_ids)


def npu_places(device_ids=None):
    return cuda_places(device_ids)


def mlu_places(device_ids=None):
    return cuda_places(device_ids)


@contextlib.contextmanager
def device_guard(device=None):
    """reference: static/__init__ device_guard — pin ops to a device."""
    from ..core.device import get_device, set_device
    prev = get_device()
    if device:
        set_device(device)
    try:
        yield
    finally:
        set_device(prev)


# ------------------------------------------------------------ factories
def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    t = to_tensor(np.full(tuple(shape), value),
                  dtype=_dt.convert_dtype(dtype))
    t.name = name
    t.persistable = persistable
    if name:
        global_scope().set_var(name, t)
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A Parameter initialized by `default_initializer` (XavierUniform,
    or zeros for a bias) on the current place."""
    from ..core.device import place_device
    from ..nn.initializer import Constant, XavierUniform
    init = default_initializer or (Constant(0.0) if is_bias
                                   else XavierUniform())
    d = _dt.convert_dtype(dtype)
    return Parameter(init(tuple(shape), d, place_device(None)), name=name)


# ------------------------------------------------------------- metrics
def accuracy(input, label, k=1, correct=None, total=None):
    from ..metric import accuracy as _acc
    return _acc(input, label, k=k)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC (reference: fluid/layers/metric_op.py auc). Returns the
    current-batch AUC value computed exactly (sorted ranks, no bucketing)."""
    def fn(x, y):
        pos_score = x[:, 1] if x.dim() == 2 and x.shape[1] == 2 else \
            x.reshape(x.shape[0], -1)[:, -1]
        y = y.reshape(-1).float()
        # average ranks for ties (plain argsort would make tied scores'
        # AUC depend on input order)
        srt = torch.sort(pos_score).values
        lo = torch.searchsorted(srt, pos_score, right=False)
        hi = torch.searchsorted(srt, pos_score, right=True)
        ranks = (lo + hi + 1).float() / 2.0
        n_pos = y.sum()
        n_neg = y.shape[0] - n_pos
        rank_sum = torch.where(y > 0, ranks, torch.zeros_like(ranks)).sum()
        denom = torch.clamp(n_pos * n_neg, min=1.0)
        return (rank_sum - n_pos * (n_pos + 1) / 2) / denom
    return apply_op(fn, input, label)


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    """reference: fluid/layers/metric_op.py ctr_metric_bundle -> (auc,
    batch_auc, batch_stat_pos, batch_stat_neg) condensed to the two AUC
    values here (exact, unbucketed)."""
    a = auc(input, label)
    return a, a


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """reference: fluid/layers/learning_rate_scheduler.py exponential_decay:
    lr * decay_rate^(step/decay_steps), floored per window if staircase."""
    from ..optimizer.lr import LambdaDecay

    def factor(step):
        e = step / float(decay_steps)
        if staircase:
            e = float(int(e))
        return decay_rate ** e

    return LambdaDecay(learning_rate=learning_rate, lr_lambda=factor)


# ------------------------------------------------------------- IPU (descoped)
def _ipu_descoped(*a, **k):
    raise RuntimeError(
        "IPU support is descoped: the port targets one CUDA backend "
        "(PARITY.md 'vendor backends'); use the default device")


ipu_shard_guard = _ipu_descoped
set_ipu_shard = _ipu_descoped


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        _ipu_descoped()


class IpuStrategy:
    def __init__(self, *a, **k):
        _ipu_descoped()


class ParallelExecutor:
    """reference: compiler.py CompiledProgram/ParallelExecutor — this
    facade keeps construction sites alive and delegates run() to
    Executor."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, scope=None):
        from . import Executor
        self._exe = Executor()
        self._program = main_program

    def run(self, fetch_list=None, feed=None, return_numpy=True):
        return self._exe.run(program=self._program, feed=feed,
                             fetch_list=fetch_list, return_numpy=return_numpy)
