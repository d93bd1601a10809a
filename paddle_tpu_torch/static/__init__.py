"""paddle.static: the declarative-graph surface.

Counterpart of `paddle_tpu/static/__init__.py`. Reference:
python/paddle/static (Program/Executor over ProgramDesc,
framework.py:5223). The reference's Program is a captured jaxpr; the
port's is a `torch.fx` graph at the aten level, made by `make_fx` over
fake tensors (`jit.trace_program`), whose subgraphs hold `cond` /
`while_loop` / `scan` (ROADMAP C.18). `ops()` / `var_names()` /
`to_string()` read the graph (the op types are aten names: `mm` where
a jaxpr says `dot_general`), `apply_pass` rewrites it (`ir_pass.py`),
`run_captured` / `Executor.run` run it. `save_inference_model` /
`load_inference_model` go through `jit.save` / `jit.load`.
"""
import contextlib
import copy
import re
import warnings

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor
from ..jit import to_static  # noqa: F401
from ..nn.param_attr import ParamAttr


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = _dt.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")


def op_type(target):
    """The op name a graph node calls: `mm` for aten.mm.default, `cond`
    for the cond HOP, `flash_fwd` for paddle_tpu_torch::flash_fwd."""
    name = target.name() if hasattr(target, "name") else \
        getattr(target, "__name__", str(target))
    return name.split("::")[-1].split(".")[0]


def _is_op(node):
    import operator
    return node.op == "call_function" and node.target is not operator.getitem


class OpDesc:
    """One op of the program IR (reference: framework/op_desc.h). Built from
    a graph node: `type` is the op name, inputs/outputs are the node
    names, attrs are the non-tensor arguments."""

    def __init__(self, node):
        import torch.fx
        self._type = op_type(node.target)
        self._inputs = [a.name for a in node.all_input_nodes]
        self._outputs = [node.name]
        self._attrs = {}
        for i, a in enumerate(node.args):
            if not isinstance(a, (torch.fx.Node, list, tuple, dict)):
                self._attrs[f"arg{i}"] = a
        for k, v in node.kwargs.items():
            if isinstance(v, (int, float, bool, str, tuple, torch.dtype)):
                self._attrs[k] = v

    def type(self):
        return self._type

    def input_arg_names(self):
        return list(self._inputs)

    def output_arg_names(self):
        return list(self._outputs)

    def attr(self, name):
        return self._attrs.get(name)

    def attr_names(self):
        return list(self._attrs)

    def __repr__(self):
        return (f"{{Op({self._type}) inputs: {self._inputs} "
                f"outputs: {self._outputs}}}")


class Program:
    """A deferred computation built under program_guard by `data`
    placeholders + user ops.

    The IR surface (reference ProgramDesc, framework/program_desc.h) is a
    captured graph: `Program.capture(fn, *specs)` traces fn once and the
    resulting Program exposes `ops()` / `var_names()` / `to_string()` over
    it."""

    def __init__(self):
        self._inputs = {}        # name -> InputSpec
        self._gm = None          # torch.fx.GraphModule when captured
        self.random_seed = None

    @classmethod
    def capture(cls, fn, *input_specs, device=None):
        """Trace `fn` over InputSpec (or example tensor) args into a
        Program with an inspectable op graph, on `device` (default: the
        current place). None dims become 1, as in the reference."""
        from ..core.device import place_device
        from ..jit import trace_program

        dev = place_device(device)
        examples = []
        for s in input_specs:
            if isinstance(s, InputSpec):
                shape = tuple(1 if (d is None or d < 0) else d
                              for d in s.shape)
                examples.append(torch.zeros(shape, dtype=s.dtype,
                                            device=dev))
            else:
                examples.append(s._data if isinstance(s, Tensor) else s)

        def raw_fn(*args):
            outs = fn(*[Tensor(a) for a in args])
            outs = outs if isinstance(outs, (tuple, list)) else [outs]
            return [o._data if isinstance(o, Tensor) else o for o in outs]

        prog = cls()
        prog._gm = trace_program(raw_fn, examples)
        for i, s in enumerate(input_specs):
            name = getattr(s, "name", None) or f"input_{i}"
            prog._inputs[name] = s
        return prog

    @property
    def graph_module(self):
        return self._gm

    # ------------------------------------------------- IR inspection
    def ops(self):
        if self._gm is None:
            return []
        return [OpDesc(n) for n in self._gm.graph.nodes if _is_op(n)]

    def var_names(self):
        if self._gm is None:
            return []
        return sorted(n.name for n in self._gm.graph.nodes
                      if n.op in ("placeholder", "call_function", "get_attr"))

    # ------------------------------------------------- IR rewriting
    def apply_pass(self, rule, attrs=None):
        """Rewrite the captured IR with a pass rule (see static/ir_pass.py):
        `rule(op, attrs) -> None | replacement outputs`. Replaces this
        Program's graph (reference passes mutate the ProgramDesc,
        ir/pass.h:69) and returns self. Raises if the Program was not built
        with Program.capture."""
        if self._gm is None:
            raise ValueError(
                "apply_pass needs a captured IR — build the Program with "
                "Program.capture(fn, *input_specs)")
        from .ir_pass import apply_rule
        a = dict(attrs or {})
        self._gm = apply_rule(self._gm, lambda op: rule(op, a))
        return self

    def _device(self):
        for n in self._gm.graph.nodes:
            v = n.meta.get("val")
            if n.op == "placeholder" and isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def run_captured(self, *args):
        """Execute the captured (possibly pass-rewritten) graph on concrete
        inputs; returns the raw output list."""
        if self._gm is None:
            raise ValueError("no captured IR")
        dev = self._device()
        flat = [a._data if isinstance(a, Tensor) else
                a if isinstance(a, torch.Tensor) else
                torch.as_tensor(np.asarray(a), device=dev) for a in args]
        return list(self._gm(*flat))

    @property
    def num_blocks(self):
        return 1

    def block(self, i=0):
        return self

    def to_string(self, throw_on_error=False, with_details=False):
        """The graph and its subgraphs as code, with dtypes, shapes and
        annotations (a pass's tags) on each line."""
        if self._gm is None:
            return "Program(untraced — build with Program.capture)"
        return self._gm.print_readable(print_output=False)

    def __str__(self):
        return self.to_string()

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return copy.copy(self)


_default_main = Program()
_default_startup = Program()
_guard_stack = []


def default_main_program():
    return _guard_stack[-1][0] if _guard_stack else _default_main


def default_startup_program():
    return _guard_stack[-1][1] if _guard_stack else _default_startup


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program or Program()

    def __enter__(self):
        _guard_stack.append((self.main, self.startup))
        return self

    def __exit__(self, *exc):
        _guard_stack.pop()
        return False


def data(name, shape, dtype="float32", lod_level=0):
    """Static placeholder. Static programs here are traced from the user
    fn with real inputs, so `data` returns a named tensor of zeros
    (shape[0]=-1 -> 1 for the spec) and records its spec."""
    from ..core.tensor import to_tensor
    spec_shape = tuple(1 if (s is None or s < 0) else s for s in shape)
    t = to_tensor(np.zeros(spec_shape), dtype=_dt.convert_dtype(dtype))
    t.name = name
    prog = default_main_program()
    prog._inputs[name] = InputSpec(shape, dtype, name)
    return t


def _natural_key(k):
    m = re.search(r"(\d+)$", k)
    return (k[:m.start()], int(m.group(1))) if m else (k, -1)


class Executor:
    """paddle.static.Executor facade: `run` executes a captured Program
    or a loaded program against the feed dict."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, return_numpy=True):
        # captured Program (possibly pass-rewritten): execute its graph
        # against the feed dict, feeds matched by the capture's input names
        if isinstance(program, Program) and program._gm is not None:
            feed = feed or {}
            args = []
            for name in program._inputs:
                if name not in feed:
                    raise KeyError(
                        f"Executor.run: feed is missing input {name!r} "
                        f"(captured inputs: {list(program._inputs)})")
                args.append(np.asarray(feed[name]))
            outs = program.run_captured(*args)
            if return_numpy:
                outs = [o.detach().cpu().numpy() for o in outs]
            return list(outs)
        # load_inference_model returns a callable program (TranslatedLayer):
        # execute it paddle-style with the feed dict in feed-name order
        if callable(program):
            from ..core.tensor import to_tensor
            feed = feed or {}
            saved = getattr(program, "_feed_names", None)
            if saved:
                # exact-name matching against the artifact's saved inputs;
                # mismatch is a LOUD error, never a silent reorder
                missing = [n for n in saved if n not in feed]
                extra = sorted(k for k in feed if k not in saved)
                if missing or extra:
                    raise KeyError(
                        f"Executor.run: feed keys {sorted(feed)} do not "
                        f"match the program's saved inputs {saved} "
                        f"(missing: {missing}, unexpected: {extra})")
                ordered = saved
            else:
                # legacy artifact without names: natural sort
                # (input_10 after input_2)
                ordered = sorted(feed.keys(), key=_natural_key)
                warnings.warn(
                    f"Executor.run: artifact "
                    f"{type(program).__name__!r} was saved without feed "
                    f"names (_feed_names); feeds are being bound by "
                    f"NATURAL-SORTED key order {ordered} — a silent "
                    f"reorder hazard if your feed names do not sort like "
                    f"the original input order. Re-export the model with "
                    f"paddle.jit.save (which records input names) to get "
                    f"exact-name matching.",
                    DeprecationWarning, stacklevel=2)
            dev = getattr(program, "_place_device", None)
            args = [to_tensor(np.asarray(feed[k]), place=dev)
                    for k in ordered]
            out = program(*args)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            if return_numpy:
                outs = [o.numpy() if isinstance(o, Tensor) else np.asarray(o)
                        for o in outs]
            return outs
        outs = []
        for f in (fetch_list or []):
            if isinstance(f, Tensor):
                outs.append(f.numpy() if return_numpy else f)
            else:
                outs.append(f)
        return outs


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self.program = program


class BuildStrategy:
    """Reference: framework/details/build_strategy.h. The port has no
    graph compiler behind these switches; kept for config-surface
    parity."""

    def __init__(self):
        self.fuse_elewise_add_act_ops = True
        self.fuse_bn_act_ops = True
        self.enable_auto_fusion = True
        self.memory_optimize = True
        self.reduce_strategy = None
        self.gradient_scale_strategy = None


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


def name_scope(prefix=None):
    return contextlib.nullcontext()


class WeightNormParamAttr(ParamAttr):
    """paddle.static.WeightNormParamAttr (reference: fluid/param_attr.py
    WeightNormParamAttr): ParamAttr that requests the weight-norm
    g·v/||v|| reparameterization along `dim`. The dygraph path applies it
    via nn.utils.weight_norm; this attr records the request so layer
    constructors taking param_attr can apply the same hook."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable,
                         need_clip=need_clip)
        self.dim = dim
        self.do_model_average = do_model_average


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """paddle.static.save_inference_model equivalent.

    Reference (fluid/io.py) serializes a pruned ProgramDesc + params. Our
    static programs execute by tracing, so the computation to save must be
    a callable: pass the Layer (or function) as `program` (or as
    `fetch_vars` when it is callable), with `feed_vars` a list of
    InputSpec/example Tensors. Writes `{path}.pdmodel` + `{path}.pdiparams`
    readable by inference.Config/Predictor and jit.load."""
    from ..jit import save as _jit_save
    from ..nn.layer.layers import Layer

    target = program if program is not None else fetch_vars
    if isinstance(target, Layer):
        _jit_save(target, path_prefix, input_spec=list(feed_vars))
        return
    if callable(target):
        _jit_save(_FnLayer(target), path_prefix, input_spec=list(feed_vars))
        return
    raise TypeError(
        "save_inference_model needs the computation as a callable: pass the "
        "Layer/function via fetch_vars or program=. (Static-graph Variables "
        "carry no graph here — the traced program is the program.)")


def _FnLayer(fn):
    """Wrap a bare function as a parameter-less Layer so it rides jit.save."""
    from ..nn.layer.layers import Layer

    class _Wrapped(Layer):
        def forward(self, *args):
            return fn(*args)

    return _Wrapped()


def load_inference_model(path_prefix, executor=None, device=None, **kwargs):
    """Returns (program, feed_names, fetch_names) paddle-style; `program`
    is a TranslatedLayer — call it directly, or use Executor.run with feeds."""
    from ..jit import load as _jit_load
    layer = _jit_load(path_prefix, device=device)
    if layer._feed_names:
        feed_names = list(layer._feed_names)
    else:   # legacy artifact without saved names
        feed_names = [f"input_{i}" for i in range(max(layer._n_inputs, 0))]
    fetch_names = [f"output_{i}" for i in range(layer._n_outputs)]
    return layer, feed_names, fetch_names


from . import nn  # noqa: E402
from . import amp  # noqa: E402
from . import sparsity  # noqa: E402
from .extras import *  # noqa: F401,F403,E402
