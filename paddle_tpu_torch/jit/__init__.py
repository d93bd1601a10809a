"""paddle.jit: `to_static`, `save`, `load`, `TracedLayer`.

Counterpart of `paddle_tpu/jit/__init__.py`. The reference's program is
the jaxpr `jax.jit` traces and its artifact the StableHLO `jax.export`
writes. The port's (ROADMAP C.18):

  * `to_static` traces the (dy2static-rewritten) forward into a
    `torch.fx` graph at the aten level with `make_fx` over fake tensors,
    one graph for each train flag and input signature (shapes, dtypes,
    devices and the non-tensor arguments, which are baked in), as
    `jax.jit` keys its cache. A Layer's graph is made over
    `functional_call(layer, params, buffers, ...)`, so its weights are
    inputs, not constants, and buffer updates (BatchNorm statistics) are
    outputs written back after each call. The program is forward only:
    its outputs carry no tape, as the reference's do not. Random ops
    draw inside the program, so every call draws anew (the reference
    threads a fresh key into each call);
  * `save` writes `path.pdmodel`, a `torch.export` `ExportedProgram`
    of the eval-mode forward over `(params, buffers, inputs)` saved with
    `torch.export.save`, and `path.pdiparams`, the `framework.io` payload
    `{"params", "buffers", "feed_names"}` that both packages read. A
    `None` (or -1) dim at position j of an InputSpec is one
    `torch.export.Dim` shared by every input, as the reference's
    `_to_arg_specs` shares one symbol by position;
  * `load` gives a `TranslatedLayer` over `ExportedProgram.module()`. A
    program is traced on one device, and the attention route it holds
    is that device's (`nn.functional.attention.sdpa_route`): loading it
    for another device type raises, naming the device it was traced on,
    as a `jax.export` artifact lowered for one platform refuses another.

The flash kernels trace as the custom ops `paddle_tpu_torch::flash_*`
(`ops/flash_attention.py`), so a program traced on the card runs the
hand-written kernels when it runs there.
"""
import io
import logging
import os
import zipfile

import torch
from torch.utils import _pytree as pytree

from ..core.tensor import Tensor
from ..nn.layer.layers import Layer, functional_call, functional_state

__all__ = ["to_static", "save", "load", "not_to_static", "TracedLayer",
           "TranslatedLayer", "StaticFunction", "ProgramTranslator",
           "set_code_level", "set_verbosity"]

MODEL_SUFFIX = ".pdmodel"      # torch.export ExportedProgram (zip)
PARAMS_SUFFIX = ".pdiparams"   # params + buffers + feed names payload


def _raw(x):
    return x._data if isinstance(x, Tensor) else x


def _is_tensor(x):
    return isinstance(x, (Tensor, torch.Tensor))


def trace_program(fn, example):
    """`make_fx` of fn over fake copies of the torch tensors `example`:
    the port's counterpart of `jax.make_jaxpr`. Real tensors fn reads
    from elsewhere become constants of the graph."""
    from torch.fx.experimental.proxy_tensor import make_fx
    with torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*example)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm


def _signature(args):
    key = []
    for a in args:
        r = _raw(a)
        if isinstance(r, torch.Tensor):
            key.append(("T", tuple(r.shape), r.dtype, r.device.type,
                        r.device.index))
        else:
            try:
                hash(a)
                key.append(("C", type(a), a))
            except TypeError:
                key.append(("C", type(a), id(a)))
    return tuple(key)


class _Program:
    """One traced program: the graph, and how its flat outputs rebuild
    the function's output."""

    def __init__(self, gm, out_spec, out_is_t, out_consts, n_buffers):
        self.gm = gm
        self.out_spec = out_spec
        self.out_is_t = out_is_t
        self.out_consts = out_consts
        self.n_buffers = n_buffers

    def outputs(self, flat):
        it = iter(flat)
        leaves = [Tensor(next(it), stop_gradient=True) if t else c
                  for t, c in zip(self.out_is_t, self.out_consts)]
        return pytree.tree_unflatten(leaves, self.out_spec)


def _split_out(out, record):
    leaves, spec = pytree.tree_flatten(
        out, is_leaf=lambda x: isinstance(x, Tensor))
    is_t = [_is_tensor(l) for l in leaves]
    record["spec"] = spec
    record["is_t"] = is_t
    record["consts"] = [None if t else l for l, t in zip(leaves, is_t)]
    return [_raw(l) for l, t in zip(leaves, is_t) if t]


class StaticFunction:
    """A traced callable over a Layer method or a free function: one
    graph for each train flag and input signature."""

    def __init__(self, fn, layer=None, input_spec=None):
        self._fn = fn
        self._layer = layer
        self._input_spec = input_spec
        self._cache = {}
        self._tfn = None

    def _transformed(self):
        """dy2static-rewritten function (tensor-dependent if/while/for ->
        traced control-flow ops); the raw function when the source can't
        be transformed. Reference: program_translator.py:1001."""
        if self._tfn is None:
            from . import dy2static
            self._tfn = dy2static.maybe_transform(self._fn)
        return self._tfn

    def __get__(self, instance, owner):
        if instance is None:
            return self
        # cache the bound StaticFunction in the instance dict so repeated
        # calls reuse one program cache (instance attrs shadow this
        # non-data descriptor, so later lookups skip __get__ entirely)
        name = self._fn.__name__
        bound = instance.__dict__.get(name)
        if not (isinstance(bound, StaticFunction) and bound._fn is self._fn):
            bound = StaticFunction(self._fn, layer=instance,
                                   input_spec=self._input_spec)
            instance.__dict__[name] = bound
        return bound

    @property
    def concrete_programs(self):
        """The traced graphs, by (train flag, input signature)."""
        return {k: p.gm for k, (p, _) in self._cache.items()}

    def _build(self, train, args):
        layer = self._layer
        fn = self._transformed()
        t_idx = [i for i, a in enumerate(args) if _is_tensor(a)]
        record = {}
        if layer is None:
            pnames, bnames = [], []
            state = []
        else:
            params, buffers = functional_state(layer)
            pnames, bnames = list(params), list(buffers)
            state = [params[n] for n in pnames] + [buffers[n] for n in bnames]
        n_p, n_b = len(pnames), len(bnames)

        def flat_fn(*flat):
            call_args = list(args)
            for j, i in enumerate(t_idx):
                call_args[i] = Tensor(flat[n_p + n_b + j])
            if layer is None:
                return tuple(_split_out(fn(*call_args), record))
            out, new_b = functional_call(
                layer, dict(zip(pnames, flat[:n_p])),
                dict(zip(bnames, flat[n_p:n_p + n_b])),
                args=tuple(call_args), train=train, method=fn)
            return tuple(_split_out(out, record)) + \
                tuple(new_b[n] for n in bnames)

        gm = trace_program(flat_fn, state + [_raw(args[i]) for i in t_idx])
        return _Program(gm, record["spec"], record["is_t"],
                        record["consts"], n_b), t_idx

    def _inline(self, args):
        """Called while an enclosing program traces: no program of its
        own, the transformed function runs inside the enclosing trace."""
        fn = self._transformed()
        if self._layer is None:
            return fn(*args)
        return fn(self._layer, *args)

    def __call__(self, *args):
        from .dy2static import is_traced
        if any(is_traced(a) for a in args):
            return self._inline(args)
        train = self._layer.training if self._layer is not None else True
        key = (train,) + _signature(args)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = self._build(train, args)
        prog, t_idx = entry
        state = []
        if self._layer is not None:
            params, buffers = functional_state(self._layer)
            state = list(params.values()) + list(buffers.values())
        with torch.no_grad():
            flat = prog.gm(*state, *[_raw(args[i]) for i in t_idx])
        flat = list(flat)
        if prog.n_buffers:
            new_b = flat[len(flat) - prog.n_buffers:]
            flat = flat[:len(flat) - prog.n_buffers]
            for (n, b), v in zip(self._layer.named_buffers(), new_b):
                b._data = v
        return prog.outputs(flat)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    def decorate(fn):
        if isinstance(fn, Layer):
            fwd = fn.forward
            fn.forward = StaticFunction(getattr(fwd, "__func__", fwd),
                                        layer=fn, input_spec=input_spec)
            return fn
        return StaticFunction(fn, input_spec=input_spec)
    if function is not None:
        return decorate(function)
    return decorate


# ------------------------------------------------------------------ export
class _ExportAdapter(torch.nn.Module):
    """The module `torch.export` sees: weights and inputs are arguments,
    the Layer's eval-mode forward is the body."""

    def __init__(self, layer, method=None):
        super().__init__()
        self._layer = layer
        self._method = method

    def forward(self, params, buffers, inputs):
        out, _ = functional_call(self._layer, params, buffers,
                                 args=tuple(Tensor(a) for a in inputs),
                                 train=False, method=self._method)
        return pytree.tree_map(_raw, out,
                               is_leaf=lambda x: isinstance(x, Tensor))


def _specs(input_spec):
    from ..static import InputSpec
    out = []
    for s in input_spec:
        if isinstance(s, Tensor):
            s = InputSpec.from_tensor(s)
        elif isinstance(s, torch.Tensor):
            s = InputSpec(tuple(s.shape), s.dtype)
        out.append(s)
    return out


# the example size of a dynamic dim: torch.export specializes 0 and 1
_EXAMPLE_DIM = 2


def _export_layer(layer, input_spec):
    """Export the layer's eval-mode forward over (params, buffers, inputs)
    on the device its weights live on (the current place for a layer
    without weights)."""
    from ..core.device import place_device
    params, buffers = functional_state(layer)
    first = next(iter(list(params.values()) + list(buffers.values())), None)
    dev = first.device if first is not None else place_device(None)
    dims, examples, shapes = {}, [], []
    for s in _specs(input_spec):
        spec_dims, shape = {}, []
        for j, d in enumerate(s.shape):
            if d is None or (isinstance(d, int) and d < 0):
                # dynamic dims at the same POSITION share one Dim — two
                # [None, 8] inputs get the same batch dim
                if j not in dims:
                    dims[j] = torch.export.Dim(f"dim{j}", min=1)
                spec_dims[j] = dims[j]
                shape.append(_EXAMPLE_DIM)
            else:
                shape.append(int(d))
        examples.append(torch.zeros(shape, dtype=s.dtype, device=dev))
        shapes.append(spec_dims or None)
    method = None
    fwd = layer.__dict__.get("forward")
    if isinstance(fwd, StaticFunction):
        method = fwd._transformed()
    adapter = _ExportAdapter(layer, method)
    dyn = ({n: None for n in params}, {n: None for n in buffers},
           tuple(shapes))
    with torch.no_grad():
        ep = torch.export.export(adapter, (params, buffers, tuple(examples)),
                                 dynamic_shapes=dyn, strict=False)
    # the example inputs hold the weights: they belong in .pdiparams only
    ep._example_inputs = None
    return ep, params, buffers


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save: writes `path.pdmodel` (the exported eval-mode
    program, dynamic over None dims) + `path.pdiparams` (weights and
    feed names).

    Reference: python/paddle/fluid/dygraph/jit.py jit.save →
    TranslatedLayer (program + params via fluid/jit/serializer.cc)."""
    from ..framework.io import save as _save
    from ..static import InputSpec

    if isinstance(layer, StaticFunction):
        raise TypeError("pass the Layer itself, not its StaticFunction")
    if input_spec is None:
        # a @to_static(input_spec=...) forward carries the spec already
        fwd = getattr(layer, "forward", None)
        input_spec = getattr(fwd, "_input_spec", None)
    if input_spec is None:
        raise ValueError("paddle_tpu_torch.jit.save requires input_spec "
                         "(list of InputSpec or example Tensors), or a "
                         "forward decorated @to_static(input_spec=...)")
    ep, params, buffers = _export_layer(layer, input_spec)
    feed_names = []
    for i, s in enumerate(input_spec):
        n = s.name if isinstance(s, (InputSpec, Tensor)) else None
        feed_names.append(n or f"input_{i}")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path + MODEL_SUFFIX, "wb") as f:
        torch.export.save(ep, f)
    _save({"params": params, "buffers": buffers, "feed_names": feed_names},
          path + PARAMS_SUFFIX)


def traced_device(ep):
    """The device the program's inputs were traced on."""
    for n in ep.graph.nodes:
        if n.op == "placeholder":
            v = n.meta.get("val")
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


def load_program(model_file, device):
    """The ExportedProgram in `model_file`, refused unless it was traced
    for `device`'s type."""
    if not zipfile.is_zipfile(model_file):
        raise ValueError(
            f"{model_file} is not a torch.export program: a .pdmodel the "
            f"JAX package wrote (a jax.export StableHLO module) cannot run "
            f"in the port; re-save the Layer with paddle_tpu_torch.jit.save "
            f"(the .pdiparams both packages write loads in either)")
    with open(model_file, "rb") as f:
        ep = torch.export.load(io.BytesIO(f.read()))
    traced = traced_device(ep)
    if traced.type != device.type:
        raise RuntimeError(
            f"{model_file} was traced on {traced}; it cannot run on "
            f"{device}: a program holds the attention route of the device "
            f"it was traced on (the plain attention on the CPU, the flash "
            f"kernel on CUDA). Save it again on {device.type}")
    return ep


class TranslatedLayer(Layer):
    """A deserialized program + weights, callable like the original Layer
    (inference only — the exported program is the eval-mode forward)."""

    def __init__(self, exported, params, buffers, feed_names=None):
        super().__init__()
        self._exported = exported
        self._program = exported.module()
        self._param_tree = params
        self._buffer_tree = buffers
        self._feed_names = feed_names   # saved input names (None: old artifact)
        self._place_device = traced_device(exported)
        sig = exported.graph_signature
        self._n_inputs = len(sig.user_inputs) - len(params) - len(buffers)
        self._n_outputs = len(sig.user_outputs)

    def forward(self, *inputs):
        raw = tuple(_raw(a) for a in inputs)
        with torch.no_grad():
            out = self._program(self._param_tree, self._buffer_tree, raw)
        if isinstance(out, (tuple, list)):
            return type(out)(Tensor(o, stop_gradient=True) for o in out)
        return Tensor(out, stop_gradient=True)

    def state_dict(self, *a, **k):
        d = dict(self._param_tree)
        d.update(self._buffer_tree)
        return {n: Tensor(v, stop_gradient=True) for n, v in d.items()}


def load(path, device=None, **configs):
    """paddle.jit.load → TranslatedLayer on `device` (default: the
    current place)."""
    from ..core.device import place_device
    from ..framework.io import load as _load

    dev = place_device(device)
    ep = load_program(path + MODEL_SUFFIX, dev)
    payload = _load(path + PARAMS_SUFFIX, device=dev)
    return TranslatedLayer(ep, payload["params"], payload["buffers"],
                           feed_names=payload.get("feed_names"))


def not_to_static(fn=None):
    """Mark a function as exempt from dy2static rewriting (reference:
    jit/api.py not_to_static); convert_call passes it through untouched.
    Usable bare or as a zero-arg decorator factory."""
    if fn is None:
        return not_to_static
    try:
        fn.__dy2static_transformed__ = True
    except (AttributeError, TypeError):
        pass
    return fn


class TracedLayer:
    """Trace a dygraph Layer once into a static Program (a captured graph)
    with its eval-mode weights baked in; run it program-style or export
    it.

    Reference: fluid/dygraph/jit.py:1388 TracedLayer (trace via the
    dygraph Tracer into a ProgramDesc + Executor)."""

    def __init__(self, layer, program, input_specs):
        self._layer = layer
        self._program = program
        self._input_specs = input_specs

    @staticmethod
    def trace(layer, inputs):
        """Returns (dygraph_outputs, traced_layer), reference-style."""
        from ..static import InputSpec, Program

        inputs = list(inputs)
        out = layer(*inputs)
        params, buffers = functional_state(layer)

        def pure(*ts):
            o, _ = functional_call(layer, params, buffers, args=ts,
                                   train=False)
            return o if isinstance(o, (tuple, list)) else (o,)

        specs = [InputSpec.from_tensor(t, name=f"input_{i}")
                 for i, t in enumerate(inputs)]
        prog = Program.capture(pure, *specs,
                               device=_raw(inputs[0]).device
                               if inputs else None)
        return out, TracedLayer(layer, prog, specs)

    def __call__(self, inputs):
        outs = self._program.run_captured(*inputs)
        return [Tensor(o, stop_gradient=True) for o in outs]

    @property
    def program(self):
        return self._program

    def set_strategy(self, build_strategy=None, exec_strategy=None):
        """Execution strategies have no counterpart; accepted for API
        parity."""

    def save_inference_model(self, path, feed=None, fetch=None, **configs):
        """Export for Predictor/Executor serving; `feed`/`fetch` are index
        filters over the traced inputs/outputs (reference semantics).
        `feed` may PERMUTE the inputs (the exported program takes them in
        the declared feed order); dropping inputs needs graph pruning the
        traced program does not do — a subset raises."""
        specs = self._input_specs
        layer = self._layer
        if feed is not None:
            if sorted(feed) != list(range(len(specs))):
                raise ValueError(
                    f"TracedLayer.save_inference_model: feed={feed} must be "
                    f"a permutation of all {len(specs)} traced inputs; "
                    f"dropping an input would need program pruning — "
                    f"re-trace the layer with the inputs you want instead")
            specs = [specs[i] for i in feed]
        if feed is not None or fetch is not None:
            layer = _SliceAdapter(layer, feed, fetch)
        save(layer, path, input_spec=list(specs))


class _SliceAdapter(Layer):
    """Feed-permuting / fetch-slicing wrapper used by
    TracedLayer.save_inference_model. The base layer is a REGISTERED
    sublayer so its parameters ride the export payload and eval-mode
    switching reaches it."""

    def __init__(self, base, feed, fetch):
        super().__init__()
        self.base = base
        self._feed = feed
        self._fetch = fetch

    def forward(self, *args):
        if self._feed is not None:
            # args arrive in feed order; restore the original positions
            orig = [None] * len(args)
            for pos, idx in enumerate(self._feed):
                orig[idx] = args[pos]
            args = tuple(orig)
        out = self.base(*args)
        if self._fetch is None:
            return out
        out = out if isinstance(out, (tuple, list)) else [out]
        picked = [out[i] for i in self._fetch]
        return picked[0] if len(picked) == 1 else picked


class ProgramTranslator:
    """reference: dygraph_to_static/program_translator.py:1001 — global
    switch for the dy2static rewrite. Off, `to_static` still traces, so
    tensor-dependent Python control flow raises while tracing."""
    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static):
        ProgramTranslator.enable_to_static = bool(enable_to_static)


def set_code_level(level=100, also_to_stdout=False):
    """reference: jit/dy2static set_code_level — controls transformed-code
    logging. Records the level."""
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level else logging.WARNING)


def set_verbosity(level=0, also_to_stdout=False):
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level else logging.WARNING)


from . import dy2static  # noqa: E402,F401
