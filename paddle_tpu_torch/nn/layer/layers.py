"""Layer: the module base class (counterpart of
`paddle_tpu/nn/layer/layers.py`).

`Layer` is a plain class over the eager core's `Parameter`, not a
`torch.nn.Module` (ROADMAP C.15): a Module registers only
`torch.nn.Parameter`s, the port's value semantics rebind
`Parameter._data` on every update (a Module holding the torch tensors
would go stale after one optimizer step), and paddle's hook signatures,
`state_dict` names and `stop_gradient` are not a Module's.

The registration rules are the reference's (`__setattr__`): a Parameter
goes to `_parameters`, a Layer to `_sub_layers`, and a Tensor assigned as
a plain attribute becomes a non-persistable buffer, which `state_dict()`
leaves out. `named_parameters()` and `state_dict()` keep the reference's
key order, which the optimizers, the clip and the weight mapping depend
on.

`functional_state` / `functional_call` turn a Layer into a function over
raw torch tensors: `functional_call` swaps the tensors into the
Parameters and buffers, runs the forward and puts the originals back, so
gradients flow to the tensors passed in.
"""
from collections import OrderedDict

import numpy as np
import torch

from ...core import dtype as _dt
from ...core.device import place_device
from ...core.tensor import Parameter, Tensor
from ..initializer import Constant, XavierUniform

__all__ = ["Layer", "HookRemoveHelper", "functional_state",
           "functional_call"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = _dt.convert_dtype(dtype)
        self._parameters = OrderedDict()
        self._sub_layers = OrderedDict()
        self._buffers = OrderedDict()
        self._non_persistable_buffer_names_set = set()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ---------------------------------------------------------------- attrs
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError(
                    "call super().__init__() before assigning params")
            params[name] = value
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            object.__setattr__(self, name, value)
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError(
                    "call super().__init__() before assigning sublayers")
            layers[name] = value
            if params is not None:
                params.pop(name, None)
            object.__setattr__(self, name, value)
        elif isinstance(value, Tensor):
            if buffers is not None:
                buffers[name] = value
                self._non_persistable_buffer_names_set.add(name)
            object.__setattr__(self, name, value)
        else:
            if params is not None and name in params:
                if value is None:
                    params.pop(name)
                else:
                    raise TypeError(
                        f"cannot assign {type(value)} to parameter {name}")
            if layers is not None and name in layers \
                    and not isinstance(value, Layer):
                layers.pop(name)
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_sub_layers", "_buffers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
        if name in self.__dict__:
            object.__delattr__(self, name)

    # ------------------------------------------------------------- creation
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new Parameter on the current place (the GPU unless
        `set_device("cpu")`), initialized by the attr's initializer, the
        default one, zeros for a bias, else XavierUniform."""
        from ..param_attr import ParamAttr
        dtype = _dt.convert_dtype(dtype) or self._dtype
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if attr.initializer is not None:
            init = attr.initializer
        elif default_initializer is not None:
            init = default_initializer
        elif is_bias:
            init = Constant(0.0)
        else:
            init = XavierUniform()
        p = Parameter(init(tuple(shape), dtype), name=attr.name,
                      trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        if parameter is None:
            self._parameters[name] = None
        else:
            setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[str(name)] = sublayer
        if str(name).isidentifier():
            object.__setattr__(self, str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if persistable:
            self._non_persistable_buffer_names_set.discard(name)
        else:
            self._non_persistable_buffer_names_set.add(name)
        object.__setattr__(self, name, tensor)
        return tensor

    # ------------------------------------------------------------ traversal
    def children(self):
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, l in self._sub_layers.items():
            if l is not None and id(l) not in seen:
                seen.add(id(l))
                yield name, l

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, l in self.named_children():
            if l is None or id(l) in layers_set:
                continue
            layers_set.add(id(l))
            sub_prefix = prefix + ("." if prefix else "") + name
            yield sub_prefix, l
            yield from l.named_sublayers(prefix=sub_prefix,
                                         layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def _named_members(self, store, prefix, include_sublayers):
        seen = set()
        for name, t in getattr(self, store).items():
            if t is not None and id(t) not in seen:
                seen.add(id(t))
                yield prefix + ("." if prefix else "") + name, t
        if include_sublayers:
            for lname, l in self.named_children():
                sub_prefix = prefix + ("." if prefix else "") + lname
                for n, t in l._named_members(store, sub_prefix, True):
                    if id(t) not in seen:
                        seen.add(id(t))
                        yield n, t

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._named_members("_parameters", prefix, include_sublayers)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        return self._named_members("_buffers", prefix, include_sublayers)

    def apply(self, fn):
        for l in self.children():
            l.apply(fn)
        fn(self)
        return self

    # ----------------------------------------------------------- mode/hooks
    def train(self):
        self.training = True
        for l in self.children():
            l.train()
        return self

    def eval(self):
        self.training = False
        for l in self.children():
            l.eval()
        return self

    def register_forward_pre_hook(self, hook):
        handle = HookRemoveHelper(self._forward_pre_hooks)
        self._forward_pre_hooks[handle._hook_id] = hook
        return handle

    def register_forward_post_hook(self, hook):
        handle = HookRemoveHelper(self._forward_post_hooks)
        self._forward_post_hooks[handle._hook_id] = hook
        return handle

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def extra_repr(self):
        return ""

    def __repr__(self):
        lines = []
        for name, l in self.named_children():
            mod_str = "\n".join("  " + line for line in repr(l).split("\n"))
            lines.append(f"  ({name}): " + mod_str.strip())
        main = self.__class__.__name__ + "(" + self.extra_repr()
        if lines:
            return main + "\n" + "\n".join(lines) + "\n)"
        return main + ")"

    # ------------------------------------------------------------ state I/O
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            dest[name] = p
        persist = self._persistable_buffer_names()
        for name, b in self.named_buffers(
                prefix=structured_name_prefix,
                include_sublayers=include_sublayers):
            bare = name[len(structured_name_prefix):].lstrip(".") \
                if structured_name_prefix else name
            if bare in persist:
                dest[name] = b
        return dest

    def _persistable_buffer_names(self):
        names = set()
        for prefix, l in self.named_sublayers(include_self=True):
            for bname in l._buffers:
                if bname not in l._non_persistable_buffer_names_set:
                    names.add((prefix + "." if prefix else "") + bname)
        return names

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load values (Tensors, torch tensors or numpy arrays; bfloat16
        arrives as float32) under the structured names. Each Parameter
        keeps its identity, dtype, device and trainability. Returns
        (missing, unexpected) key lists."""
        missing, unexpected = [], []
        own = self.state_dict()
        for name, t in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            v = state_dict[name]
            if isinstance(v, Tensor):
                v = v._data
            elif not isinstance(v, torch.Tensor):
                a = np.asarray(v)
                v = torch.from_numpy(np.array(a.astype(np.float32)
                                              if a.dtype.name == "bfloat16"
                                              else a))
            if tuple(v.shape) != tuple(t._data.shape):
                raise ValueError(
                    f"shape mismatch for {name}: got {tuple(v.shape)}, "
                    f"expected {tuple(t._data.shape)}")
            t._rebind(lambda d, v=v: v.detach().to(
                device=d.device, dtype=d.dtype).clone(), tracked=False)
        for name in state_dict:
            if name not in own:
                unexpected.append(name)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # --------------------------------------------------------------- dtype
    def to(self, device=None, dtype=None, blocking=None):
        """Cast float parameters and buffers to `dtype` and move every
        parameter and buffer to `device`; each keeps its identity."""
        if device is not None:
            dev = place_device(device)
            for t in self.parameters() + self.buffers():
                t._rebind(lambda d: d.to(dev), tracked=False)
        if dtype is not None:
            self._cast_all(dtype)
        return self

    def astype(self, dtype):
        self._cast_all(dtype)
        return self

    def float(self):
        return self.astype("float32")

    def _cast_all(self, dtype):
        d = _dt.convert_dtype(dtype)
        for t in self.parameters() + self.buffers():
            if _dt.is_floating(t.dtype):
                t._rebind(lambda x: x.to(d), tracked=False)
        self._dtype = d

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def full_name(self):
        return self._name_scope


class HookRemoveHelper:
    """Handle of a forward hook: `remove()` unregisters it."""

    _next_id = 0

    def __init__(self, hooks):
        self._hooks_ref = hooks
        self._hook_id = HookRemoveHelper._next_id
        HookRemoveHelper._next_id += 1

    def remove(self):
        self._hooks_ref.pop(self._hook_id, None)


# ---------------------------------------------------------------------------
# Layer -> function over raw torch tensors
# ---------------------------------------------------------------------------

def functional_state(layer):
    """(params, buffers): {structured name: raw torch tensor}."""
    params = {n: p._data for n, p in layer.named_parameters()}
    buffers = {n: b._data for n, b in layer.named_buffers()}
    return params, buffers


def functional_call(layer, params, buffers, args=(), kwargs=None, train=None,
                    method=None):
    """Run the layer with the raw torch tensors `params` / `buffers`
    swapped in. Returns (outputs, new_buffers): the forward's changes to
    buffers (BatchNorm's running statistics) land in new_buffers. The
    originals are put back, whatever the forward raises; gradients flow
    to the tensors passed in."""
    kwargs = kwargs or {}
    param_objs = dict(layer.named_parameters())
    buffer_objs = dict(layer.named_buffers())
    held = {**param_objs, **buffer_objs}
    saved = {n: t._data for n, t in held.items()}
    prev_training = layer.training
    try:
        if train is not None:
            layer.train() if train else layer.eval()
        for n, t in param_objs.items():
            t._data = params[n]
        for n, t in buffer_objs.items():
            if n in buffers:
                t._data = buffers[n]
        if method is None:
            out = layer(*args, **kwargs)
        elif hasattr(method, "__self__"):
            out = method(*args, **kwargs)
        else:
            out = method(layer, *args, **kwargs)
        new_buffers = {n: t._data for n, t in buffer_objs.items()}
    finally:
        for n, t in held.items():
            t._data = saved[n]
        if train is not None:
            layer.train() if prev_training else layer.eval()
    return out, new_buffers
