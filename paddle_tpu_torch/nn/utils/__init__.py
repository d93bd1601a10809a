"""paddle.nn.utils for the port (counterpart of
`paddle_tpu/nn/utils/__init__.py`): weight and spectral normalisation as
forward rewrites of a Layer, and flattening parameters into one vector.

`spectral_norm` differs from the reference in one place: its
power-iteration vector `u` starts from a draw of the port's generator on
the weight's device (a unit-norm N(0, 1) vector, as the reference's
`RandomState(0)` draw is), and the iteration runs there without a host
copy. The estimate after enough iterations is the weight's largest
singular value either way.
"""
import numpy as np
import torch

from ...core.device import place_device
from ...core.random import generator
from ...core.tensor import Parameter, Tensor, apply_op

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(v, dim):
    """L2 norm over every axis except `dim` (dim=None/-1: whole tensor)."""
    if dim is None or dim == -1:
        return torch.sqrt(torch.sum(v * v))
    axes = tuple(a for a in range(v.dim()) if a != dim)
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    return torch.sqrt(torch.sum(v * v, dim=axes)).reshape(shape)


def _weight_of(g, v, dim):
    return v * (g / torch.clamp(_norm_except(v, dim), min=1e-12))


def weight_norm(layer, name="weight", dim=0):
    """Reparameterize `layer.<name>` as g * v / ||v|| (Salimans & Kingma
    2016): <name>_g (magnitude) and <name>_v (direction) become the
    trainable parameters and the weight is recomputed before every
    forward."""
    from ..layer.layers import Layer
    assert isinstance(layer, Layer)
    w = getattr(layer, name)._data.detach()
    g = Parameter(_norm_except(w, dim).clone())
    v = Parameter(w.clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def compute():
        return apply_op(lambda gg, vv: _weight_of(gg, vv, dim), g, v,
                        name="weight_norm")

    orig_forward = layer.forward

    def wrapped_forward(*args, **kwargs):
        object.__setattr__(layer, name, compute())
        return orig_forward(*args, **kwargs)

    layer._wn_state = (name, dim, orig_forward)
    layer.forward = wrapped_forward
    object.__setattr__(layer, name, compute())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold g * v / ||v|| back into one parameter."""
    state = getattr(layer, "_wn_state", None)
    if state is None or state[0] != name:
        raise ValueError(f"layer has no weight norm on {name!r}")
    _, dim, orig_forward = state
    g = layer._parameters[name + "_g"]
    v = layer._parameters[name + "_v"]
    delattr(layer, name + "_g")      # Layer.__delattr__ clears both the
    delattr(layer, name + "_v")      # attribute and the parameter store
    with torch.no_grad():
        w = _weight_of(g._data, v._data, dim)
    layer.add_parameter(name, Parameter(w.detach().clone()))
    layer.forward = orig_forward
    del layer._wn_state
    return layer


def _as_matrix(w, dim):
    return torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """Divide the weight by its largest singular value, estimated by power
    iteration before each forward; `u` carries over between forwards so
    the estimate converges during training."""
    from ..layer.layers import Layer
    assert isinstance(layer, Layer)
    w = getattr(layer, name)._data.detach()
    rows = w.shape[dim]
    u = torch.randn((rows,), dtype=torch.float32, device=w.device,
                    generator=generator(w.device))
    state = {"u": u / (torch.linalg.vector_norm(u) + eps)}
    orig = Parameter(w.clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_orig", orig)

    def compute():
        # power iteration on the current weight, off the tape;
        # n_power_iterations=0 uses the stored estimate without updating
        with torch.no_grad():
            m = _as_matrix(orig._data.float(), dim)
            uu = state["u"]
            vv = m.T @ uu
            vv = vv / (torch.linalg.vector_norm(vv) + eps)
            for _ in range(n_power_iterations):
                uu = m @ vv
                uu = uu / (torch.linalg.vector_norm(uu) + eps)
                vv = m.T @ uu
                vv = vv / (torch.linalg.vector_norm(vv) + eps)
            state["u"] = uu

        def fn(wraw):
            sigma = uu @ (_as_matrix(wraw, dim) @ vv)  # differentiable in w
            return wraw / torch.clamp(sigma, min=eps)
        return apply_op(fn, orig, name="spectral_norm")

    orig_forward = layer.forward

    def wrapped_forward(*args, **kwargs):
        object.__setattr__(layer, name, compute())
        return orig_forward(*args, **kwargs)

    layer.forward = wrapped_forward
    object.__setattr__(layer, name, compute())
    return layer


def parameters_to_vector(parameters, name=None):
    """Flatten parameters into one 1-D tensor (a copy, off the tape)."""
    datas = [p._data.detach().reshape(-1) for p in parameters]
    if not datas:
        return Tensor(torch.zeros((0,), dtype=torch.float32,
                                  device=place_device()))
    return Tensor(torch.cat(datas))


def vector_to_parameters(vec, parameters, name=None):
    """Write a flat vector back into the parameter list (each keeps its
    identity, dtype and device)."""
    d = vec._data if isinstance(vec, Tensor) else torch.as_tensor(
        np.asarray(vec))
    parameters = list(parameters)
    total = sum(int(np.prod(p._data.shape)) if p._data.dim() else 1
                for p in parameters)
    if int(d.shape[0]) != total:
        raise ValueError(
            f"vector has {int(d.shape[0])} elements but the parameters "
            f"hold {total}")
    off = 0
    for p in parameters:
        n = int(np.prod(p._data.shape)) if p._data.dim() else 1
        piece = d[off:off + n].detach()
        p._rebind(lambda old, piece=piece: piece.reshape(old.shape).to(
            device=old.device, dtype=old.dtype), tracked=False)
        p._version += 1
        off += n
    return parameters
