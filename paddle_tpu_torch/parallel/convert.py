"""Carry the JAX `gpt_spmd` parameters and AdamW state into the port.

The port keeps the JAX leaf names and the stacked `[in, out]` layout, so
the mapping is a checked copy: every name present and no other, shapes
equal (to `param_shapes(cfg)` when a config is given), values copied
through float32 (exact for bf16).
"""
import numpy as np
import torch

from ..core.device import resolve_device
from .gpt_spmd import _BLOCK_LEAVES, param_shapes

__all__ = ["params_from_jax", "opt_state_from_jax"]

_LEAVES = _BLOCK_LEAVES + ("wte", "wpe", "lnf_w", "lnf_b")
_STATE = ("m", "v", "master", "t")


def _check_names(got, want, what):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what} names differ: missing {missing}, "
                         f"unexpected {extra}")


def _tensor(arr, dtype, dev):
    a = np.asarray(arr)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)


def params_from_jax(params, device="cuda", dtype=None, cfg=None):
    """{leaf: array} from the JAX `init_gpt_params` (or a trained step) ->
    {leaf: tensor} on `device`, in `dtype` (default: float32, or the
    config's param_dtype when `cfg` is given)."""
    dev = resolve_device(device)
    _check_names(params, _LEAVES, "parameter")
    if dtype is None:
        dtype = torch.float32 if cfg is None else \
            {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg.param_dtype]
    shapes = param_shapes(cfg) if cfg is not None else None
    out = {}
    for name in _LEAVES:
        t = _tensor(params[name], dtype, dev)
        if shapes is not None and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
        out[name] = t
    return out


def opt_state_from_jax(state, device="cuda"):
    """{leaf: {"m", "v", "master", "t"}} from the JAX
    `init_opt_state_leaf` at sharding=1 -> the same in tensors (f32
    vectors, int32 step count)."""
    dev = resolve_device(device)
    _check_names(state, _LEAVES, "state")
    out = {}
    for name in _LEAVES:
        _check_names(state[name], _STATE, f"state[{name!r}]")
        out[name] = {k: _tensor(state[name][k], torch.float32, dev)
                     for k in ("m", "v", "master")}
        out[name]["t"] = torch.tensor(int(np.asarray(state[name]["t"])),
                                      dtype=torch.int32, device=dev)
        n = out[name]["m"].numel()
        if any(out[name][k].shape != (n,) for k in ("v", "master")):
            raise ValueError(f"state[{name!r}]: m/v/master sizes differ")
    return out
