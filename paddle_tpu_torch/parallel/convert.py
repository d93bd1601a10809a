"""Carry the JAX `gpt_spmd` parameters and AdamW state into the port.

The port keeps the JAX leaf names and the stacked `[in, out]` layout, so
the mapping is a checked copy: every name present and no other, shapes
equal (to `param_shapes(cfg)` when a config is given), values copied
through float32 (exact for bf16). With a `plan` of more than one rank the
JAX global arrays are cut into each rank's piece (`param_specs`, the
optimizer's `state_specs`), taking the vpp storage order as stored;
under a process group, into the pieces of the ranks this process drives,
as `make_train_step` splits them.
"""
import numpy as np
import torch

from ..core.device import resolve_device
from .gpt_spmd import (_BLOCK_LEAVES, _process_grid, param_shapes,
                       param_specs, shard_leaf, state_specs)

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


def _grid(plan, device, devices, axis_order=None):
    """The plan's rank grid as `make_train_step` splits it over the
    processes, or None for a plan of one rank."""
    if plan is None or plan.n_devices == 1:
        return None
    return _process_grid(plan, resolve_device(device), devices, axis_order)


def params_from_jax(params, device="cuda", dtype=None, cfg=None, plan=None,
                    devices=None, axis_order=None):
    """{leaf: array} from the JAX `init_gpt_params` (or a trained step) ->
    {leaf: tensor} on `device`, in `dtype` (default: float32, or the
    config's param_dtype when `cfg` is given). With a `plan` of more than
    one rank: {leaf: [one piece a rank this process drives]}, on
    `devices` as `make_train_step` takes them (default `device`) and
    over its `axis_order`."""
    _check_names(params, _LEAVES, "parameter")
    if dtype is None:
        dtype = torch.float32 if cfg is None else \
            {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg.param_dtype]
    shapes = param_shapes(cfg) if cfg is not None else None
    grid = _grid(plan, device, devices, axis_order)
    host = torch.device("cpu") if grid is not None else \
        resolve_device(device)
    specs = param_specs(cfg)
    out = {}
    for name in _LEAVES:
        t = _tensor(params[name], dtype, host)
        if shapes is not None and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{shapes[name]}")
        out[name] = t if grid is None else shard_leaf(t, specs[name], grid)
    return out


def opt_state_from_jax(state, device="cuda", plan=None, devices=None,
                       axis_order=None):
    """{leaf: {"m", "v", "master", "t"}} from the JAX `init_opt_state_leaf`
    (or a trained step) -> the same in tensors (f32 vectors, int32 step
    count). With a `plan` of more than one rank the JAX global state
    arrays are cut into each rank's shard: {leaf: [one dict a rank]}."""
    _check_names(state, _LEAVES, "state")
    grid = _grid(plan, device, devices, axis_order)
    host = torch.device("cpu") if grid is not None else \
        resolve_device(device)
    specs = state_specs()
    out = {}
    for name in _LEAVES:
        _check_names(state[name], _STATE, f"state[{name!r}]")
        leaf = {k: _tensor(state[name][k], torch.float32, host)
                for k in ("m", "v", "master")}
        n = leaf["m"].numel()
        if any(leaf[k].shape != (n,) for k in ("v", "master")):
            raise ValueError(f"state[{name!r}]: m/v/master sizes differ")
        t = int(np.asarray(state[name]["t"]))
        if grid is None:
            leaf["t"] = torch.tensor(t, dtype=torch.int32, device=host)
            out[name] = leaf
            continue
        pieces = {k: shard_leaf(v, specs[name][k], grid)
                  for k, v in leaf.items()}
        out[name] = [{"m": pieces["m"][i], "v": pieces["v"][i],
                      "master": pieces["master"][i],
                      "t": torch.tensor(t, dtype=torch.int32,
                                        device=grid.devices[r])}
                     for i, r in enumerate(grid.local_ranks)]
    return out
