"""ZeRO, the group-sharded API (counterpart of
`paddle_tpu/distributed/sharding/__init__.py`; reference:
distributed/sharding/group_sharded.py `group_sharded_parallel` over
GroupShardedOptimizerStage2 (os), GroupShardedStage2 (os_g) and
GroupShardedStage3 (p_g_os)).

A parameter or state tensor is split over the mesh's "sharding" axis on
its largest dim that the degree divides (`_shard_spec_for`, the
reference's rule), recorded as a tuple of axis names: a parameter's
`partition_spec` (p_g_os) and the optimizer's `state_specs`.

  * One controller (a one-process mesh): the plain update, with the
    partition recorded; one card gains nothing from splitting it
    (ROADMAP C.22).
  * Across processes, one sharding rank a process (each process its own
    rows of the batch): the gradients are averaged over the sharding
    group, the optimizer's global-norm clip sees the whole gradient, and
    each process updates its rows of every split parameter with its rows
    of the optimizer state, then all-gathers the updated parameter. The
    result is one process's update over the whole batch. With p_g_os a
    split parameter keeps only its rows between steps: the model
    all-gathers them before its forward (one gather of every parameter
    a forward, where the reference gathers a layer at a time).
    `state_dict` gathers every process's rows of the optimizer state
    into whole tensors (every process calls it), and `set_state_dict`
    keeps this process's rows of a whole state.
"""
import os

import torch

from ...core.tensor import _wrap
from .. import collective as C
from .. import env as _env

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedOptimizer"]


def _shard_spec_for(shape, degree):
    """The largest dim of `shape` that `degree` divides, over
    "sharding", as a tuple; None if none does."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % degree == 0 and shape[i] >= degree:
            spec = [None] * len(shape)
            spec[i] = "sharding"
            return tuple(spec)
    return None


def _sharding_mesh(group):
    mesh = group.mesh if group is not None else _env.get_mesh()
    if mesh is None or "sharding" not in mesh.dims:
        return None, 1
    return mesh, int(mesh.dims["sharding"])


def _axis(spec):
    return None if spec is None else spec.index("sharding")


def _gather_rows(rows, axis, pg):
    return torch.cat(C._world_gather(rows, pg), axis)


class GroupShardedOptimizer:
    """The optimizer of a group-sharded model (GroupShardedOptimizerStage2
    and stage 3's update): see the module docstring."""

    def __init__(self, optimizer, mesh, degree, level="os"):
        self._inner_opt = optimizer
        self._mesh = mesh
        self._degree = degree
        self._level = level
        self._shard_params = level == "p_g_os"
        self.state_specs = {}
        g = C.Group(axis_name="sharding", mesh=mesh)
        self._cross = g.spans_processes()
        if self._cross:
            self._pg = g.process_group
            self._rank = int(mesh.coords[mesh.local_ranks[0]]["sharding"])
        self._rows = {}  # id(param) -> (axis, rows' shape, state of its rows)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _record(self, name, state):
        self.state_specs[name] = {
            k: (_shard_spec_for(tuple(v.shape), self._degree) or ())
            if v.dim() else () for k, v in state.items()}

    def functional_state(self, params_dict):
        state = self._inner_opt.functional_state(params_dict)
        for n, st in state.items():
            self._record(n, st)
        return state

    def apply_gradients_functional(self, *a, **k):
        return self._inner_opt.apply_gradients_functional(*a, **k)

    def step(self):
        if not self._cross:
            self._inner_opt.step()
            for i, p in enumerate(self._inner_opt._parameters):
                st = self._inner_opt._accumulators.get(id(p))
                if st:
                    self._record(p.name or f"param_{i}", st)
            return
        self._step_across()

    def _step_across(self):
        opt = self._inner_opt
        n, me, pg = self._degree, self._rank, self._pg
        live = [p for p in opt._parameters
                if not p.stop_gradient and p._data.grad is not None]
        grads = [p._data.grad.detach().clone() for p in live]
        C.all_reduce_mean_(grads, pg)
        params_grads = [(p, _wrap(g)) for p, g in zip(live, grads)]
        if opt._grad_clip is not None:
            params_grads = opt._grad_clip(params_grads)
        lr_on = opt._lr_tensors()
        opt._step_count += 1
        with torch.no_grad():
            for i, (p, g) in enumerate(params_grads):
                full = p._data
                gd = opt._apply_decay(p, g._data, full)
                spec = _shard_spec_for(tuple(full.shape), n)
                ax = _axis(spec)
                if ax is None:
                    rows_p, rows_g = full, gd
                else:
                    rows_p = full.chunk(n, ax)[me]
                    rows_g = gd.chunk(n, ax)[me]
                _, _, state = self._rows.get(id(p), (ax, None, None))
                if state is None:
                    state = opt._init_state(rows_p)
                opt._current_param_name = p.name or f"param_{i}"
                new_rows, state = opt._update(rows_p, rows_g.to(rows_p.dtype),
                                              state, lr_on(rows_p.device))
                self._rows[id(p)] = (ax, tuple(rows_p.shape), state)
                self._record(opt._current_param_name, state)
                new = new_rows if ax is None else \
                    _gather_rows(new_rows, ax, pg)
                if self._shard_params and ax is not None:
                    new = new.chunk(n, ax)[me].clone()
                    p._zero3 = (ax, pg)
                p._rebind(lambda d, v=new: v, tracked=False)
        opt.clear_grad()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self):
        """The inner optimizer's state dict; across processes, with each
        parameter's state gathered whole from the processes' rows."""
        out = self._inner_opt.state_dict()
        if not self._cross:
            return out
        for i, p in enumerate(self._inner_opt._parameters):
            if id(p) not in self._rows:
                continue
            ax, shape, state = self._rows[id(p)]
            out[p.name or f"param_{i}"] = {
                k: _wrap(_gather_rows(v, ax, self._pg)
                         if ax is not None and tuple(v.shape) == shape else v)
                for k, v in state.items()}
        return out

    def set_state_dict(self, sd):
        """Load a whole state; across processes, keep this process's rows
        of each parameter's state."""
        opt = self._inner_opt
        opt.set_state_dict(sd)
        if not self._cross:
            return
        n, me = self._degree, self._rank
        for p in opt._parameters:
            state = opt._accumulators.pop(id(p), None)
            if state is None:
                continue
            shape = list(p._data.shape)
            z = getattr(p, "_zero3", None)
            if z is not None:
                shape[z[0]] *= n
            ax = _axis(_shard_spec_for(tuple(shape), n))
            rows = {k: v.chunk(n, ax)[me].clone()
                    if ax is not None and list(v.shape) == shape else v
                    for k, v in state.items()}
            rows_shape = tuple(shape) if ax is None else tuple(
                s // n if d == ax else s for d, s in enumerate(shape))
            self._rows[id(p)] = (ax, rows_shape, rows)


def _gather_params(layer):
    """Stage 3: every parameter that keeps its rows, whole again."""
    for p in layer.parameters():
        z = getattr(p, "_zero3", None)
        if z is not None:
            ax, pg = z
            with torch.no_grad():
                full = _gather_rows(p._data, ax, pg)
            p._rebind(lambda d, v=full: v, tracked=False)
            p._zero3 = None


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """(model, optimizer, scaler) for the ZeRO level: 'os' (stage 1),
    'os_g' (stage 2), 'p_g_os' (stage 3)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"level must be os / os_g / p_g_os, got {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True is CPU-state ZeRO-Offload, which the reference "
            "refuses too: keep the states on the device, sharded over the "
            "mesh")
    mesh, degree = _sharding_mesh(group)
    if mesh is None or degree <= 1:
        return model, optimizer, scaler
    opt = GroupShardedOptimizer(optimizer, mesh, degree, level)
    if level == "p_g_os":
        for p in model.parameters():
            spec = _shard_spec_for(tuple(p._data.shape), degree)
            if spec is not None:
                p.partition_spec = spec
                p.is_distributed = True
        if opt._cross:
            model.register_forward_pre_hook(
                lambda layer, inputs: _gather_params(layer))
    return model, opt, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """The whole parameters (rows gathered) and the optimizer's state, as
    a plain state_dict (reference: group_sharded.py
    save_group_sharded_model)."""
    from ...framework.io import save as _save
    _gather_params(model)
    os.makedirs(output, exist_ok=True)
    _save(model.state_dict(), os.path.join(output, "model.pdmodel"))
    if optimizer is not None:
        _save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
