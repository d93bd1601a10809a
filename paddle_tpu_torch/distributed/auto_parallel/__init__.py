"""Semi-automatic parallelism (counterpart of
`paddle_tpu/distributed/auto_parallel/__init__.py`; reference:
distributed/auto_parallel/interface.py:29 shard_tensor, :103 shard_op,
engine.py Engine:61).

`ProcessMesh` is a mesh of ranks (a `parallel.collectives.RankGrid` over
its named dims, one device a rank: the current place's). `shard_tensor`
and `shard_op` record their annotations as the reference does
(`x._dist_attr = (mesh, spec)`, the spec a tuple of dim names or None a
tensor dim); one controller computes the annotated tensors whole. The
`Engine` trains, evaluates and predicts through `hapi.Model`'s step
(with `Strategy.amp` under `amp.auto_cast` and `Strategy.recompute`
through `fleet.utils.recompute`), and saves and loads as `Model` does.
"""
import math

from ...core.tensor import Tensor
from ...nn.layer.layers import Layer
from .. import env as _env

__all__ = ["ProcessMesh", "shard_tensor", "shard_op", "Engine", "Strategy",
           "get_mesh", "set_mesh"]


class ProcessMesh:
    """An N-D mesh of ranks with named dims (reference:
    auto_parallel/process_mesh.py): `shape` like [2, 4] with `dim_names`
    like ["dp", "mp"]."""

    def __init__(self, mesh=None, dim_names=None, shape=None):
        import numpy as np
        arr = np.asarray(mesh if mesh is not None else [])
        if shape is None:
            shape = list(arr.shape) if arr.size else [_env.get_world_size()]
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(len(shape))]
        self.shape = [int(s) for s in shape]
        self.dim_names = list(dim_names)
        self.process_ids = (arr.flatten().tolist() if arr.size
                            else list(range(math.prod(self.shape))))
        from ...core.device import place_device
        from ...parallel.collectives import RankGrid
        self._grid = RankGrid(dict(zip(self.dim_names, self.shape)),
                              [place_device()] * math.prod(self.shape),
                              axes=tuple(self.dim_names))

    @property
    def mesh(self):
        return self._grid

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self.dim_names})"


def _as_mesh(mesh):
    if isinstance(mesh, ProcessMesh):
        return mesh.mesh
    if mesh is None:
        m = _env.get_mesh()
        if m is None:
            raise RuntimeError("no mesh: pass process_mesh or call "
                               "init_parallel_env/build_mesh first")
        return m
    if hasattr(mesh, "dims") and hasattr(mesh, "axes"):
        return mesh
    raise TypeError(f"not a mesh: {mesh!r}")


def _as_spec(mesh, shard_spec, ndim):
    """shard_spec: a list over the tensor's dims of mesh-dim names / None
    (the named form) or ints (dims_mapping: a mesh dim index, -1
    replicated) -> a tuple of names / None, padded to `ndim`."""
    if shard_spec is None:
        return ()
    names = list(mesh.axes)
    parts = []
    for s in shard_spec:
        if s is None or s == -1:
            parts.append(None)
        elif isinstance(s, int):
            parts.append(names[s])
        else:
            parts.append(s)
    return tuple(parts + [None] * (ndim - len(parts)))


def shard_tensor(x, process_mesh=None, shard_spec=None, dist_attr=None):
    """Annotate a tensor with a mesh split (reference: interface.py:29):
    the 2.3-era `dist_attr={"process_mesh": ..., "dims_mapping": [...]}`
    or the named `shard_spec=["dp", None, ...]`. The annotation is
    `x._dist_attr = (mesh, spec)`; the tensor is returned."""
    if dist_attr is not None:
        process_mesh = dist_attr.get("process_mesh", process_mesh)
        shard_spec = dist_attr.get("dims_mapping", shard_spec)
    mesh = _as_mesh(process_mesh)
    if isinstance(x, Tensor):
        x._dist_attr = (mesh, _as_spec(mesh, shard_spec, x._data.dim()))
    return x


def shard_op(op_fn, process_mesh=None, in_shard_specs=None,
             out_shard_specs=None):
    """Wrap a callable so its inputs and outputs carry the annotations
    (reference: interface.py:103)."""
    mesh = _as_mesh(process_mesh)

    def wrapper(*args, **kwargs):
        args = list(args)
        if in_shard_specs is not None:
            for i, spec in enumerate(in_shard_specs):
                if i < len(args) and spec is not None:
                    args[i] = shard_tensor(args[i], mesh, spec)
        out = op_fn(*args, **kwargs)
        if out_shard_specs is not None:
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            outs = [shard_tensor(o, mesh, s) if s is not None else o
                    for o, s in zip(outs, out_shard_specs)]
            out = type(out)(outs) if isinstance(out, (tuple, list)) \
                else outs[0]
        return out
    return wrapper


get_mesh = _env.get_mesh
set_mesh = _env.set_mesh


class Strategy:
    """Engine config (reference: auto_parallel Strategy): amp.enable
    computes under `amp.auto_cast` in `amp.dtype`; recompute.enable
    recomputes the forward in the backward; gradient_merge is recorded."""

    class _NS:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self):
        self.amp = Strategy._NS(enable=False, dtype="bfloat16", level="o1")
        self.recompute = Strategy._NS(enable=False)
        self.gradient_merge = Strategy._NS(enable=False, k_steps=1)


class Engine:
    """Trainer over `hapi.Model`'s step (reference: auto_parallel/
    engine.py Engine:61): fit / evaluate / predict / save / load."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 strategy=None, process_mesh=None):
        self._model = model
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics is not None else [])
        self._strategy = strategy or Strategy()
        self._mesh = _as_mesh(process_mesh) if process_mesh is not None \
            else None
        self._hapi = None
        self.history = {"loss": []}

    def _runner(self):
        if self._hapi is None:
            from ...hapi.model import Model
            net = self._model
            if self._strategy.recompute.enable:
                net = _Recomputed(net)
            self._hapi = Model(net)
            self._hapi.prepare(self._optimizer, self._loss)
        return self._hapi

    def _amp(self):
        import contextlib
        if not self._strategy.amp.enable:
            return contextlib.nullcontext()
        from ... import amp
        return amp.auto_cast(level=self._strategy.amp.level.upper(),
                             dtype=self._strategy.amp.dtype)

    @staticmethod
    def _loader(data, batch_size, shuffle=True, drop_last=False):
        from ...io import DataLoader, Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last)
        return data

    @staticmethod
    def _split(batch):
        items = list(batch) if isinstance(batch, (list, tuple)) else [batch]
        if len(items) > 1:
            return items[:-1], items[-1:]
        return items, None

    def fit(self, train_data, epochs=1, batch_size=32, steps_per_epoch=None,
            verbose=1, log_freq=10):
        loader = self._loader(train_data, batch_size, drop_last=True)
        model = self._runner()
        step_i = 0
        for ep in range(epochs):
            for batch in loader:
                ins, labs = self._split(batch)
                with self._amp():
                    (loss,), _ = model.train_batch(ins, labs)
                step_i += 1
                if verbose and step_i % log_freq == 0:
                    print(f"[AutoParallel Engine] epoch {ep} step {step_i} "
                          f"loss {loss:.4f}")
                self.history["loss"].append(loss)
                if steps_per_epoch and step_i % steps_per_epoch == 0:
                    break
            from ...optimizer.lr import LRScheduler, ReduceOnPlateau
            lr = self._optimizer._lr
            if isinstance(lr, LRScheduler) and \
                    not isinstance(lr, ReduceOnPlateau):
                lr.step()
        return self.history

    def evaluate(self, valid_data, batch_size=32, steps=None, verbose=0):
        loader = self._loader(valid_data, batch_size, shuffle=False)
        model = self._runner()
        model._metrics = list(self._metrics)
        for metric in self._metrics:
            metric.reset()
        losses = []
        for i, batch in enumerate(loader):
            ins, labs = self._split(batch)
            lv, _ = model.eval_batch(ins, labs)
            losses.append(lv[0])
            if steps and i + 1 >= steps:
                break
        res = {"loss": sum(losses) / len(losses) if losses else 0.0}
        for metric in self._metrics:
            name = metric.name() if callable(getattr(metric, "name", None)) \
                else "metric"
            if isinstance(name, (list, tuple)):
                name = "/".join(name)
            res[name] = metric.accumulate()
        return res

    def predict(self, test_data, batch_size=32, steps=None):
        loader = self._loader(test_data, batch_size, shuffle=False)
        model = self._runner()
        outs = []
        for i, batch in enumerate(loader):
            ins, _ = self._split(batch)
            got = model.predict_batch(ins)
            outs.append(got[0] if len(got) == 1 else got)
            if steps and i + 1 >= steps:
                break
        return outs

    def save(self, path, training=True):
        from ...framework.io import save as _save
        _save(self._model.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path):
        from ...framework.io import load as _load
        self._model.set_state_dict(_load(path + ".pdparams",
                                         return_numpy=True))
        self._hapi = None


class _Recomputed(Layer):
    """A Layer's forward under `fleet.utils.recompute`."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *args):
        from ..fleet.utils import recompute
        return recompute(self.inner, *args)
