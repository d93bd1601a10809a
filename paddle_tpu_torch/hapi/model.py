"""paddle.Model for the port (counterpart of `paddle_tpu/hapi/model.py`).

The reference builds one `jax.jit` program a train step:
`functional_call` -> `value_and_grad` -> `apply_gradients_functional`,
with params, buffers and optimizer state donated. The port's step is the
same function in eager torch (ROADMAP C.16):

    params, buffers = functional_state(network)
    outputs, new_buffers = functional_call(network, params, buffers,
                                           inputs, train=True)
    grads = torch.autograd.grad(loss, the params that need grad)
    new_params, opt_state = optimizer.apply_gradients_functional(...)
    _write_back(new_params, new_buffers)

It never fills a Parameter's `.grad` (the reference's compiled path never
does); BatchNorm's running statistics come back through `new_buffers`;
the optimizer state lives in `Model._opt_state`; inputs and labels go to
the device of the network's parameters; `float(loss)` is the step's one
host read. The step is not captured as a CUDA graph or compiled
(ROADMAP A.5).

Spans, while the port's profiler records: `Model.train_batch.fused_step`
(Forward: forward, backward and update, eager, ending in the loss's host
read), `Model.train_batch.write_back` (Optimization) and
`Model.eval_batch` (Forward).

The dp and mp routes. With a mesh whose "dp" (or "mp") axis is above 1
(`_dp_mesh()`), the reference compiles one GSPMD program with the batch
sharded over dp and every parameter that fleet's mp layers mark with a
`split_axis` sharded over mp: its loss, gradients and BatchNorm
statistics are the global batch's. The port reproduces that step:
  * under a process group (one block of ranks a process), every process
    passes the same global batch and computes its own ranks' rows; every
    BatchNorm in the step reduces its statistics over the processes
    (`distributed.env.global_batch`), the gradients are mean-all-reduced
    before the update, the loss is the processes' mean and the outputs
    the metrics read are gathered: the single-process step, computed in
    parts;
  * when the mp axis spans the processes, one rank a process, each
    process keeps its mp rows of every `split_axis` parameter
    (`mp_layers.shard_mp_params`) and computes the whole batch through the
    mp layers' collectives across the processes: its loss is the one
    process's loss, and no gradient is averaged (dp within a process is
    the plain step's);
  * on a one-process mesh the one controller computes that same global
    step, which is the plain step (it gains nothing on one card:
    ROADMAP C.21, C.22). The split the reference's `_param_shardings`
    gives each parameter is recorded as its `partition_spec`
    (`param_partition_spec`).
A batch whose leading size does not split over dp takes the plain step in
every process (`_train_step_plain` records it), as in the reference. Both
dp and mp across processes at once, and sharding or sp across processes,
raise (ROADMAP A.13f(iii)).

The pp route. With a mesh whose "pp" axis is above 1 the network must be
a fleet `PipelineLayer`: `train_batch` runs the pipeline runner
(`fleet/meta_parallel/pp_compiled.py`) over `prepare(strategy=
{"microbatches": M, "schedule": ...})`, writes the gradients to `.grad`
and steps the optimizer eagerly, as the reference does. Its span is
`Model.train_batch.pipeline_step`. The pipeline runs in one process; a
pp mesh split over processes raises (ROADMAP A.13f(iii)).
"""
import contextlib
import os

import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..metric import Metric
from ..nn.layer.layers import functional_call, functional_state
from ..profiler import _tracer as _TRACER
from .callbacks import CallbackList

__all__ = ["Model"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._opt_state = None
        self._strategy = {}
        self._train_step_plain = None
        self._pp_step = None
        self.stop_training = False

    # ---------------------------------------------------------------- prep
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, strategy=None):
        """`strategy`: the pipeline route's {"microbatches": M (default
        2), "schedule": "1f1b" | "gpipe"}."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._strategy = dict(strategy or {})
        self._pp_step = None

    def _compute_loss(self, outputs, labels):
        outs = _as_list(outputs)
        labs = _as_list(labels)
        if callable(self._loss) and not hasattr(self._loss, "forward"):
            loss = self._loss(*outs, *labs)
        else:
            loss = self._loss(outs[0], labs[0])
        if isinstance(loss, (list, tuple)):
            from ..tensor.math import add_n
            loss = add_n([part.sum() for part in loss])
        return loss

    # ------------------------------------------------------------- batching
    def _device(self):
        for p in self.network.parameters():
            return p._data.device
        for b in self.network.buffers():
            return b._data.device
        from ..core.device import place_device
        return place_device()

    def _raw(self, items, dev):
        out = []
        for x in items or ():
            if isinstance(x, Tensor):
                t = x._data
            elif isinstance(x, torch.Tensor):
                t = x
            else:
                a = np.asarray(x)
                if a.dtype == np.float64:
                    a = a.astype(np.float32)
                t = torch.from_numpy(np.ascontiguousarray(a))
            out.append(t.detach().to(dev, non_blocking=True))
        return tuple(out)

    @staticmethod
    def _dp_mesh():
        """The installed mesh when its dp or mp axis is above 1 (the
        reference's `_hybrid_mesh`), else None."""
        from ..distributed import env
        mesh = env.get_mesh()
        if mesh is None:
            return None
        useful = any(mesh.dims.get(a, 1) > 1 for a in ("dp", "mp"))
        return mesh if useful else None

    @staticmethod
    def _pp_mesh():
        from ..distributed import env
        mesh = env.get_mesh()
        if mesh is not None and mesh.dims.get("pp", 1) > 1:
            return mesh
        return None

    def _param_shardings(self, mesh):
        """{name: the reference's NamedSharding spec as a tuple}: a
        `split_axis` parameter of fleet's mp layers over "mp" when the mp
        axis is above 1, the rest replicated (())."""
        from ..distributed.parallel_layers import param_partition_spec
        dims = {"mp": mesh.dims.get("mp", 1)}
        out = {}
        for n, p in self.network.named_parameters():
            spec = param_partition_spec(p, dims)
            out[n] = spec if any(spec) else ()
        return out

    @staticmethod
    def _rows(raws, mesh):
        """This process's block of rows of each global-batch tensor."""
        out = []
        for t in raws:
            per = t.shape[0] // mesh.nproc
            out.append(t[mesh.proc * per:(mesh.proc + 1) * per])
        return tuple(out)

    def _train_step(self, params, buffers, in_raw, lab_raw, lr, mesh=None):
        """One step. `mesh`: split over processes, this process computes
        its rows of the global batch (the dp route)."""
        from ..distributed import collective as dc
        from ..distributed import env
        if mesh is not None:
            in_raw, lab_raw = self._rows(in_raw, mesh), \
                self._rows(lab_raw, mesh)
        names = [n for n, p in params.items() if p.requires_grad]
        scope = env.global_batch() if mesh is not None \
            else contextlib.nullcontext()
        with scope:
            outputs, new_buffers = functional_call(
                self.network, params, buffers,
                args=tuple(_wrap(i) for i in in_raw), train=True)
            loss = self._compute_loss(outputs,
                                      tuple(_wrap(v) for v in lab_raw))
            got = torch.autograd.grad(loss._data,
                                      [params[n] for n in names],
                                      allow_unused=True)
        raw_outs = [o._data.detach() for o in _as_list(outputs)]
        loss_d = loss._data.detach()
        if mesh is not None:
            dc.all_reduce_mean_([g for g in got if g is not None])
            loss_d = dc._world_reduce(loss_d, dc.ReduceOp.AVG)
            raw_outs = [torch.cat(dc._world_gather(o)) for o in raw_outs]
        grads = {n: None for n in params}
        grads.update(zip(names, got))
        with torch.no_grad():
            new_params, new_opt_state = \
                self._optimizer.apply_gradients_functional(
                    params, grads, self._opt_state, lr=lr)
        return loss_d, new_params, new_buffers, new_opt_state, raw_outs

    def train_batch(self, inputs, labels=None, update=True):
        dev = self._device()
        in_raw = self._raw(_as_list(inputs), dev)
        lab_raw = self._raw(None if labels is None else _as_list(labels),
                            dev)
        pp_mesh = self._pp_mesh()
        if pp_mesh is not None:
            return self._train_batch_pp(in_raw, lab_raw, pp_mesh)
        split = self._dp_split(in_raw + lab_raw)
        params, buffers = functional_state(self.network)
        if self._opt_state is None:
            self._opt_state = self._optimizer.functional_state(params)
        lr = self._optimizer.get_lr()
        rec = _TRACER.begin(
            "Model.train_batch.fused_step", "Forward",
            {"fused": "forward+backward+optimizer (eager functional step)"}) \
            if _TRACER.enabled else None
        try:
            loss, new_params, new_buffers, self._opt_state, outs = \
                self._train_step(params, buffers, in_raw, lab_raw, lr,
                                 split)
            loss_val = float(loss)
        finally:
            _TRACER.end(rec)
        rec = _TRACER.begin("Model.train_batch.write_back", "Optimization") \
            if _TRACER.enabled else None
        try:
            self._write_back(new_params, new_buffers)
        finally:
            _TRACER.end(rec)
        metrics_out = self._update_metrics(outs, lab_raw)
        return [loss_val], metrics_out

    def _dp_split(self, raws):
        """The mesh to split this batch over processes with, or None for
        the plain step (no dp mesh, one process, a ragged batch, or mp
        across the processes)."""
        from ..distributed import collective as dc
        from ..distributed import env
        mesh = self._dp_mesh()
        if mesh is None:
            return None
        if mesh.nproc == 1 and mesh.dims.get("mp", 1) > 1:
            specs = self._param_shardings(mesh)
            for n, p in self.network.named_parameters():
                p.partition_spec = specs[n]
        dp = mesh.dims.get("dp", 1)
        if any(r.dim() and r.shape[0] % dp for r in raws):
            # a ragged batch does not split over dp: the plain step, in
            # every process alike
            self._train_step_plain = self._train_step
            return None
        if mesh.nproc == 1:
            return None
        across = [a for a in mesh.dims if mesh.dims[a] > 1 and
                  any(mesh.process_of(r) != mesh.proc for r in
                      mesh.whole_groups(mesh.local_ranks[:1], (a,))[0])]
        if not env.process_group_live() or len(across) != 1 or \
                across[0] not in ("dp", "mp"):
            raise NotImplementedError(
                f"Model over mesh {mesh.dims} with axes {across} across "
                "processes: the dp route or the mp route (one of them "
                "across the processes) runs here; the rest comes with "
                "ROADMAP A.13f(iii)")
        if across[0] == "mp":
            group = dc.Group(axis_name="mp", mesh=mesh)
            if not group.spans_processes():
                raise NotImplementedError(
                    f"Model's mp route across processes takes one mp rank "
                    f"a process; mesh {mesh.dims} puts more in one "
                    "(ROADMAP A.13f(iii))")
            from ..distributed.fleet.layers.mp_layers import shard_mp_params
            shard_mp_params(self.network, group.rank, group.nranks,
                            group.process_group)
            return None
        if len(mesh.whole_groups(mesh.local_ranks[:1], ("dp",))[0]) != \
                mesh.dims["dp"] or mesh.dims["dp"] % mesh.nproc:
            raise NotImplementedError(
                f"Model's dp route over mesh {mesh.dims}: the dp axis must "
                "hold every process (ROADMAP A.13f(iii))")
        return mesh

    def _train_batch_pp(self, in_raw, lab_raw, mesh):
        """The pp route: the network must be a fleet PipelineLayer; the
        pipeline runner computes the loss and gradients, and the optimizer
        steps eagerly on them (reference: hapi's static adapter
        dispatching to fleet, python/paddle/hapi/model.py:591-599)."""
        from ..distributed.fleet.meta_parallel.pp_compiled import \
            make_compiled_pipeline_step
        from ..distributed.fleet.meta_parallel.pp_layers import PipelineLayer
        if not isinstance(self.network, PipelineLayer):
            raise ValueError(
                "Model.fit over a 'pp' mesh axis needs the network to be a "
                "fleet PipelineLayer (mp/dp axes compose with it through "
                "the compiled pipeline)")
        if len(in_raw) != 1 or len(lab_raw) != 1:
            raise ValueError("pipeline Model.fit expects one input and one "
                             "label tensor")
        micro = int(self._strategy.get("microbatches", 2))
        if in_raw[0].shape[0] % micro:
            raise ValueError(
                f"pipeline Model.fit: batch size {in_raw[0].shape[0]} is not "
                f"divisible by microbatches={micro}; set drop_last=True or "
                f"pick a matching batch size")
        if self._pp_step is None:
            self._pp_step = make_compiled_pipeline_step(
                self.network, mesh, microbatches=micro,
                schedule=self._strategy.get("schedule", "1f1b"))
        params, buffers = functional_state(self.network)
        rec = _TRACER.begin("Model.train_batch.pipeline_step", "Forward",
                            {"fused": "1f1b pipeline (eager tick tables)"}) \
            if _TRACER.enabled else None
        try:
            loss, grads, new_buffers = self._pp_step(params, buffers,
                                                     in_raw[0], lab_raw[0])
            loss_val = float(loss)
        finally:
            _TRACER.end(rec)
        for n, p in self.network.named_parameters():
            g = grads.get(n)
            p._data.grad = None if g is None else g.to(p._data.dtype)
        for n, b in self.network.named_buffers():
            if n in new_buffers:
                b._data = new_buffers[n].detach()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return [loss_val], []

    def eval_batch(self, inputs, labels=None):
        dev = self._device()
        in_raw = self._raw(_as_list(inputs), dev)
        lab_raw = self._raw(None if labels is None else _as_list(labels),
                            dev)
        params, buffers = functional_state(self.network)
        rec = _TRACER.begin("Model.eval_batch", "Forward") \
            if _TRACER.enabled else None
        try:
            with torch.no_grad():
                outputs, _ = functional_call(
                    self.network, params, buffers,
                    args=tuple(_wrap(i) for i in in_raw), train=False)
                loss = None
                if self._loss is not None:
                    loss = self._compute_loss(
                        outputs, tuple(_wrap(v) for v in lab_raw))._data
            outs = [o._data for o in _as_list(outputs)]
        finally:
            _TRACER.end(rec)
        metrics_out = self._update_metrics(outs, lab_raw)
        return ([float(loss)] if loss is not None else []), metrics_out

    def predict_batch(self, inputs):
        dev = self._device()
        in_raw = self._raw(_as_list(inputs), dev)
        self.network.eval()
        with torch.no_grad():
            outs = self.network(*[_wrap(i) for i in in_raw])
        self.network.train()
        return [o.numpy() for o in _as_list(outs)]

    def _write_back(self, new_params, new_buffers):
        for n, p in self.network.named_parameters():
            if n in new_params and new_params[n] is not p._data:
                p._rebind(lambda d, v=new_params[n]: v, tracked=False)
        for n, b in self.network.named_buffers():
            if n in new_buffers:
                b._data = new_buffers[n].detach()

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            pred = _wrap(outs[0])
            lab = _wrap(labels[0]) if labels else None
            r = m.compute(pred, lab)
            results.append(m.update(r))
        return results

    # ------------------------------------------------------------------ fit
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from ..io import DataLoader, Dataset

        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        cbks = CallbackList(callbacks, model=self, verbose=verbose,
                            metrics=["loss"] + [n for m in self._metrics
                                                for n in _as_list(m.name())],
                            epochs=epochs, steps=steps, log_freq=log_freq)
        cbks.on_begin("train")
        global_step = 0
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            for step, data in enumerate(train_loader):
                cbks.on_batch_begin("train", step, {})
                ins, labs = self._unpack(data)
                losses, _ = self.train_batch(ins, labs)
                logs = {"loss": losses[0], "step": step}
                for m in self._metrics:
                    logs.update(zip(_as_list(m.name()),
                                    _as_list(m.accumulate())))
                cbks.on_batch_end("train", step, logs)
                global_step += 1
                if num_iters is not None and global_step >= num_iters:
                    break
            sched = getattr(self._optimizer, "_lr", None)
            if hasattr(sched, "step"):
                from ..optimizer.lr import ReduceOnPlateau
                if not isinstance(sched, ReduceOnPlateau):
                    # ReduceOnPlateau needs the monitored metric: the
                    # user or a callback steps it
                    sched.step()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_loader, verbose=0)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbks.on_end("train")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        from ..io import DataLoader, Dataset
        loader = DataLoader(eval_data, batch_size=batch_size) \
            if isinstance(eval_data, Dataset) else eval_data
        for m in self._metrics:
            m.reset()
        losses = []
        for data in loader:
            ins, labs = self._unpack(data)
            lv, _ = self.eval_batch(ins, labs)
            if lv:
                losses.append(lv[0])
        out = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            out.update(zip(_as_list(m.name()), _as_list(m.accumulate())))
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        from ..io import DataLoader, Dataset
        loader = DataLoader(test_data, batch_size=batch_size) \
            if isinstance(test_data, Dataset) else test_data
        outputs = []
        for data in loader:
            ins, _ = self._unpack(data)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    @staticmethod
    def _unpack(data):
        if isinstance(data, (list, tuple)):
            if len(data) >= 2:
                return list(data[:-1]), [data[-1]]
            return list(data), None
        return [data], None

    # ----------------------------------------------------------------- io
    def save(self, path, training=True):
        """`<path>.pdparams` (and `<path>.pdopt` while training) in the
        format the JAX package's `framework.io.load` reads."""
        from ..framework.io import save as _save
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as _load
        self.network.set_state_dict(_load(path + ".pdparams",
                                          return_numpy=True))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_load(path + ".pdopt",
                                                 return_numpy=True))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
