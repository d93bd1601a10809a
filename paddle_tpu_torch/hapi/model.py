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

The dp route. With a mesh whose "dp" (or "mp") axis is above 1
(`_dp_mesh()`), the reference compiles one GSPMD program with the batch
sharded over dp: its loss, gradients and BatchNorm statistics are the
global batch's. The port reproduces that step:
  * under a process group (one block of ranks a process), every process
    passes the same global batch and computes its own ranks' rows; every
    BatchNorm in the step reduces its statistics over the processes
    (`distributed.env.global_batch`), the gradients are mean-all-reduced
    before the update, the loss is the processes' mean and the outputs
    the metrics read are gathered: the single-process step, computed in
    parts;
  * on a one-process mesh the one controller computes that same global
    step, which is the plain step (it gains nothing on one card:
    ROADMAP C.21).
A batch whose leading size does not split over dp takes the plain step in
every process (`_train_step_plain` records it), as in the reference. The
mp half of the route (fleet's `split_axis` parameters) and the pp route
come with ROADMAP A.13f(ii); a mesh with pp > 1, or with mp > 1 under a
process group, raises.
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
        self.stop_training = False

    # ---------------------------------------------------------------- prep
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, strategy=None):
        """`strategy` is kept for the pipeline route (ROADMAP A.13f(ii))."""
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        self._strategy = dict(strategy or {})

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
        if mesh.dims.get("pp", 1) > 1:
            raise NotImplementedError(
                "Model over a mesh with pp > 1 (the compiled pipeline "
                "route) comes with ROADMAP A.13f(ii)")
        useful = any(mesh.dims.get(a, 1) > 1 for a in ("dp", "mp"))
        return mesh if useful else None

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
        the plain step (no dp mesh, one process, or a ragged batch)."""
        from ..distributed import env
        mesh = self._dp_mesh()
        if mesh is None:
            return None
        dp = mesh.dims.get("dp", 1)
        if any(r.dim() and r.shape[0] % dp for r in raws):
            # a ragged batch does not split over dp: the plain step, in
            # every process alike
            self._train_step_plain = self._train_step
            return None
        if mesh.nproc == 1:
            return None
        if any(v > 1 for a, v in mesh.dims.items() if a != "dp") \
                or not env.process_group_live():
            raise NotImplementedError(
                f"Model over mesh {mesh.dims} across processes: only the "
                "dp axis is split over processes here; the mp route comes "
                "with ROADMAP A.13f(ii)")
        return mesh

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
