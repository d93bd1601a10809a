"""Pipeline-parallel layers and the micro-batched trainer (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py`; reference:
fleet/meta_parallel/parallel_layers/pp_layers.py:211 PipelineLayer,
SharedLayerDesc:79; pipeline_parallel.py:120-200 train_batch).

`PipelineLayer` builds every stage (one controller holds them all) and
records the stage partition: uniform, by parameter count, or at a named
layer class. A `SharedLayerDesc` key maps to ONE Layer object on every
stage that names it (the tied embedding), so both stages' gradients
accumulate into the same parameter.

`PipelineParallel.train_batch` runs the pipeline over the installed mesh
when its pp axis holds the stages and `accumulate_steps` > 1
(`pp_compiled.make_compiled_pipeline_step`: the 1F1B / GPipe tick tables,
each stage on its rank's device); otherwise the micro-batch loop with
gradient accumulation and one optimizer step, which the schedule leaves
numerically unchanged.
"""
import math

from ....core.tensor import _wrap
from ....nn.layer.layers import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]


def _needs_metrics(sched):
    """ReduceOnPlateau needs the monitored metric; the reference leaves
    stepping it to the user, so the bundled loops skip it."""
    from ....optimizer.lr import ReduceOnPlateau
    return isinstance(sched, ReduceOnPlateau)


class LayerDesc:
    """Deferred layer construction (reference pp_layers.py LayerDesc)."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer):
            raise TypeError("The input of a LayerDesc must be a Layer class")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages (reference pp_layers.py:79): the
    classic use ties the input embedding and the output projection."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """Every stage of the pipeline with a recorded stage partition.

    seg_method: "uniform" (equal layer counts), "param" (balance by
    parameter count), or "layer:ClassName" (stage boundaries before the
    named layer class)."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = max(int(num_stages or 1), 1)
        self._recompute_interval = recompute_interval
        self._shared = {}
        self._descs = list(layers)
        built = []
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared:
                    self._shared[d.layer_name] = d.build_layer()
                built.append((self._shared[d.layer_name], d))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), d))
            elif isinstance(d, Layer) or callable(d):
                built.append((d, None))
            else:
                raise TypeError(f"bad pipeline entry: {d!r}")
        self._built = built
        for i, (layer, _) in enumerate(built):
            if isinstance(layer, Layer):
                self.add_sublayer(f"seg_{i}", layer)
        self._boundaries = self._segment(seg_method)

    def _param_counts(self):
        counts = []
        for layer, _ in self._built:
            n = 0
            if isinstance(layer, Layer):
                n = sum(math.prod(p.shape) for p in layer.parameters())
            counts.append(max(n, 1))
        return counts

    def _segment(self, method):
        n, k = len(self._built), self._num_stages
        if k <= 1:
            return [0, n]
        if method == "uniform":
            return [round(i * n / k) for i in range(k + 1)]
        if method == "param":
            w, acc = [], 0
            for c in self._param_counts():
                acc += c
                w.append(acc)
            total = w[-1]
            bounds = [0]
            for s in range(1, k):
                # numpy.searchsorted(w, total * s / k) (side left), + 1
                bounds.append(sum(1 for v in w if v < total * s / k) + 1)
            bounds.append(n)
            bounds = sorted(set(min(b, n) for b in bounds))
            while len(bounds) < k + 1:        # degenerate tiny models
                bounds.append(n)
            return bounds
        if method.startswith("layer:"):
            name = method.split(":", 1)[1]
            marks = [i for i, (layer, _) in enumerate(self._built)
                     if type(layer).__name__ == name]
            if len(marks) < k:
                raise ValueError(f"only {len(marks)} '{name}' layers for "
                                 f"{k} stages")
            per = len(marks) // k
            return [0] + [marks[per * s] for s in range(1, k)] + [n]
        raise ValueError(f"unknown seg_method {method!r}")

    def get_num_stages(self):
        return self._num_stages

    def get_stage_layers(self, stage):
        lo, hi = self._boundaries[stage], self._boundaries[stage + 1]
        return [layer for layer, _ in self._built[lo:hi]]

    def stage_of_layer(self, idx):
        """numpy.searchsorted(boundaries, idx, side="right") - 1."""
        return sum(1 for b in self._boundaries if b <= idx) - 1

    def allreduce_shared_weight_gradients(self):
        """Nothing to do: a shared desc is one Layer object, so both
        stages' gradients already accumulate into the same parameter."""

    def run_segment(self, lo, hi, x):
        """Layers [lo, hi) on `x` (a shared desc through its
        forward_func)."""
        for layer, desc in self._built[lo:hi]:
            fwd = getattr(desc, "forward_func", None)
            x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def forward(self, x):
        return self.run_segment(0, len(self._built), x)


class PipelineParallel(Layer):
    """Micro-batched pipeline trainer (reference:
    meta_parallel/pipeline_parallel.py PipelineParallel.train_batch)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.schedule_mode = cfg.get("schedule_mode", "1F1B")
        self._compiled_step = None   # (shape key, step)

    def _pipeline_mesh(self):
        """The installed mesh if its pp axis holds this pipeline's
        stages."""
        from ... import env
        mesh = env.get_mesh()
        stages = self._layers.get_num_stages()
        if mesh is not None and mesh.dims.get("pp", 1) == stages > 1:
            return mesh
        return None

    def forward(self, x):
        return self._layers(x)

    def _split_micro(self, data):
        x, y = data
        m = self.accumulate_steps
        xs = x.split(m, axis=0) if m > 1 else [x]
        ys = y.split(m, axis=0) if m > 1 else [y]
        return list(zip(xs, ys))

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One pipeline step: the microbatches' forward and backward, their
        gradients accumulated, one optimizer step. Returns the mean loss
        Tensor."""
        if self._layers._loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for train_batch")
        mesh = self._pipeline_mesh()
        if mesh is not None and scaler is None and self.accumulate_steps > 1:
            loss = self._train_batch_compiled(data, optimizer, mesh)
        else:
            loss = self._train_batch_loop(data, optimizer, scaler)
        if lr_scheduler is not None and not _needs_metrics(lr_scheduler):
            lr_scheduler.step()
        return loss

    def _train_batch_loop(self, data, optimizer, scaler):
        micro = self._split_micro(data)
        m = len(micro)
        optimizer.clear_grad()
        total = None
        for x_mb, y_mb in micro:
            loss = self._layers._loss_fn(self._layers(x_mb), y_mb) / float(m)
            if scaler is not None:
                scaler.scale(loss).backward()
            else:
                loss.backward()
            d = loss.detach()
            total = d if total is None else total + d
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        return total

    def _train_batch_compiled(self, data, optimizer, mesh):
        """The pipeline over the mesh's pp axis (pp_compiled.py): the
        gradients land on `.grad` and the optimizer steps eagerly."""
        from ....nn.layer.layers import functional_state
        from .pp_compiled import make_compiled_pipeline_step
        x, y = data
        key = (tuple(x.shape), str(x.dtype), tuple(y.shape), str(y.dtype),
               self.accumulate_steps, id(mesh))
        if self._compiled_step is None or self._compiled_step[0] != key:
            mode = self.schedule_mode.lower()
            sched = {"1f1b": "1f1b", "eager1f1b": "eager1f1b",
                     "fthenb": "gpipe", "gpipe": "gpipe"}.get(mode, "1f1b")
            step = make_compiled_pipeline_step(
                self._layers, mesh, self.accumulate_steps, schedule=sched)
            self._compiled_step = (key, step)
        step = self._compiled_step[1]
        params, buffers = functional_state(self._layers)
        loss, grads, new_buffers = step(params, buffers, x._data, y._data)
        named = dict(self._layers.named_parameters())
        for n, g in grads.items():
            named[n]._data.grad = g.to(named[n]._data.dtype)
        for n, b in self._layers.named_buffers():
            if n in new_buffers:
                b._data = new_buffers[n]
        optimizer.step()
        optimizer.clear_grad()
        return _wrap(loss)

    def eval_batch(self, data, compute_loss=True):
        micro = self._split_micro(data)
        total = None
        for x_mb, y_mb in micro:
            out = self._layers(x_mb)
            if compute_loss:
                out = self._layers._loss_fn(out, y_mb) / float(len(micro))
            total = out if total is None else total + out
        return total

    @property
    def _sub_layers_inner(self):
        return self._layers
