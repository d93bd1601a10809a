"""`DataParallel` and fleet's hybrid wrappers (counterpart of
`paddle_tpu/distributed/parallel_layers.py`).

As in the reference, `DataParallel` is transparent: it calls the wrapped
Layer and hands on its state. `apply_collective_grads()` averages each
parameter's gradient over the live dp group (`average_grads_`): under a
process group of world > 1, one all-reduce of the gradients' f32
concatenation across the processes. In a one-process manual region every
rank shares the Layer's parameters, so the mean over the axis is the
gradient itself. No hook is added to the backward, as the reference adds
none.

Fleet's half: `param_partition_spec` (a parameter's split over the mesh
as a tuple of axis names, entry for entry the reference's
`PartitionSpec`), `HybridParallelOptimizer` (averages the gradients over
the dp group with the same `average_grads_`, then the inner step) and
`wrap_distributed_model` (the topology dispatch; a model whose mp axis
spans the processes keeps this process's rows of every parameter the mp
layers mark: `mp_layers.shard_mp_params`).
"""
from ..nn.layer.layers import Layer
from . import collective as C
from . import env

__all__ = ["DataParallel", "HybridParallelOptimizer",
           "param_partition_spec", "wrap_distributed_model",
           "average_grads_"]


def average_grads_(params, group=None):
    """Average the gradients of `params` over the dp group's processes in
    one f32 all-reduce: the world's under a process group of world > 1
    (or the processes of `group`, a dp axis group spanning them);
    nothing otherwise."""
    if group is not None:
        if not group.spans_processes():
            return
        pg = group.process_group
    elif env.process_group_live():
        pg = None
    else:
        return
    params = [p for p in params if p._data.grad is not None]
    grads = [p._data.grad.detach().clone() for p in params]
    C.all_reduce_mean_(grads, pg)
    for p, g in zip(params, grads):
        p._data.grad = g.to(p._data.grad.dtype)


class DataParallel(Layer):
    """paddle.DataParallel: transparent; keeps the reference's surface."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Average every gradient over the live dp group (the process
        group when its world is above 1)."""
        average_grads_(self._layers.parameters())

    @property
    def _sub_layers_inner(self):
        return self._layers


def _dims_of(hcg):
    """{axis: size} of a HybridCommunicateGroup, a mesh or a dict."""
    if hcg is None:
        return {}
    if hasattr(hcg, "get_model_parallel_world_size"):
        return {"mp": hcg.get_model_parallel_world_size(),
                "sharding": hcg.get_sharding_parallel_world_size()}
    return dict(getattr(hcg, "dims", hcg))


def param_partition_spec(p, hcg):
    """The parameter's split as a tuple over its dims of axis names or
    None (the reference's PartitionSpec, entry for entry):

    - tensor parallelism: `split_axis` over "mp" when mp > 1;
    - ZeRO (sharding > 1): the first remaining dim divisible by the
      sharding degree over "sharding"."""
    dims = _dims_of(hcg)
    shape = tuple(p._data.shape)
    spec = [None] * len(shape)
    ax = getattr(p, "split_axis", None)
    if getattr(p, "is_distributed", False) and ax is not None and \
            dims.get("mp", 1) > 1 and ax < len(shape):
        spec[ax] = "mp"
    deg = dims.get("sharding", 1)
    if deg > 1:
        for i, size in enumerate(shape):
            if spec[i] is None and size % deg == 0 and size >= deg:
                spec[i] = "sharding"
                break
    return tuple(spec)


class HybridParallelOptimizer:
    """Wraps a base optimizer: `step()` averages the gradients over the
    dp group (`average_grads_`, the group of fleet's topology) and then
    runs the inner step."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _dp_group(self):
        if self._hcg is None or \
                self._hcg.get_data_parallel_world_size() <= 1:
            return None
        return self._hcg.get_data_parallel_group()

    def step(self):
        group = self._dp_group()
        if group is not None or self._hcg is None:
            average_grads_(self._inner_opt._parameters, group)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()


def wrap_distributed_model(model, hcg, strategy):
    """Topology dispatch (reference fleet/model.py:120-151)."""
    if hcg is None:
        return DataParallel(model)
    group = hcg.get_model_parallel_group()
    if hcg.get_model_parallel_world_size() > 1 and group.spans_processes():
        from .fleet.layers.mp_layers import shard_mp_params
        shard_mp_params(model, hcg.get_model_parallel_rank(),
                        hcg.get_model_parallel_world_size(),
                        group.process_group)
    if hcg.get_parallel_mode() == "pipeline":
        from .fleet.meta_parallel import PipelineLayer, PipelineParallel
        if isinstance(model, PipelineLayer):
            return PipelineParallel(model, hcg, strategy)
    return DataParallel(model)
