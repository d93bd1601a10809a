"""`DataParallel` (counterpart of the `DataParallel` of
`paddle_tpu/distributed/parallel_layers.py`).

As in the reference, the wrapper is transparent: it calls the wrapped
Layer and hands on its state. `apply_collective_grads()` averages each
parameter's gradient over the live dp group: under a process group of
world > 1, one all-reduce of the gradients' f32 concatenation across the
processes. In a one-process manual region every rank shares the Layer's
parameters, so the mean over the axis is the gradient itself. No hook is
added to the backward, as the reference adds none.

The reference module's fleet half (`HybridParallelOptimizer`,
`param_partition_spec`, `wrap_distributed_model`) comes with fleet's
hybrid parallelism (ROADMAP A.13f(ii)).
"""
from ..nn.layer.layers import Layer
from . import collective as C
from . import env

__all__ = ["DataParallel"]


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
        if not env.process_group_live():
            return
        params = [p for p in self._layers.parameters()
                  if p._data.grad is not None]
        grads = [p._data.grad.detach().clone() for p in params]
        C.all_reduce_mean_(grads)
        for p, g in zip(params, grads):
            p._data.grad = g.to(p._data.grad.dtype)

    @property
    def _sub_layers_inner(self):
        return self._layers
