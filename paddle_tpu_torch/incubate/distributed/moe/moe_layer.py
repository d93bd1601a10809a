"""The eager MoELayer (counterpart of
`paddle_tpu/incubate/distributed/moe/moe_layer.py`; reference:
python/paddle/incubate/distributed/models/moe/moe_layer.py: gate ->
global_scatter -> experts -> global_gather -> combine). All experts are
local, as the reference's with mp_group=None; expert parallelism is
`functional.moe_forward(axis_name="ep")` in a manual region."""
import math

from ....core.tensor import apply_op
from ....nn.initializer import Uniform
from ....nn.layer.layers import Layer
from .functional import _gelu, moe_forward
from .gate import BaseGate, GShardGate, NaiveGate, SwitchGate

__all__ = ["MoELayer"]

_GATES = {"gshard": GShardGate, "naive": NaiveGate, "switch": SwitchGate}


class MoELayer(Layer):
    """Mixture-of-experts FFN with stacked expert weights.

    Args: d_model, d_hidden, num_experts (global), gate ("gshard" |
    "switch" | "naive" or a BaseGate), capacity_factor. `forward` returns
    the routed output; the load-balancing loss of the latest forward is
    `self.aux_loss` (on the tape: add `layer.aux_loss * coeff` to the
    training loss)."""

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 capacity_factor=None, activation=_gelu):
        super().__init__()
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.activation = activation
        if isinstance(gate, BaseGate):
            self.gate = gate
            if capacity_factor is not None:
                self.gate.capacity_factor = capacity_factor
        else:
            self.gate = _GATES[gate](d_model, num_experts,
                                     capacity_factor
                                     if capacity_factor is not None else 1.2)
        s1 = 1.0 / math.sqrt(d_model)
        s2 = 1.0 / math.sqrt(d_hidden)
        self.w1 = self.create_parameter((num_experts, d_model, d_hidden),
                                        default_initializer=Uniform(-s1, s1))
        self.b1 = self.create_parameter((num_experts, d_hidden), is_bias=True)
        self.w2 = self.create_parameter((num_experts, d_hidden, d_model),
                                        default_initializer=Uniform(-s2, s2))
        self.b2 = self.create_parameter((num_experts, d_model), is_bias=True)
        self.aux_loss = None

    def forward(self, x):
        k = self.gate.top_k
        cf = self.gate.capacity_factor
        act = self.activation
        jitter = None
        if self.training and self.gate.jitter_eps > 0:
            from ....core.random import generator
            jitter = (generator(x._data.device), self.gate.jitter_eps)

        def fn(xd, gw, w1, b1, w2, b2):
            t = xd.reshape(-1, xd.shape[-1])
            out, aux = moe_forward(
                t, gw, {"w1": w1, "b1": b1, "w2": w2, "b2": b2},
                k=k, capacity_factor=cf, activation=act,
                jitter_noise=jitter)
            return out.reshape(xd.shape), aux

        out, aux = apply_op(fn, x, self.gate.weight, self.w1, self.b1,
                            self.w2, self.b2, name="moe")
        self.aux_loss = aux if self.gate.has_aux_loss else aux * 0.0
        return out

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, "
                f"gate={type(self.gate).__name__}")
