"""MoE gates (counterpart of `paddle_tpu/incubate/distributed/moe/
gate.py`; reference: python/paddle/incubate/distributed/models/moe/gate/
naive_gate.py, switch_gate.py, gshard_gate.py). All three reduce to the
same capacity-constrained top-k routing (`functional.gshard_dispatch`);
they differ in k, whether the load-balance aux loss applies, and
training-time jitter — each gate is a thin Layer carrying its linear
scorer plus that config, consumed by `MoELayer.forward`.
"""
import math

from ....nn.layer.layers import Layer
from .functional import compute_capacity


class BaseGate(Layer):
    top_k = 1
    has_aux_loss = True
    jitter_eps = 0.0      # >0: multiply train-time logits by U[1-eps, 1+eps]

    def __init__(self, d_model, num_experts, capacity_factor=1.2):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        s = 1.0 / math.sqrt(d_model)
        from ....nn.initializer import Uniform
        self.weight = self.create_parameter(
            (d_model, num_experts), default_initializer=Uniform(-s, s))

    def capacity(self, num_tokens):
        return compute_capacity(self.capacity_factor, self.top_k,
                                num_tokens, self.num_experts)


class NaiveGate(BaseGate):
    """Top-2 routing, no balance loss, no jitter (reference naive_gate.py)."""
    top_k = 2
    has_aux_loss = False


class SwitchGate(BaseGate):
    """Top-1 routing with load-balance aux loss and train-time logit jitter
    (reference switch_gate.py)."""
    top_k = 1

    def __init__(self, d_model, num_experts, capacity_factor=1.2,
                 switch_eps=0.1):
        super().__init__(d_model, num_experts, capacity_factor)
        self.jitter_eps = switch_eps


class GShardGate(BaseGate):
    """Top-2 routing with capacity + aux loss (reference gshard_gate.py)."""
    top_k = 2
