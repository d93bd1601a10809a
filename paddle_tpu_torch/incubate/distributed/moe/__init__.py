"""Mixture of experts with expert parallelism (counterpart of
`paddle_tpu/incubate/distributed/moe`; reference:
python/paddle/incubate/distributed/models/moe/: MoELayer, the gshard /
switch / naive gates, and the expert-parallel `global_scatter` /
`global_gather` pair).

Dispatch and combine are dense products against a (token, expert,
capacity) one-hot, as in the reference port. Expert parallelism runs in a
one-controller manual region: `moe_forward(..., axis_name="ep")` takes
one value a rank of the ep group and exchanges the dispatched tokens with
the list `all_to_all` of `parallel/collectives.py`, one each way.
"""
from .functional import (compute_capacity, gshard_dispatch,  # noqa: F401
                         init_moe_experts, moe_forward)
from .gate import GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import MoELayer

__all__ = ["ClipGradForMOEByGlobalNorm", "compute_capacity",
           "gshard_dispatch", "moe_forward", "init_moe_experts",
           "GShardGate", "SwitchGate", "NaiveGate", "MoELayer"]
