"""paddle.incubate of the port (counterpart of `paddle_tpu/incubate`).

Only `incubate.distributed` (fleet's segment recompute and the
mixture-of-experts layers) is here; the rest of the reference's incubate
(asp, autograd, checkpoint, nn, optimizer, operators) comes with ROADMAP
A.13h.
"""
from . import distributed  # noqa: F401
