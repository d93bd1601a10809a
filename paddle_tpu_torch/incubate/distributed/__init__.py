"""paddle.incubate.distributed of the port (counterpart of
`paddle_tpu/incubate/distributed`): `fleet` (segment recompute) and `moe`
(mixture of experts with expert parallelism)."""
from . import fleet  # noqa: F401
from . import moe  # noqa: F401
