"""paddle.incubate of the port (counterpart of `paddle_tpu/incubate`):
`autotune` (the kernels' tile table), `distributed` (fleet's segment
recompute and the mixture-of-experts layers), `nn` (the fused transformer
Layers and functionals), `asp`, `checkpoint`, `optimizer`, `operators`
and `autograd`."""
from . import autotune  # noqa: F401
from . import distributed  # noqa: F401
from . import nn  # noqa: F401
from . import asp  # noqa: F401
from . import checkpoint  # noqa: F401
from . import optimizer  # noqa: F401
from . import operators  # noqa: F401
from . import autograd  # noqa: F401
from .operators import (  # noqa: F401
    graph_khop_sampler, graph_reindex, graph_sample_neighbors,
    graph_send_recv, identity_loss, segment_max, segment_mean, segment_min,
    segment_sum, softmax_mask_fuse, softmax_mask_fuse_upper_triangle)
from .optimizer import LookAhead, ModelAverage  # noqa: F401
