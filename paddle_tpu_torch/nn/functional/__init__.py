"""paddle.nn.functional for the port (counterpart of
`paddle_tpu/nn/functional/__init__.py`)."""
from .activation import *  # noqa: F401,F403
from .attention import scaled_dot_product_attention, sparse_attention  # noqa: F401
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
