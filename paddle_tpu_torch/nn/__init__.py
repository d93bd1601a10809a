"""paddle.nn for the port (counterpart of `paddle_tpu/nn/__init__.py`).

Ported: `Layer` and its containers, every functional, the initializers,
the common, activation, norm, loss and transformer Layers, gradient
clipping and `ParamAttr`. The conv and pooling Layers and `nn.utils`
come with ROADMAP A.13c; the RNN Layers and `decode` with A.13d (their
functionals are here)."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)
from .param_attr import ParamAttr  # noqa: F401
from .layer.layers import Layer, functional_call, functional_state  # noqa: F401
from .layer.activation import *  # noqa: F401,F403
from .layer.common import *  # noqa: F401,F403
from .layer.container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
