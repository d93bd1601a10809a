"""paddle.nn for the port (counterpart of `paddle_tpu/nn/__init__.py`).

Ported: `Layer` and its containers, every functional, the initializers,
the common, activation, conv, pooling, norm, loss and transformer Layers,
gradient clipping, `ParamAttr`, `nn.utils`, the RNN Layers and the
beam-search `decode`."""
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
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
)
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import (  # noqa: F401
    BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from . import utils  # noqa: F401
