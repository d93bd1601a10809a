"""paddle.sparse.nn of the port (counterpart of
`paddle_tpu/sparse/nn/__init__.py`): Layers over sparse tensors. ReLU and
BatchNorm act on the values; the 3-D convolutions are in `conv.py`."""
from ...nn.layer.layers import Layer
from .conv import Conv3D, SubmConv3D, conv3d, subm_conv3d  # noqa: F401
from . import functional  # noqa: F401

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "Softmax", "BatchNorm",
           "SyncBatchNorm", "MaxPool3D", "Conv3D", "SubmConv3D"]


class ReLU(Layer):
    def forward(self, x):
        from .. import relu
        return relu(x)


class BatchNorm(Layer):
    """BatchNorm over the stored values (per channel, the last dim)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5):
        super().__init__()
        from ...nn import BatchNorm1D
        self._bn = BatchNorm1D(num_features, momentum=momentum,
                               epsilon=epsilon)

    def forward(self, x):
        from .. import SparseCooTensor
        return SparseCooTensor(x.indices_, self._bn(x.values_), x.shape)


class ReLU6(Layer):
    def forward(self, x):
        return functional.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return functional.leaky_relu(x, self._slope)


class Softmax(Layer):
    """Softmax over each row's stored values."""

    def __init__(self, axis=-1):
        super().__init__()

    def forward(self, x):
        return functional.softmax(x)


class SyncBatchNorm(BatchNorm):
    """Cross-replica statistics: with one controller the batch holds every
    replica's sites, so this is BatchNorm (as in the reference)."""


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NDHWC", name=None):
        super().__init__()
        self._k = kernel_size
        self._s = stride or kernel_size
        self._p = padding

    def forward(self, x):
        return functional.max_pool3d(x, self._k, self._s, self._p)
