"""Activation layers (counterpart of `paddle_tpu/nn/layer/activation.py`)."""
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Softmax",
           "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU", "Hardswish",
           "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
           "Softplus", "Softsign", "Mish", "PReLU", "Maxout",
           "ThresholdedReLU", "LogSigmoid", "Swish", "Softmax2D", "RReLU"]


class ReLU(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class ReLU6(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu6(x)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, self._approximate)


class Sigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class Silu(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.silu(x)


Swish = Silu


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, self._axis)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self._scale, self._alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self._scale, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardswish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardswish(x)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self._threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self._threshold)


class Tanhshrink(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanhshrink(x)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softsign(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.softsign(x)


class Mish(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.mish(x)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self._threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold)


class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Swish(Layer):
    def forward(self, x):
        return F.swish(x)


class Softmax2D(Layer):
    """Softmax over the channel dim of (N, C, H, W) (reference
    nn/layer/activation.py Softmax2D)."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self._lower = lower
        self._upper = upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)
