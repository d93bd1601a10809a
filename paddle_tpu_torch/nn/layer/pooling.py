"""Pooling Layers (counterpart of `paddle_tpu/nn/layer/pooling.py`) over
the port's pooling functionals."""
from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, *self.args)


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool2d(x, *self.args)


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return F.max_pool3d(x, *self.args)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, exclusive, ceil_mode)

    def forward(self, x):
        return F.avg_pool1d(x, *self.args)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool2d(x, *self.args)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, ceil_mode, exclusive,
                     divisor_override, data_format)

    def forward(self, x):
        return F.avg_pool3d(x, *self.args)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._output_size = output_size
        self._return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._output_size,
                                     return_mask=self._return_mask)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self.args
        return F.max_unpool1d(x, indices, k, stride=s, padding=p,
                              output_size=o)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self.args
        return F.max_unpool2d(x, indices, k, stride=s, padding=p,
                              output_size=o)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, output_size)

    def forward(self, x, indices):
        k, s, p, o = self.args
        return F.max_unpool3d(x, indices, k, stride=s, padding=p,
                              output_size=o)
