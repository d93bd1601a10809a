"""SqueezeNet 1.0/1.1 (reference: python/paddle/vision/models/squeezenet.py;
architecture from Iandola et al. 2016)."""
from ...core.tensor import Tensor
from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Layer, MaxPool2D,
                   ReLU, Sequential)
from ...tensor.manipulation import concat


class Fire(Layer):
    def __init__(self, inp, squeeze, e1x1, e3x3):
        super().__init__()
        self.squeeze = Sequential(Conv2D(inp, squeeze, 1), ReLU())
        self.expand1 = Sequential(Conv2D(squeeze, e1x1, 1), ReLU())
        self.expand3 = Sequential(Conv2D(squeeze, e3x3, 3, padding=1), ReLU())

    def forward(self, x):
        s = self.squeeze(x)
        return concat([self.expand1(s), self.expand3(s)], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(512, 64, 256, 256),
            )
        else:
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2), ReLU(),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Conv2D(512, num_classes, 1), ReLU())
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return SqueezeNet("1.1", **kwargs)
