"""GoogLeNet (Inception v1) and InceptionV3 (reference:
python/paddle/vision/models/{googlenet,inceptionv3}.py; architectures from
Szegedy et al. 2014/2015)."""
from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, Layer, Linear, MaxPool2D, ReLU, Sequential)
from ...tensor.manipulation import concat


def _cbr(inp, oup, k, stride=1, padding=0):
    return Sequential(
        Conv2D(inp, oup, k, stride=stride, padding=padding, bias_attr=False),
        BatchNorm2D(oup), ReLU())


class Inception(Layer):
    """GoogLeNet inception block: 1x1 / 3x3 / 5x5 / pool-proj branches."""

    def __init__(self, inp, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _cbr(inp, c1, 1)
        self.b3 = Sequential(_cbr(inp, c3r, 1), _cbr(c3r, c3, 3, padding=1))
        self.b5 = Sequential(_cbr(inp, c5r, 1), _cbr(c5r, c5, 5, padding=2))
        self.bp = Sequential(MaxPool2D(3, stride=1, padding=1),
                             _cbr(inp, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b3(x), self.b5(x), self.bp(x)],
                      axis=1)


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            _cbr(3, 64, 7, stride=2, padding=3),
            MaxPool2D(3, stride=2, ceil_mode=True),
            _cbr(64, 64, 1), _cbr(64, 192, 3, padding=1),
            MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.inc3 = Sequential(
            Inception(192, 64, 96, 128, 16, 32, 32),
            Inception(256, 128, 128, 192, 32, 96, 64),
            MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.inc4 = Sequential(
            Inception(480, 192, 96, 208, 16, 48, 64),
            Inception(512, 160, 112, 224, 24, 64, 64),
            Inception(512, 128, 128, 256, 24, 64, 64),
            Inception(512, 112, 144, 288, 32, 64, 64),
            Inception(528, 256, 160, 320, 32, 128, 128),
            MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.inc5 = Sequential(
            Inception(832, 256, 160, 320, 32, 128, 128),
            Inception(832, 384, 192, 384, 48, 128, 128),
        )
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.2)
            self.fc = Linear(1024, num_classes)

    def forward(self, x):
        x = self.inc5(self.inc4(self.inc3(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def googlenet(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return GoogLeNet(**kw)


# --------------------------------------------------------------- Inception V3

class InceptionStem(Layer):
    def __init__(self):
        super().__init__()
        self.stem = Sequential(
            _cbr(3, 32, 3, stride=2), _cbr(32, 32, 3),
            _cbr(32, 64, 3, padding=1), MaxPool2D(3, stride=2),
            _cbr(64, 80, 1), _cbr(80, 192, 3), MaxPool2D(3, stride=2),
        )

    def forward(self, x):
        return self.stem(x)


class InceptionA(Layer):
    def __init__(self, inp, pool_ch):
        super().__init__()
        self.b1 = _cbr(inp, 64, 1)
        self.b5 = Sequential(_cbr(inp, 48, 1), _cbr(48, 64, 5, padding=2))
        self.b3 = Sequential(_cbr(inp, 64, 1), _cbr(64, 96, 3, padding=1),
                             _cbr(96, 96, 3, padding=1))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(inp, pool_ch, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class InceptionB(Layer):
    """Grid reduction 35->17."""

    def __init__(self, inp):
        super().__init__()
        self.b3 = _cbr(inp, 384, 3, stride=2)
        self.b3d = Sequential(_cbr(inp, 64, 1), _cbr(64, 96, 3, padding=1),
                              _cbr(96, 96, 3, stride=2))
        self.bp = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.bp(x)], axis=1)


class InceptionC(Layer):
    """17x17 factorized 7x7 block."""

    def __init__(self, inp, c7):
        super().__init__()
        self.b1 = _cbr(inp, 192, 1)
        self.b7 = Sequential(_cbr(inp, c7, 1),
                             _cbr(c7, c7, (1, 7), padding=(0, 3)),
                             _cbr(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = Sequential(_cbr(inp, c7, 1),
                              _cbr(c7, c7, (7, 1), padding=(3, 0)),
                              _cbr(c7, c7, (1, 7), padding=(0, 3)),
                              _cbr(c7, c7, (7, 1), padding=(3, 0)),
                              _cbr(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(inp, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class InceptionD(Layer):
    """Grid reduction 17->8."""

    def __init__(self, inp):
        super().__init__()
        self.b3 = Sequential(_cbr(inp, 192, 1), _cbr(192, 320, 3, stride=2))
        self.b7 = Sequential(_cbr(inp, 192, 1),
                             _cbr(192, 192, (1, 7), padding=(0, 3)),
                             _cbr(192, 192, (7, 1), padding=(3, 0)),
                             _cbr(192, 192, 3, stride=2))
        self.bp = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.bp(x)], axis=1)


class InceptionE(Layer):
    """8x8 expanded-filter-bank block."""

    def __init__(self, inp):
        super().__init__()
        self.b1 = _cbr(inp, 320, 1)
        self.b3_in = _cbr(inp, 384, 1)
        self.b3_a = _cbr(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _cbr(384, 384, (3, 1), padding=(1, 0))
        self.b3d_in = Sequential(_cbr(inp, 448, 1),
                                 _cbr(448, 384, 3, padding=1))
        self.b3d_a = _cbr(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _cbr(384, 384, (3, 1), padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             _cbr(inp, 192, 1))

    def forward(self, x):
        h3 = self.b3_in(x)
        h3d = self.b3d_in(x)
        return concat([self.b1(x),
                       self.b3_a(h3), self.b3_b(h3),
                       self.b3d_a(h3d), self.b3d_b(h3d),
                       self.bp(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = InceptionStem()
        self.features = Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160), InceptionC(768, 160),
            InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048),
        )
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = Linear(2048, num_classes)

    def forward(self, x):
        x = self.features(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return InceptionV3(**kw)
