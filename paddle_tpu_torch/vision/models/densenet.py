"""DenseNet 121/161/169/201/264 (reference:
python/paddle/vision/models/densenet.py; architecture from Huang et al.
2017). Dense blocks concatenate every prior feature map along channels."""
from ...nn import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                   Dropout, Layer, Linear, MaxPool2D, ReLU, Sequential)
from ...tensor.manipulation import concat

_CFG = {
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
    264: (64, 32, (6, 12, 64, 48)),
}


class DenseLayer(Layer):
    def __init__(self, in_ch, growth, bn_size, dropout):
        super().__init__()
        self.bottleneck = Sequential(
            BatchNorm2D(in_ch), ReLU(),
            Conv2D(in_ch, bn_size * growth, 1, bias_attr=False),
            BatchNorm2D(bn_size * growth), ReLU(),
            Conv2D(bn_size * growth, growth, 3, padding=1, bias_attr=False),
        )
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.bottleneck(x)
        if self.dropout is not None:
            out = self.dropout(out)
        return concat([x, out], axis=1)


class DenseBlock(Layer):
    def __init__(self, in_ch, growth, bn_size, n, dropout):
        super().__init__()
        layers = []
        for i in range(n):
            layers.append(DenseLayer(in_ch + i * growth, growth, bn_size,
                                     dropout))
        self.layers = Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class TransitionLayer(Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.down = Sequential(
            BatchNorm2D(in_ch), ReLU(),
            Conv2D(in_ch, out_ch, 1, bias_attr=False),
            AvgPool2D(2, stride=2),
        )

    def forward(self, x):
        return self.down(x)


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        if layers not in _CFG:
            raise ValueError(f"DenseNet-{layers} not supported: {_CFG.keys()}")
        num_init, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            Conv2D(3, num_init, 7, stride=2, padding=3, bias_attr=False),
            BatchNorm2D(num_init), ReLU(),
            MaxPool2D(3, stride=2, padding=1),
        )
        ch = num_init
        feats = []
        for i, n in enumerate(blocks):
            feats.append(DenseBlock(ch, growth, bn_size, n, dropout))
            ch += n * growth
            if i != len(blocks) - 1:
                feats.append(TransitionLayer(ch, ch // 2))
                ch //= 2
        self.features = Sequential(*feats)
        self.norm = BatchNorm2D(ch)
        self.relu = ReLU()
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(ch, num_classes)

    def forward(self, x):
        x = self.relu(self.norm(self.features(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _make(layers, pretrained, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return DenseNet(layers=layers, **kw)


def densenet121(pretrained=False, **kw):
    return _make(121, pretrained, **kw)


def densenet161(pretrained=False, **kw):
    return _make(161, pretrained, **kw)


def densenet169(pretrained=False, **kw):
    return _make(169, pretrained, **kw)


def densenet201(pretrained=False, **kw):
    return _make(201, pretrained, **kw)


def densenet264(pretrained=False, **kw):
    return _make(264, pretrained, **kw)
