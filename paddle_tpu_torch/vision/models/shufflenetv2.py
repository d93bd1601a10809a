"""ShuffleNetV2 (reference: python/paddle/vision/models/shufflenetv2.py;
architecture from Ma et al. 2018). The channel-shuffle op routes through
nn.functional.channel_shuffle."""
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Layer, Linear,
                   MaxPool2D, ReLU, Sequential, Swish)
from ...nn import functional as F
from ...tensor.manipulation import concat, split

_CFG = {
    0.25: (24, (24, 48, 96), 512),
    0.33: (24, (32, 64, 128), 512),
    0.5: (24, (48, 96, 192), 1024),
    1.0: (24, (116, 232, 464), 1024),
    1.5: (24, (176, 352, 704), 1024),
    2.0: (24, (244, 488, 976), 2048),
}


def _conv_bn_relu(inp, oup, k, stride=1, groups=1, relu=True, act="relu"):
    pad = k // 2
    layers = [Conv2D(inp, oup, k, stride=stride, padding=pad, groups=groups,
                     bias_attr=False), BatchNorm2D(oup)]
    if relu:
        layers.append(Swish() if act == "swish" else ReLU())
    return Sequential(*layers)


class InvertedResidualDS(Layer):
    """Downsampling unit: both branches convolve, outputs concatenated."""

    def __init__(self, inp, oup, stride, act="relu"):
        super().__init__()
        half = oup // 2
        self.branch1 = Sequential(
            _conv_bn_relu(inp, inp, 3, stride, groups=inp, relu=False),
            _conv_bn_relu(inp, half, 1, act=act),
        )
        self.branch2 = Sequential(
            _conv_bn_relu(inp, half, 1, act=act),
            _conv_bn_relu(half, half, 3, stride, groups=half, relu=False),
            _conv_bn_relu(half, half, 1, act=act),
        )

    def forward(self, x):
        out = concat([self.branch1(x), self.branch2(x)], axis=1)
        return F.channel_shuffle(out, 2)


class InvertedResidualUnit(Layer):
    """Stride-1 unit: split, transform one half, concat, shuffle."""

    def __init__(self, ch, act="relu"):
        super().__init__()
        half = ch // 2
        self.branch = Sequential(
            _conv_bn_relu(half, half, 1, act=act),
            _conv_bn_relu(half, half, 3, 1, groups=half, relu=False),
            _conv_bn_relu(half, half, 1, act=act),
        )

    def forward(self, x):
        x1, x2 = split(x, 2, axis=1)
        out = concat([x1, self.branch(x2)], axis=1)
        return F.channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _CFG:
            raise ValueError(f"scale {scale} not in {sorted(_CFG)}")
        stem_ch, stage_chs, final_ch = _CFG[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(_conv_bn_relu(3, stem_ch, 3, 2, act=act),
                               MaxPool2D(3, stride=2, padding=1))
        stages = []
        inp = stem_ch
        for ch, repeat in zip(stage_chs, (4, 8, 4)):
            units = [InvertedResidualDS(inp, ch, 2, act=act)]
            for _ in range(repeat - 1):
                units.append(InvertedResidualUnit(ch, act=act))
            stages.append(Sequential(*units))
            inp = ch
        self.stages = Sequential(*stages)
        self.final = _conv_bn_relu(inp, final_ch, 1, act=act)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(final_ch, num_classes)

    def forward(self, x):
        x = self.final(self.stages(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return ShuffleNetV2(scale=1.0, act="swish", **kw)
