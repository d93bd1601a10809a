"""MobileNetV3 Large/Small (reference:
python/paddle/vision/models/mobilenetv3.py; architecture from Howard et al.
2019): inverted residuals + squeeze-excitation + hard-swish."""
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                   Hardsigmoid, Hardswish, Layer, Linear, ReLU, Sequential)


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcitation(Layer):
    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, squeeze_ch, 1)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_ch, ch, 1)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class InvertedResidualConfig:
    def __init__(self, in_ch, kernel, expanded, out_ch, use_se, activation,
                 stride, scale=1.0):
        self.in_ch = _make_divisible(in_ch * scale)
        self.kernel = kernel
        self.expanded = _make_divisible(expanded * scale)
        self.out_ch = _make_divisible(out_ch * scale)
        self.use_se = use_se
        self.use_hs = activation == "HS"
        self.stride = stride


class _MBV3Block(Layer):
    def __init__(self, cfg):
        super().__init__()
        self.use_res = cfg.stride == 1 and cfg.in_ch == cfg.out_ch
        act = Hardswish if cfg.use_hs else ReLU
        layers = []
        if cfg.expanded != cfg.in_ch:
            layers += [Conv2D(cfg.in_ch, cfg.expanded, 1, bias_attr=False),
                       BatchNorm2D(cfg.expanded), act()]
        layers += [Conv2D(cfg.expanded, cfg.expanded, cfg.kernel,
                          stride=cfg.stride, padding=cfg.kernel // 2,
                          groups=cfg.expanded, bias_attr=False),
                   BatchNorm2D(cfg.expanded), act()]
        if cfg.use_se:
            layers.append(SqueezeExcitation(
                cfg.expanded, _make_divisible(cfg.expanded // 4)))
        layers += [Conv2D(cfg.expanded, cfg.out_ch, 1, bias_attr=False),
                   BatchNorm2D(cfg.out_ch)]
        self.block = Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(Layer):
    def __init__(self, configs, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        first = configs[0].in_ch
        self.stem = Sequential(
            Conv2D(3, first, 3, stride=2, padding=1, bias_attr=False),
            BatchNorm2D(first), Hardswish())
        self.blocks = Sequential(*[_MBV3Block(c) for c in configs])
        last_in = configs[-1].out_ch
        last_exp = 6 * last_in
        self.final = Sequential(
            Conv2D(last_in, last_exp, 1, bias_attr=False),
            BatchNorm2D(last_exp), Hardswish())
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(last_exp, last_channel), Hardswish(),
                Dropout(0.2), Linear(last_channel, num_classes))

    def forward(self, x):
        x = self.final(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _large_configs(scale):
    C = InvertedResidualConfig
    return [
        C(16, 3, 16, 16, False, "RE", 1, scale),
        C(16, 3, 64, 24, False, "RE", 2, scale),
        C(24, 3, 72, 24, False, "RE", 1, scale),
        C(24, 5, 72, 40, True, "RE", 2, scale),
        C(40, 5, 120, 40, True, "RE", 1, scale),
        C(40, 5, 120, 40, True, "RE", 1, scale),
        C(40, 3, 240, 80, False, "HS", 2, scale),
        C(80, 3, 200, 80, False, "HS", 1, scale),
        C(80, 3, 184, 80, False, "HS", 1, scale),
        C(80, 3, 184, 80, False, "HS", 1, scale),
        C(80, 3, 480, 112, True, "HS", 1, scale),
        C(112, 3, 672, 112, True, "HS", 1, scale),
        C(112, 5, 672, 160, True, "HS", 2, scale),
        C(160, 5, 960, 160, True, "HS", 1, scale),
        C(160, 5, 960, 160, True, "HS", 1, scale),
    ]


def _small_configs(scale):
    C = InvertedResidualConfig
    return [
        C(16, 3, 16, 16, True, "RE", 2, scale),
        C(16, 3, 72, 24, False, "RE", 2, scale),
        C(24, 3, 88, 24, False, "RE", 1, scale),
        C(24, 5, 96, 40, True, "HS", 2, scale),
        C(40, 5, 240, 40, True, "HS", 1, scale),
        C(40, 5, 240, 40, True, "HS", 1, scale),
        C(40, 5, 120, 48, True, "HS", 1, scale),
        C(48, 5, 144, 48, True, "HS", 1, scale),
        C(48, 5, 288, 96, True, "HS", 2, scale),
        C(96, 5, 576, 96, True, "HS", 1, scale),
        C(96, 5, 576, 96, True, "HS", 1, scale),
    ]


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_large_configs(scale),
                         _make_divisible(1280 * scale), scale,
                         num_classes, with_pool)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_small_configs(scale),
                         _make_divisible(1024 * scale), scale,
                         num_classes, with_pool)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV3Small(scale=scale, **kw)
