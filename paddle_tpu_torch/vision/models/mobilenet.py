"""MobileNet v1/v2 (reference: python/paddle/vision/models/mobilenetv1.py, v2)."""
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Flatten, Layer,
                   Linear, ReLU, ReLU6, Sequential)


def conv_bn(inp, oup, stride):
    return Sequential(
        Conv2D(inp, oup, 3, stride=stride, padding=1, bias_attr=False),
        BatchNorm2D(oup), ReLU())


def conv_dw(inp, oup, stride):
    return Sequential(
        Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp, bias_attr=False),
        BatchNorm2D(inp), ReLU(),
        Conv2D(inp, oup, 1, bias_attr=False),
        BatchNorm2D(oup), ReLU())


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: max(int(c * scale), 8)  # noqa: E731
        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1), (s(256), s(512), 2),
               (s(512), s(512), 1), (s(512), s(512), 1), (s(512), s(512), 1),
               (s(512), s(512), 1), (s(512), s(512), 1), (s(512), s(1024), 2),
               (s(1024), s(1024), 1)]
        layers = [conv_bn(3, s(32), 2)]
        for inp, oup, stride in cfg:
            layers.append(conv_dw(inp, oup, stride))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(inp, hidden, 1, bias_attr=False),
                       BatchNorm2D(hidden), ReLU6()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1, groups=hidden,
                   bias_attr=False),
            BatchNorm2D(hidden), ReLU6(),
            Conv2D(hidden, oup, 1, bias_attr=False), BatchNorm2D(oup)]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        input_channel = int(32 * scale)
        last_channel = int(1280 * max(1.0, scale))
        layers = [Sequential(Conv2D(3, input_channel, 3, stride=2, padding=1,
                                    bias_attr=False),
                             BatchNorm2D(input_channel), ReLU6())]
        for t, c, n, s in cfg:
            out_c = int(c * scale)
            for i in range(n):
                layers.append(InvertedResidual(input_channel, out_c,
                                               s if i == 0 else 1, t))
                input_channel = out_c
        layers.append(Sequential(Conv2D(input_channel, last_channel, 1,
                                        bias_attr=False),
                                 BatchNorm2D(last_channel), ReLU6()))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.classifier = Linear(last_channel, num_classes)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return MobileNetV2(scale=scale, **kwargs)
