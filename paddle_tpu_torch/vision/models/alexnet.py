"""AlexNet (reference: python/paddle/vision/models/alexnet.py; architecture
from Krizhevsky et al. 2012)."""
from ...nn import (AdaptiveAvgPool2D, Conv2D, Dropout, Layer, Linear,
                   MaxPool2D, ReLU, Sequential)


class AlexNet(Layer):
    def __init__(self, num_classes=1000, dropout=0.5):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, stride=2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(dropout), Linear(256 * 6 * 6, 4096), ReLU(),
                Dropout(dropout), Linear(4096, 4096), ReLU(),
                Linear(4096, num_classes),
            )

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError("pretrained weights are not bundled")
    return AlexNet(**kwargs)
