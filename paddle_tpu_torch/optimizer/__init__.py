"""paddle.optimizer for the port (counterpart of
`paddle_tpu/optimizer/__init__.py`)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, LarsMomentum, Momentum,
    NAdam, Optimizer, RAdam, RMSProp, SGD,
)
