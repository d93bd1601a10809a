"""paddle.hapi for the port (counterpart of `paddle_tpu/hapi`)."""
from . import callbacks  # noqa: F401
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger, VisualDL,
)
from .model import Model  # noqa: F401
from .model_summary import flops, summary  # noqa: F401
