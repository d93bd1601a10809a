"""paddle.callbacks for the port (counterpart of `paddle_tpu/callbacks.py`):
the hapi callbacks."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]
