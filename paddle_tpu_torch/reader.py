"""paddle.reader for the port (counterpart of `paddle_tpu/reader.py`)."""
from .batch import (  # noqa: F401
    batch, chain, compose, firstn, map_readers, shuffle,
)
