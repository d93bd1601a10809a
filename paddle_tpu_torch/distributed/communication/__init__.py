"""paddle.distributed.communication (reference layout): stream submodule."""
from . import stream  # noqa: F401
