"""paddle.incubate.optimizer of the port: LookAhead, ModelAverage and the
functional minimizers."""
from . import functional  # noqa: F401
from .wrappers import LookAhead, ModelAverage  # noqa: F401
