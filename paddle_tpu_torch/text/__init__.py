"""Text models of the port."""
from . import models  # noqa: F401
