from .device import DEFAULT_DEVICE, resolve_device  # noqa: F401

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
