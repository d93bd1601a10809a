"""paddle.device.cuda for the port: the CUDA device's streams, events and
memory statistics, which here are torch.cuda's (counterpart of
`paddle_tpu/device/cuda/__init__.py`, where XLA owns them)."""
import torch

__all__ = ["Stream", "Event", "current_stream", "synchronize",
           "device_count", "empty_cache", "max_memory_allocated",
           "max_memory_reserved", "memory_allocated", "memory_reserved",
           "stream_guard", "get_device_properties", "get_device_name",
           "get_device_capability"]

Stream = torch.cuda.Stream
Event = torch.cuda.Event
stream_guard = torch.cuda.stream


def _dev(device):
    if device is None:
        return torch.cuda.current_device()
    if isinstance(device, int):
        return device
    return torch.device(str(device).replace("gpu", "cuda"))


def current_stream(device=None):
    return torch.cuda.current_stream(_dev(device))


def synchronize(device=None):
    torch.cuda.synchronize(_dev(device))


def device_count():
    return torch.cuda.device_count()


def empty_cache():
    torch.cuda.empty_cache()


def memory_allocated(device=None):
    return torch.cuda.memory_allocated(_dev(device))


def max_memory_allocated(device=None):
    return torch.cuda.max_memory_allocated(_dev(device))


def memory_reserved(device=None):
    return torch.cuda.memory_reserved(_dev(device))


def max_memory_reserved(device=None):
    return torch.cuda.max_memory_reserved(_dev(device))


def get_device_properties(device=None):
    return torch.cuda.get_device_properties(_dev(device))


def get_device_name(device=None):
    return torch.cuda.get_device_name(_dev(device))


def get_device_capability(device=None):
    return torch.cuda.get_device_capability(_dev(device))
