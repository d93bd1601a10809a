"""paddle.device for the port (counterpart of
`paddle_tpu/device/__init__.py`).

`op_cache_stats`, `reset_op_cache_stats` and `clear_op_cache` keep the
reference's signatures and count nothing: the reference caches one XLA
executable per eager op, and torch dispatches eagerly, so the port has
no op cache (ROADMAP C.14). `compile_cache_stats` is the persistent
compile cache's (`framework.compile_cache`), which holds the port's
kernel libraries. `synchronize` and `current_stream` run on CUDA."""
import torch

from . import cuda  # noqa: F401
from ..core.device import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, device_count, get_device,
    is_compiled_with_cuda, is_compiled_with_npu, is_compiled_with_tpu,
    is_compiled_with_xpu, set_device,
)

__all__ = ["cuda", "CPUPlace", "CUDAPlace", "Place", "device_count",
           "get_device", "set_device", "is_compiled_with_cuda",
           "is_compiled_with_npu", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "op_cache_stats", "reset_op_cache_stats",
           "clear_op_cache", "compile_cache_stats",
           "get_all_custom_device_type", "is_compiled_with_custom_device",
           "Stream", "synchronize", "current_stream", "get_cudnn_version",
           "is_compiled_with_ipu", "is_compiled_with_cinn",
           "is_compiled_with_rocm", "is_compiled_with_mlu",
           "get_all_device_type", "get_available_device",
           "get_available_custom_device"]


def op_cache_stats():
    """{hits, misses, bypass, size, hit_rate}: all zero, since eager ops
    are not compiled and cached in the port."""
    return {"hits": 0, "misses": 0, "bypass": 0, "size": 0,
            "hit_rate": 0.0}


def reset_op_cache_stats():
    """Nothing to reset (see op_cache_stats)."""


def clear_op_cache():
    """Nothing to drop (see op_cache_stats)."""


def compile_cache_stats():
    """Stats of the process-global persistent compile cache, or None when
    none is attached: {hits, misses, ..., entries, path}."""
    from ..framework import compile_cache as _cc
    cache = _cc.active()
    if cache is None:
        return None
    return {**cache.stats, "entries": len(cache.entries()),
            "path": cache.path}


def get_all_custom_device_type():
    return []


def is_compiled_with_custom_device(device_type):
    return False


Stream = torch.cuda.Stream


def synchronize(device=None):
    cuda.synchronize(device)


def current_stream(device=None):
    return cuda.current_stream(device)


def get_cudnn_version():
    """cuDNN's version when torch has it on this machine, else None."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_ipu():
    return False


def is_compiled_with_cinn():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_mlu():
    return False


def get_all_device_type():
    kinds = ["cpu"]
    if torch.cuda.is_available():
        kinds.append("gpu")
    return kinds


def get_available_device():
    return ["cpu"] + [f"gpu:{i}" for i in range(torch.cuda.device_count())]


def get_available_custom_device():
    return []
