"""Core runtime of the port: devices, dtypes, the random state, grad
mode and the eager `Tensor` (counterpart of `paddle_tpu.core`)."""
from .device import (  # noqa: F401
    DEFAULT_DEVICE, CPUPlace, CUDAPlace, CUDAPinnedPlace, Place,
    default_device, device_count, get_device, is_compiled_with_cuda,
    is_compiled_with_npu, is_compiled_with_tpu, is_compiled_with_xpu,
    resolve_device, set_device,
)
from .dtype import (  # noqa: F401
    DType, bfloat16, bool_, complex64, complex128, convert_dtype, float16,
    float32, float64, get_default_dtype, int8, int16, int32, int64,
    set_default_dtype, uint8,
)
from .autograd import (  # noqa: F401
    enable_grad, is_grad_enabled, no_grad, set_grad_enabled,
)
from .random import (  # noqa: F401
    Generator, fork_rng, get_rng_state, seed, set_rng_state,
)
from .tensor import Parameter, Tensor, apply_op, to_tensor, unwrap, wrap  # noqa: F401

__all__ = ["DEFAULT_DEVICE", "resolve_device", "Place", "CPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "set_device", "get_device",
           "default_device", "device_count", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "is_compiled_with_xpu",
           "is_compiled_with_npu", "DType", "float16", "bfloat16",
           "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
           "bool_", "complex64", "complex128", "convert_dtype",
           "get_default_dtype", "set_default_dtype", "no_grad",
           "enable_grad", "is_grad_enabled", "set_grad_enabled", "seed",
           "get_rng_state", "set_rng_state", "fork_rng", "Generator",
           "Tensor", "Parameter", "apply_op", "to_tensor", "wrap", "unwrap"]
