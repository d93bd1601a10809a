"""The custom-op recipe's kernel: `o = x * a + b` as a hand-written CUDA
kernel, registered as a torch op and applied to the eager Tensor.

Counterpart of tier 2 of the reference's recipe (`docs/CUSTOM_OPS.md`,
`tests/test_custom_op_recipe.py:47-72`): a Pallas kernel
(`_scale_shift_kernel`) under a `jax.custom_vjp` whose backward is
`g * a`, wrapped for the eager Tensor by `apply_op`. Here:

  * `scale_shift.cu` holds the kernel (f32 and bf16, a grid-stride loop,
    16-byte loads where aligned), built by the port's own
    `cpp_extension.load` (nvcc, sm_90a) and bound with ctypes;
  * the op `paddle_tpu_torch::scale_shift` (`torch.library.custom_op`)
    launches it on CUDA tensors and runs the plain version `x * a + b`
    on CPU tensors; its fake version lets it trace under `to_static` and
    `torch.export`, and its registered backward is `g * a`;
  * `scale_shift(x, a, b)` applies it to the port's Tensor through
    `apply_op`, as the reference's does.

A CUDA tensor launches the kernel or raises: a dtype other than float32
or bfloat16, a failed build or a refused launch. `launches` counts the
kernel's launches. The kernel's multiply and add round separately, so
the kernel equals the plain version bit for bit in both dtypes.
"""
import ctypes
import os
import threading

import torch

__all__ = ["scale_shift", "scale_shift_plain", "scale_shift_raw", "build",
           "source", "default_build_dir", "launches"]

launches = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lock = threading.Lock()


def source():
    """The kernel's `.cu` in the checkout."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scale_shift.cu")


def default_build_dir():
    """`build/paddle_tpu_torch/recipe/` at the checkout's root
    (git-ignored)."""
    from ...._kernels.build import build_dir
    return os.path.join(build_dir(), "recipe")


def build(build_directory=None, verbose=False):
    """Build (or reuse) the kernel's library with `cpp_extension.load` and
    bind it; returns the ctypes library. Later launches use it."""
    global _lib
    from .. import load
    with _lock:
        if _lib is None or build_directory is not None:
            lib = load("scale_shift", [source()],
                       build_directory=build_directory or default_build_dir(),
                       verbose=verbose)
            vp = ctypes.c_void_p
            lib.scale_shift_launch.argtypes = [vp, vp, ctypes.c_longlong,
                                               ctypes.c_float,
                                               ctypes.c_float, ctypes.c_int,
                                               vp]
            lib.scale_shift_launch.restype = ctypes.c_int
            lib.scale_shift_error_string.argtypes = [ctypes.c_int]
            lib.scale_shift_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def scale_shift_plain(x, a, b):
    """The plain version: `x * a + b` in x's dtype (two roundings)."""
    return x * a + b


def _launch(x, a, b):
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"scale_shift: the kernel takes float32 and "
                        f"bfloat16, not {x.dtype}")
    x = x.contiguous()
    o = torch.empty_like(x)
    lib = build() if _lib is None else _lib
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.scale_shift_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(o.data_ptr()),
            x.numel(), float(a), float(b), _DTYPES[x.dtype],
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"scale_shift launch failed: "
                           f"{lib.scale_shift_error_string(rc).decode()} "
                           f"(cudaError {rc})")
    launches += 1
    return o


@torch.library.custom_op("paddle_tpu_torch::scale_shift", mutates_args=())
def _scale_shift_op(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return scale_shift_plain(x, a, b)
    if x.device.type != "cuda":
        raise ValueError(f"scale_shift: unsupported device {x.device}")
    return _launch(x, a, b)


@_scale_shift_op.register_fake
def _(x, a, b):
    return torch.empty_like(x)


def _setup_context(ctx, inputs, output):
    ctx.a = inputs[1]


def _backward(ctx, g):
    return g * ctx.a, None, None


_scale_shift_op.register_autograd(_backward, setup_context=_setup_context)


def scale_shift_raw(x, a=2.0, b=1.0):
    """The op on a torch tensor: the kernel on CUDA, the plain version on
    the CPU."""
    return torch.ops.paddle_tpu_torch.scale_shift(x, float(a), float(b))


def scale_shift(x, a=2.0, b=1.0):
    """`x * a + b` on the port's Tensor (the reference recipe's
    `scale_shift`); its gradient is `g * a`."""
    from ....core.tensor import apply_op
    return apply_op(lambda xd: scale_shift_raw(xd, a, b), x,
                    name="scale_shift")
