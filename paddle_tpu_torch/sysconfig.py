"""paddle.sysconfig of the port (counterpart of `paddle_tpu/sysconfig.py`).
"""
import os

__all__ = ["get_include", "get_lib"]

_PKG = os.path.dirname(os.path.abspath(__file__))


def get_include():
    """The directory of the port's CUDA sources and headers (`csrc/`)."""
    return os.path.join(_PKG, "csrc")


def get_lib():
    """The directory the port's kernel libraries are built into
    (`build/paddle_tpu_torch/` at the checkout's root)."""
    from ._kernels.build import build_dir
    return build_dir()
