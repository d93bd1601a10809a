"""paddle.utils of the port (counterpart of `paddle_tpu/utils/`):
`deprecated`, `run_check`, `require_version`, `try_import`, and the
submodules `unique_name`, `download` and `cpp_extension`."""
import functools
import importlib
import warnings

from . import unique_name  # noqa: F401
from . import download  # noqa: F401
from . import cpp_extension  # noqa: F401

__all__ = ["deprecated", "run_check", "require_version", "try_import"]


def deprecated(update_to="", since="", reason="", level=0):
    """Decorator marking an API deprecated. Levels 0 and 1 warn; level 2
    raises on call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = (f"API '{fn.__module__}.{fn.__name__}' is deprecated "
                   f"since {since or 'an earlier release'}"
                   + (f"; use {update_to} instead" if update_to else "")
                   + (f". Reason: {reason}" if reason else ""))
            if level >= 2:
                raise RuntimeError(msg)
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return wrapper
    return deco


def run_check(device="cuda"):
    """Device self-test: a tiny matmul forward and backward on `device`
    (the card by default; without CUDA it raises unless device="cpu")."""
    import numpy as np
    import torch
    from ..core.device import resolve_device
    from ..core.tensor import to_tensor
    dev = resolve_device(device)
    x = to_tensor(np.ones((2, 3), "float32"), place=dev, stop_gradient=False)
    w = to_tensor(np.ones((3, 2), "float32"), place=dev, stop_gradient=False)
    y = (x @ w).sum()
    y.backward()
    if float(y) != 12.0 or x.grad is None:
        raise RuntimeError(f"run_check failed on {dev}: sum {float(y)}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"paddle_tpu_torch is installed successfully! device={dev} "
          f"({name}), devices={torch.cuda.device_count()}")


def require_version(min_version, max_version=None):
    """Check the installed version lies in [min_version, max_version]."""
    from ..version import full_version

    def parts(v, width):
        ps = [int(x) for x in str(v).split(".") if x.isdigit()]
        return ps + [0] * (width - len(ps))       # zero-pad: 0.1 == 0.1.0

    width = max(len(str(v).split(".")) for v in
                (full_version, min_version, max_version or "0"))
    cur = parts(full_version, width)
    if parts(min_version, width) > cur:
        raise Exception(
            f"installed version {full_version} < required {min_version}")
    if max_version is not None and parts(max_version, width) < cur:
        raise Exception(
            f"installed version {full_version} > allowed {max_version}")
    return True


def try_import(module_name, err_msg=None):
    """Import a module, raising a friendly error when it is absent."""
    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or
                          f"module {module_name!r} is required but not "
                          f"installed (and this build cannot download)")
