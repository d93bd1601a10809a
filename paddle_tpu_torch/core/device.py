"""Devices and places of the PyTorch port.

The JAX package collapses placement to {cpu, tpu} and falls back to the
CPU when no accelerator is present (`paddle_tpu/core/device.py`
`_auto_place`). The port runs on an NVIDIA GPU and never falls back
silently:
  * every engine entry point takes `device=` (default "cuda"), and
    `resolve_device` raises for CUDA on a machine without it;
  * the eager surface has a current place, `gpu:0` unless `set_device`
    says otherwise. Making a tensor on it without CUDA raises; only
    `set_device("cpu")` or an explicit `place="cpu"` runs on the host.
"""
import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE", "Place", "CPUPlace",
           "CUDAPlace", "CUDAPinnedPlace", "set_device", "get_device",
           "default_device", "current_device", "place_device",
           "device_count", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "is_compiled_with_npu"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE):
    """`device` (str | torch.device | None) -> torch.device.

    None means the default, "cuda". A CUDA device without a usable CUDA
    runtime raises RuntimeError; there is no CPU fallback."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch paths on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; "
                         "want 'cuda[:i]' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Place:
    """paddle's Place: a device kind ("gpu" or "cpu") and an index."""

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and (self.kind, self.index) == (other.kind, other.index))

    def __hash__(self):
        return hash((self.kind, self.index))

    def torch_device(self):
        """The torch.device; raises for a GPU place without CUDA."""
        if self.kind == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.index))

    @staticmethod
    def of(device):
        """The Place of a torch.device."""
        if device.type == "cpu":
            return Place("cpu", 0)
        return Place("gpu", device.index or 0)


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", index)


def CUDAPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def CUDAPinnedPlace() -> Place:
    """Pinned host memory is host memory for placement purposes."""
    return Place("cpu", 0)


_current_place = Place("gpu", 0)
_current_device = None           # torch.device of _current_place, resolved


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return Place.of(device)
    name, _, idx = str(device).partition(":")
    name = name.lower()
    if name == "cpu":
        return Place("cpu", 0)
    if name in ("gpu", "cuda"):
        return Place("gpu", int(idx) if idx else 0)
    raise ValueError(f"Unsupported device {device!r}; expected 'gpu[:i]', "
                     "'cuda[:i]' or 'cpu'")


def set_device(device):
    """paddle.set_device('gpu') / ('gpu:1') / ('cpu'). A GPU place
    without CUDA raises here."""
    global _current_place, _current_device
    place = _parse(device)
    dev = place.torch_device()
    _current_place, _current_device = place, dev
    return place


def get_device() -> str:
    p = _current_place
    return f"{p.kind}:{p.index}"


def default_device() -> Place:
    return _current_place


def current_device():
    """torch.device of the current place: where creation ops and
    `to_tensor` put a tensor. Raises for the default GPU place on a
    machine without CUDA."""
    global _current_device
    if _current_device is None:
        _current_device = _current_place.torch_device()
    return _current_device


def place_device(place=None):
    """torch.device of `place` (a Place, torch.device or string), or of
    the current place when None."""
    if place is None:
        return current_device()
    return _parse(place).torch_device()


def device_count(kind: str = None) -> int:
    kind = kind or _current_place.kind
    if kind == "cpu":
        return 1
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.version.cuda is not None


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False
