"""Device resolution for the PyTorch port.

The JAX package collapses placement to {cpu, tpu} and falls back to the
CPU when no accelerator is present. The port runs on an NVIDIA GPU and
never falls back silently: every entry point takes `device=` (default
"cuda"), and asking for CUDA on a machine without it raises. Only an
explicit `device="cpu"` runs the plain PyTorch paths on the host.
"""
import torch

__all__ = ["resolve_device", "DEFAULT_DEVICE"]

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
