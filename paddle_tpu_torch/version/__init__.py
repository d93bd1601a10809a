"""Version record of the port (counterpart of `paddle_tpu/version`)."""
full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
commit = "unknown"
with_gpu = "ON"
with_tpu = "OFF"


def cuda():
    """The CUDA version torch was built with, or "False" without one."""
    import torch
    return torch.version.cuda or "False"


def show():
    print(f"paddle_tpu_torch {full_version} (PyTorch and CUDA for NVIDIA "
          f"Hopper; cuda {cuda()})")
