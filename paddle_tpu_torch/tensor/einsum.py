"""einsum (counterpart of `paddle_tpu/tensor/einsum.py`)."""
import torch

from ..core.tensor import apply_op

__all__ = ["einsum"]


def einsum(equation, *operands):
    return apply_op(lambda *xs: torch.einsum(equation, *xs), *operands,
                    name="einsum")
