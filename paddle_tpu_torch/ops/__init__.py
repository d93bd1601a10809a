"""Operators with hand-written CUDA kernels (plain PyTorch on the CPU)."""
from . import paged_attention  # noqa: F401

__all__ = ["paged_attention"]
