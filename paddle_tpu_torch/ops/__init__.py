"""Operators with hand-written CUDA kernels (plain PyTorch on the CPU),
and the chunked fused cross-entropy (plain PyTorch everywhere)."""
from . import flash_attention, fused_ce, paged_attention  # noqa: F401

__all__ = ["flash_attention", "fused_ce", "paged_attention"]
