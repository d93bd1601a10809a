"""Framework utilities of the port (counterpart of `paddle_tpu.framework`).

  ckpt_commit.py — the crash-safe checkpoint commit protocol (atomic
                   rename, sha256 manifest, `LATEST`, fallback to the
                   newest valid sibling)

The compile cache, flags and `io` come with the planes that need them
(ROADMAP A.12, A.13).
"""
from . import ckpt_commit  # noqa: F401
from .ckpt_commit import CheckpointCorruptError  # noqa: F401

__all__ = ["ckpt_commit", "CheckpointCorruptError"]
