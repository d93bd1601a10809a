"""Framework utilities of the port (counterpart of `paddle_tpu.framework`).

  ckpt_commit.py   — the crash-safe checkpoint commit protocol (atomic
                     rename, sha256 manifest, `LATEST`, fallback to the
                     newest valid sibling)
  io.py            — `save` / `load`, the JAX package's pickle format,
                     readable and writable both ways
  flags.py         — the `FLAGS_*` registry, loaded from the environment
  compile_cache.py — the persistent compile cache of the nvcc kernel
                     libraries (`_kernels/build.py`)
"""
from . import ckpt_commit, compile_cache, flags, io  # noqa: F401
from .ckpt_commit import CheckpointCorruptError  # noqa: F401
from .flags import get_flags, set_flags  # noqa: F401
from .io import load, save  # noqa: F401

__all__ = ["ckpt_commit", "compile_cache", "flags", "io",
           "CheckpointCorruptError", "get_flags", "set_flags", "load",
           "save"]
