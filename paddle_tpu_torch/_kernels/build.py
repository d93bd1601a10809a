"""Build and load the port's hand-written CUDA kernels.

Each `paddle_tpu_torch/csrc/<name>.cu` compiles on its own with nvcc into
a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o build/paddle_tpu_torch/lib<name>-<hash>.so \
         paddle_tpu_torch/csrc/<name>.cu

and is loaded with ctypes. Nothing is built at import time: the first
`load(name)` builds (or finds the cached library), keyed by a hash of the
sources in `csrc/` and the flags, so an edited kernel can never be served
from a stale library. `build_all()` starts one nvcc per source at once and
waits for all of them, which is what a cold start should call.

A failed build raises RuntimeError with the compiler's output. The
compiler's register/spill report (`-Xptxas=-v`) is kept beside each
library as `<lib>.log`.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load", "build_all", "sources", "build_dir", "ptxas_report",
           "NVCC_FLAGS"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_lock = threading.Lock()
_loaded = {}


def build_dir():
    """`build/paddle_tpu_torch/` at the checkout's root (git-ignored)."""
    return os.path.join(os.path.dirname(_PKG), "build", "paddle_tpu_torch")


def sources():
    """{kernel name: path} for every `csrc/*.cu`."""
    return {f[:-3]: os.path.join(_CSRC, f)
            for f in sorted(os.listdir(_CSRC)) if f.endswith(".cu")}


def _digest():
    """Hash of every source in csrc/ (headers included) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(_CSRC)):
        if f.endswith((".cu", ".cuh", ".h")):
            h.update(f.encode())
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def _lib_path(name):
    return os.path.join(build_dir(), f"lib{name}-{_digest()}.so")


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels can only be built where the toolkit is")


def _start(name):
    """Start nvcc for one source into a temporary file; returns the
    running process and its (tmp, final) paths."""
    out = _lib_path(name)
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, sources()[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(name, proc, tmp, out, cmd):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{log}")
    with open(out + ".log", "w") as fh:
        fh.write(log)
    os.replace(tmp, out)          # atomic: a reader never sees half a file


def build_all():
    """Build every kernel library that is not cached yet, one nvcc per
    source, all started together. Returns {name: library path}."""
    with _lock:
        todo = [n for n in sources() if not os.path.exists(_lib_path(n))]
        running = [(n, *_start(n)) for n in todo]
        errors = []
        for n, proc, tmp, out, cmd in running:
            try:
                _finish(n, proc, tmp, out, cmd)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in sources()}


def load(name):
    """The ctypes library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not os.path.exists(path):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
        return lib


def ptxas_report(name):
    """The compiler's register/shared-memory report for kernel `name`
    (empty string when it has not been built here)."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()
