"""paddle.utils.cpp_extension of the port (counterpart of
`paddle_tpu/utils/cpp_extension/`): setuptools helpers and the JIT `load`
of custom C++ and CUDA sources.

`load(name, sources, ...)` keeps the reference's signature and contract:
it compiles the sources into one shared library `<name>_<key>.so` in
`build_directory`, where the key digests the sources' paths and bytes,
the compiler and the flags, and returns it as a `ctypes.CDLL`. The
reference builds host C++ only and writes device code in Pallas; on the
card of this port device code is CUDA, so `load` also takes `.cu`
sources (ROADMAP C.24):

  * only `.cc` / `.cpp` / `.c` sources: g++, as the reference,
        g++ -O2 -fPIC -shared -std=c++17 <extra_cxx_cflags> -I.. <srcs>
  * any `.cu` source: nvcc with the flags of the port's own kernels
    (`_kernels/build.py`, `-gencode arch=compute_90a,code=sm_90a`),
        nvcc <NVCC_FLAGS> <extra_cuda_cflags> -I.. <srcs>
    and `extra_cxx_cflags` passed to the host compiler (`-Xcompiler`).

The compiler writes a private temporary file that is renamed into place,
so processes that build at once never load a torn library. A failed build
raises RuntimeError with the command and the compiler's output; nothing
falls back. `CUDAExtension` builds through `torch.utils.cpp_extension`'s
nvcc step (a build tool, not a kernel library). The custom-op recipe's
kernel, `recipe/scale_shift.cu`, is built by `load` (`recipe/`).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["CppExtension", "CUDAExtension", "load", "setup",
           "get_build_directory"]

CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_CUDA_SUFFIXES = (".cu",)
_loaded = {}              # library path -> ctypes.CDLL


def get_build_directory(verbose=False):
    """`~/.cache/paddle_tpu_torch/extensions`, the reference's layout under
    the user's cache (made if missing)."""
    d = os.path.expanduser("~/.cache/paddle_tpu_torch/extensions")
    os.makedirs(d, exist_ok=True)
    return d


def _cuda_gencode():
    from ..._kernels.build import NVCC_FLAGS
    return [NVCC_FLAGS[0], NVCC_FLAGS[1]]


def CppExtension(sources, *args, **kwargs):
    """A setuptools.Extension of C++ sources."""
    from setuptools import Extension
    name = kwargs.pop("name", "paddle_tpu_torch_ext")
    kwargs.setdefault("language", "c++")
    return Extension(name, sources, *args, **kwargs)


def CUDAExtension(sources, *args, **kwargs):
    """A setuptools.Extension of C++ and CUDA sources, compiled through
    torch's nvcc step for sm_90a (build it with `setup`)."""
    from torch.utils.cpp_extension import CUDAExtension as _Ext
    name = kwargs.pop("name", "paddle_tpu_torch_ext")
    flags = kwargs.pop("extra_compile_args", {}) or {}
    if isinstance(flags, (list, tuple)):
        flags = {"cxx": list(flags), "nvcc": list(flags)}
    flags = dict(flags)
    flags["nvcc"] = _cuda_gencode() + list(flags.get("nvcc", []))
    flags.setdefault("cxx", [])
    return _Ext(name, sources, *args, extra_compile_args=flags, **kwargs)


def setup(**attrs):
    """setuptools.setup set up for building the extensions in place, with
    torch's `BuildExtension` where a CUDA extension needs nvcc."""
    from setuptools import setup as _setup
    attrs.setdefault("script_args", ["build_ext", "--inplace"])
    exts = attrs.get("ext_modules") or []
    if any(getattr(e, "sources", None) and
           any(s.endswith(_CUDA_SUFFIXES) for s in e.sources) for e in exts):
        from torch.utils.cpp_extension import BuildExtension
        attrs.setdefault("cmdclass", {"build_ext": BuildExtension})
    return _setup(**attrs)


def _command(srcs, out, extra_cxx_cflags, extra_cuda_cflags, extra_ldflags,
             extra_include_paths):
    incs = sum([["-I", p] for p in (extra_include_paths or [])], [])
    if any(s.endswith(_CUDA_SUFFIXES) for s in srcs):
        from ..._kernels.build import NVCC_FLAGS, _nvcc
        host = sum([["-Xcompiler", f] for f in (extra_cxx_cflags or [])], [])
        return ([_nvcc(), *NVCC_FLAGS] + list(extra_cuda_cflags or [])
                + host + incs + srcs + ["-o", out]
                + list(extra_ldflags or []))
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("cpp_extension.load: g++ not found on PATH")
    return ([cxx, *CXX_FLAGS] + list(extra_cxx_cflags or []) + incs + srcs
            + ["-o", out] + list(extra_ldflags or []))


def _key(srcs, cmd_flags):
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.encode() + b"\0")
        with open(s, "rb") as f:
            h.update(f.read())
    h.update("\0".join(cmd_flags).encode())
    return h.hexdigest()[:16]


def load(name, sources, extra_cxx_cflags=None, extra_cuda_cflags=None,
         extra_ldflags=None, extra_include_paths=None, build_directory=None,
         interpreter=None, verbose=False):
    """Compile `sources` into `<build_directory>/<name>_<key>.so` (once: a
    library with the same key is reused) and return it as a ctypes.CDLL."""
    build_dir = build_directory or get_build_directory()
    os.makedirs(build_dir, exist_ok=True)
    srcs = [os.path.abspath(s) for s in sources]
    for s in srcs:
        if not os.path.isfile(s):
            raise FileNotFoundError(f"cpp_extension.load: no source {s}")
    probe = _command(srcs, "OUT", extra_cxx_cflags, extra_cuda_cflags,
                     extra_ldflags, extra_include_paths)
    flags = [os.path.basename(probe[0])] + probe[1:]
    out = os.path.join(build_dir, f"{name}_{_key(srcs, flags)}.so")
    if not os.path.exists(out):
        fd, tmp = tempfile.mkstemp(prefix=f".{name}_", suffix=".so",
                                   dir=build_dir)
        os.close(fd)
        cmd = _command(srcs, tmp, extra_cxx_cflags, extra_cuda_cflags,
                       extra_ldflags, extra_include_paths)
        if verbose:
            print(" ".join(cmd))
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"cpp_extension.load: building {name} failed "
                    f"(rc={r.returncode}):\n{' '.join(cmd)}\n{r.stdout}"
                    f"{r.stderr}")
            if verbose:
                print(r.stdout + r.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = _loaded.get(out)
    if lib is None:
        lib = _loaded[out] = ctypes.CDLL(out)
    return lib
from . import recipe  # noqa: E402,F401
