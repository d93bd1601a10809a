"""Build and load the port's hand-written CUDA kernels through the compile
cache.

Each `paddle_tpu_torch/csrc/<name>.cu` compiles on its own with nvcc into
a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o <entry tmp>/lib<name>.so \
         paddle_tpu_torch/csrc/<name>.cu

and is loaded with ctypes. Nothing is built at import time. The library
is an entry of a `framework.compile_cache.CompileCache`, chosen in this
order: the cache the caller passes (an engine's private one, e.g. a
serving artifact's `_compile_cache/`), the process-global one
(`compile_cache.attach`, `FLAGS_compile_cache_dir`), else a default cache
over `build/` in the checkout (git-ignored), whose entries are in
`build/paddle_tpu_torch/`. The key
digests the library's `.cu` and every csrc header, `NVCC_FLAGS`,
`torch.version.cuda` and the device's name and capability, so an edited
kernel is never served from a stale library; the entry records `nvcc
--version`, and where a compiler is reachable an entry built by another
one is rebuilt (where none is, a committed entry is the only way to the
kernels, and is used).

A miss runs nvcc straight into the entry's commit tempdir and commits it
(manifest last, atomic rename); a hit loads the committed file, after its
manifest verified. Processes that miss the same entry at once take its
lock in turn: the first builds it, the others then hit. A commit that
fails (the `checkpoint.write` fault, a full disk) persists nothing, and
may have torn the files it was committing; so the library and its log
are copied into a private directory of the process before the commit,
and where it fails that copy is what this process loads and reuses
until it exits (then it is deleted); the next process builds again.
`build_all()` starts one nvcc per missing source at once and waits for
all of them; `load_many(names)` does the same for `names` and opens
them. A failed build raises RuntimeError with the compiler's
output. The `-Xptxas=-v` register/spill report is kept in the entry as
`lib<name>.log` (`ptxas_report`).

A library is loaded once a process and reused by every later `load`,
whatever cache that call names. `outcome(name)` says how this process got
it: "miss" (built here) or "hit" (loaded from a committed entry), as the
first resolution found it; a reused library keeps that answer.
"""
import atexit
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load", "load_many", "build_all", "sources", "build_dir",
           "ptxas_report", "outcome", "resolve_cache", "NVCC_FLAGS"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_lock = threading.Lock()
_loaded = {}          # name -> ctypes library
_outcome = {}         # name -> "miss" | "hit", the first resolution's
_paths = {}           # name -> the library file this process resolved
_private = {}         # name -> private dir of a library whose commit failed
_default = {}         # build dir -> its default CompileCache
_toolkit_version = []


def build_dir():
    """`build/paddle_tpu_torch/` at the checkout's root (git-ignored): the
    default cache's entries (its `path`)."""
    return os.path.join(os.path.dirname(_PKG), "build",
                        "paddle_tpu_torch")


def sources():
    """{kernel name: path} for every `csrc/*.cu`."""
    return {f[:-3]: os.path.join(_CSRC, f)
            for f in sorted(os.listdir(_CSRC)) if f.endswith(".cu")}


def resolve_cache(cache=None):
    """The cache a build or load goes through: `cache`, else the attached
    global one, else the default one at `build_dir()`."""
    if cache is not None:
        return cache
    from ..framework import compile_cache
    if compile_cache.active() is not None:
        return compile_cache.active()
    d = os.path.dirname(build_dir())
    if d not in _default:
        _default[d] = compile_cache.CompileCache(d)
    return _default[d]


def _sources_digest(name):
    """Hash of `name`'s `.cu` and every header in csrc/."""
    h = hashlib.sha256()
    for f in sorted(os.listdir(_CSRC)):
        if f == f"{name}.cu" or f.endswith((".cuh", ".h")):
            h.update(f.encode())
            with open(os.path.join(_CSRC, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _device_kind():
    """(name, capability) of the current CUDA device, or None."""
    import torch
    if not torch.cuda.is_available():
        return None
    dev = torch.cuda.current_device()
    return (torch.cuda.get_device_name(dev),
            tuple(torch.cuda.get_device_capability(dev)))


def _key(cache, name):
    import torch
    parts = ("nvcc-library", name, _sources_digest(name), NVCC_FLAGS,
             str(torch.version.cuda), _device_kind())
    return cache.entry_key(f"lib{name}", parts)


def _find_nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    return exe if os.path.exists(exe) else None


def _nvcc():
    exe = _find_nvcc()
    if exe is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels can only be built where the toolkit is")
    return exe


def _toolkit():
    """`nvcc --version` of the reachable compiler (once a process), or
    None where there is none."""
    if not _toolkit_version:
        exe = _find_nvcc()
        ver = None
        if exe is not None:
            r = subprocess.run([exe, "--version"], capture_output=True,
                               text=True, timeout=60)
            ver = r.stdout.strip() if r.returncode == 0 else None
        _toolkit_version.append(ver)
    return _toolkit_version[0]


def _check_toolkit(meta):
    tk = _toolkit()
    if tk is not None and meta.get("nvcc_version") != tk:
        raise ValueError("built by another nvcc than the reachable one")


def _lib_file(entry, name):
    return os.path.join(entry, f"lib{name}.so")


def _start(cache, name):
    """Open the entry's commit and start nvcc into its tempdir."""
    nvcc = _nvcc()
    dirname, digest = _key(cache, name)
    pending = cache.begin(f"lib{name}", dirname, digest)
    cmd = [nvcc, *NVCC_FLAGS, "-o", _lib_file(pending.tmp, name),
           sources()[name]]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except BaseException:
        pending.abort()
        raise
    return pending, proc, cmd, time.perf_counter()


def _drop_private():
    for d in _private.values():
        shutil.rmtree(d, ignore_errors=True)
    _private.clear()


atexit.register(_drop_private)


def _finish(cache, name, pending, proc, cmd, t0):
    """Wait for nvcc and commit; returns the library file to load: the
    entry's, or where the commit persisted nothing the private copy taken
    before it (kept in `_private` until the process exits)."""
    log, _ = proc.communicate()
    compile_s = time.perf_counter() - t0
    if proc.returncode != 0:
        pending.abort()
        raise RuntimeError(f"nvcc failed for {name} (rc={proc.returncode}):"
                           f"\n{' '.join(cmd)}\n{log}")
    keep = os.path.join(cache.path,
                        f".{pending.dirname}.keep.{os.getpid()}")
    try:
        with open(os.path.join(pending.tmp, f"lib{name}.log"), "w") as fh:
            fh.write(log)
        os.makedirs(keep, exist_ok=True)
        for f in (f"lib{name}.so", f"lib{name}.log"):
            shutil.copyfile(os.path.join(pending.tmp, f),
                            os.path.join(keep, f))
    except BaseException:
        shutil.rmtree(keep, ignore_errors=True)
        pending.abort()
        raise
    committed = pending.commit(compile_s,
                               extra_meta={"nvcc_version": _toolkit()})
    if committed or os.path.isdir(pending.final):
        shutil.rmtree(keep, ignore_errors=True)
        return _lib_file(pending.final, name)
    _private[name] = keep
    return _lib_file(keep, name)


def _resolve(names, cache):
    """Library files of `names` through `cache`: hits as they are, misses
    built in parallel (one nvcc each) under their entry locks. Records
    each name's outcome and path. A library whose commit failed earlier
    in this process is its private copy again, not a second build."""
    out = {}
    with contextlib.ExitStack() as stack:
        running, errors = [], []
        for name in sorted(names):
            if name in _private:
                out[name] = (_lib_file(_private[name], name), "miss")
                continue
            dirname, digest = _key(cache, name)
            stack.enter_context(cache.entry_lock(dirname))
            entry = cache.lookup(f"lib{name}", dirname, digest,
                                 check=_check_toolkit)
            if entry is not None:
                out[name] = (_lib_file(entry, name), "hit")
                continue
            try:
                running.append((name, *_start(cache, name)))
            except (OSError, RuntimeError) as e:
                errors.append(str(e))
        for name, *job in running:
            try:
                out[name] = (_finish(cache, name, *job), "miss")
            except (OSError, RuntimeError) as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    for name, (path, how) in out.items():
        _outcome.setdefault(name, how)
        _paths.setdefault(name, path)
    return {name: path for name, (path, _) in out.items()}


def build_all(cache=None):
    """Resolve every kernel library through the cache (see the module
    docstring), building the missing ones at once. Returns {name: library
    path}; loads nothing."""
    with _lock:
        return _resolve(sources(), resolve_cache(cache))


def load(name, cache=None):
    """The ctypes library of kernel `name`: the one this process already
    loaded, else resolved through the cache and opened."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        lib = ctypes.CDLL(_resolve([name], resolve_cache(cache))[name])
        _loaded[name] = lib
        return lib


def load_many(names, cache=None):
    """{name: ctypes library} of kernels `names`: those this process has
    not loaded yet are resolved through the cache at once (the missing
    ones built in parallel, one nvcc each) and opened."""
    with _lock:
        todo = [n for n in names if n not in _loaded]
        if todo:
            paths = _resolve(todo, resolve_cache(cache))
            for n in todo:
                _loaded[n] = ctypes.CDLL(paths[n])
        return {n: _loaded[n] for n in names}


def outcome(name):
    """"miss" or "hit": how this process first got library `name` (None
    before it did)."""
    return _outcome.get(name)


def ptxas_report(name):
    """The compiler's register/shared-memory report for kernel `name`
    (empty string when this process has not resolved it)."""
    path = _paths.get(name)
    log = path[:-len(".so")] + ".log" if path else ""
    if not path or not os.path.exists(log):
        return ""
    with open(log) as fh:
        return fh.read()
