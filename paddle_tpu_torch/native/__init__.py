"""ctypes binding to the port's shared-memory ring (counterpart of the
`ShmRing` half of `paddle_tpu/native/__init__.py`).

`src/shm_ring.cc` is a copy of the reference's ring: a cross-process
blocking queue of byte records in one POSIX shared-memory segment, the
transport of the `DataLoader`'s worker processes. It is built with g++ at
first use, with the reference Makefile's flags,

    g++ -O2 -fPIC -std=c++17 -Wall -pthread -shared -o <lib> shm_ring.cc -lrt

into `build/paddle_tpu_torch/native/` at the checkout's root
(git-ignored). The library's file name carries a digest of the source and
the flags, so an edited source is never served a stale library; a build
writes a private temporary file and renames it into place, so processes
that build at once never load a torn one. Where g++ is missing or fails,
`available()` is False and the `DataLoader` takes its thread engine.

The reference's other native sources (the TCP store, the host arena, the
stat registry, the parameter-server table) are not copied here: they come
with the slices that use them (ROADMAP A.13f, A.13g).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["available", "build_error", "ShmRing", "library_path",
           "build_dir", "CXX_FLAGS"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "shm_ring.cc")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
_lib = None
_build_lock = threading.Lock()
_build_error = None


def build_dir():
    """`build/paddle_tpu_torch/native/` at the checkout's root."""
    root = os.path.dirname(os.path.dirname(_DIR))
    return os.path.join(root, "build", "paddle_tpu_torch", "native")


def library_path():
    """The library for the current source and flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(), f"libptt_shm_ring-{h.hexdigest()[:16]}.so")


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC, "-lrt"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            _build_error = e
            return None
        _declare(lib)
        _lib = lib
    return _lib


def _declare(lib):
    P, U64, I32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int
    S = ctypes.c_char_p
    sigs = {
        "ptn_ring_create": (P, [S, U64]),
        "ptn_ring_attach": (P, [S]),
        "ptn_ring_put": (I32, [P, ctypes.c_char_p, U64, I32]),
        "ptn_ring_get": (I32, [P, ctypes.POINTER(P), ctypes.POINTER(U64),
                               I32]),
        "ptn_ring_close": (None, [P]),
        "ptn_ring_release": (None, [P]),
        "ptn_buf_free": (None, [P]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def available():
    """True when the ring's library builds (or is built) and loads."""
    return _load() is not None


def build_error():
    """Why `available()` is False (None while it is True or untried)."""
    return _build_error


def _take_buf(pp, ln):
    data = ctypes.string_at(pp.value, ln.value)
    _lib.ptn_buf_free(pp.value)
    return data


class ShmRing:
    """Cross-process blocking byte-record queue in shared memory."""

    def __init__(self, name, capacity=64 << 20, create=True):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native runtime unavailable: {_build_error}")
        self.name = name
        self._create = create
        nm = name.encode()
        self._h = (lib.ptn_ring_create(nm, capacity) if create
                   else lib.ptn_ring_attach(nm))
        if not self._h:
            raise RuntimeError(f"ShmRing {'create' if create else 'attach'} "
                               f"failed: {name}")

    def put(self, data: bytes, timeout_ms=-1):
        rc = _lib.ptn_ring_put(self._h, data, len(data), timeout_ms)
        if rc == -2:
            raise EOFError("ring closed")
        if rc == -1:
            raise TimeoutError("ring put timeout")
        if rc == -3:
            raise ValueError(f"record of {len(data)} bytes larger than ring "
                             f"capacity")
        if rc != 0:
            raise RuntimeError(f"ring put failed ({rc})")

    def get(self, timeout_ms=-1):
        """Returns bytes, or None when the ring is closed and drained."""
        pp = ctypes.c_void_p()
        ln = ctypes.c_uint64()
        rc = _lib.ptn_ring_get(self._h, ctypes.byref(pp), ctypes.byref(ln),
                               timeout_ms)
        if rc == -2:
            return None
        if rc == -1:
            raise TimeoutError("ring get timeout")
        if rc != 0:
            raise RuntimeError(f"ring get failed ({rc})")
        return _take_buf(pp, ln)

    def close(self):
        if self._h:
            _lib.ptn_ring_close(self._h)

    def release(self):
        if self._h:
            _lib.ptn_ring_release(self._h)
            self._h = None
