"""ctypes bindings to the port's native runtime (counterpart of the
`ShmRing` and `TCPStore` halves of `paddle_tpu/native/__init__.py`).

Two sources, copies of the reference's, each built into a library of its
own:
  * `src/shm_ring.cc`: a cross-process blocking queue of byte records in
    one POSIX shared-memory segment, the transport of the `DataLoader`'s
    worker processes (`ShmRing`);
  * `src/kvstore.cc`: the TCP key-value store, the user-level rendezvous
    of `distributed.TCPStore`, the launcher and the elastic manager
    (`TCPStoreServer`, `TCPStoreClient`).

Each is built with g++ at first use, with the reference Makefile's flags,

    g++ -O2 -fPIC -std=c++17 -Wall -pthread -shared -o <lib> <src>.cc -lrt

into `build/paddle_tpu_torch/native/` at the checkout's root
(git-ignored). A library's file name carries a digest of its source and
the flags, so an edited source is never served a stale library; a build
writes a private temporary file and renames it into place, so processes
that build at once never load a torn one. Where g++ is missing or fails,
`available(name)` is False: the `DataLoader` then takes its thread
engine, and a `TCPStore` raises naming the build error.

The reference's other native sources (the host arena, the stat registry,
the parameter-server table) come with the slice that uses them (ROADMAP
A.13g).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["available", "build_error", "ShmRing", "TCPStoreServer",
           "TCPStoreClient", "library_path", "build_dir", "CXX_FLAGS",
           "SOURCES"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("shm_ring", "kvstore")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")
_libs = {}
_build_errors = {}
_build_lock = threading.Lock()


def _src(name):
    if name not in SOURCES:
        raise ValueError(f"unknown native source {name!r}; one of {SOURCES}")
    return os.path.join(_DIR, "src", f"{name}.cc")


def build_dir():
    """`build/paddle_tpu_torch/native/` at the checkout's root."""
    root = os.path.dirname(os.path.dirname(_DIR))
    return os.path.join(root, "build", "paddle_tpu_torch", "native")


def library_path(name="shm_ring"):
    """The library of source `name` for the current source and flags."""
    h = hashlib.sha256()
    with open(_src(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(), f"libptt_{name}-{h.hexdigest()[:16]}.so")


def _build(name, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _src(name), "-lrt"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(name="shm_ring"):
    if name in _libs or name in _build_errors:
        return _libs.get(name)
    with _build_lock:
        if name in _libs or name in _build_errors:
            return _libs.get(name)
        try:
            path = library_path(name)
            if not os.path.exists(path):
                _build(name, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError) as e:
            _build_errors[name] = e
            return None
        _declare(lib, _SIGS[name])
        _libs[name] = lib
    return lib


def _sigs():
    P, U64, I64, I32 = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                        ctypes.c_int)
    S = ctypes.c_char_p
    return {
        "shm_ring": {
            "ptn_ring_create": (P, [S, U64]),
            "ptn_ring_attach": (P, [S]),
            "ptn_ring_put": (I32, [P, ctypes.c_char_p, U64, I32]),
            "ptn_ring_get": (I32, [P, ctypes.POINTER(P), ctypes.POINTER(U64),
                                   I32]),
            "ptn_ring_close": (None, [P]),
            "ptn_ring_release": (None, [P]),
            "ptn_buf_free": (None, [P]),
        },
        "kvstore": {
            "ptn_store_server_start": (P, [I32]),
            "ptn_store_server_port": (I32, [P]),
            "ptn_store_server_stop": (None, [P]),
            "ptn_store_client_connect": (P, [S, I32, I32]),
            "ptn_store_client_close": (None, [P]),
            "ptn_store_set": (I32, [P, S, ctypes.c_char_p, U64]),
            "ptn_store_get": (I32, [P, S, ctypes.POINTER(P),
                                    ctypes.POINTER(U64)]),
            "ptn_store_wait": (I32, [P, S, I64, ctypes.POINTER(P),
                                     ctypes.POINTER(U64)]),
            "ptn_store_add": (I32, [P, S, I64, ctypes.POINTER(I64)]),
            "ptn_store_delete": (I32, [P, S]),
        },
    }


_SIGS = _sigs()


def _declare(lib, sigs):
    for fname, (res, args) in sigs.items():
        fn = getattr(lib, fname)
        fn.restype = res
        fn.argtypes = args


def available(name="shm_ring"):
    """True when source `name`'s library builds (or is built) and loads."""
    return _load(name) is not None


def build_error(name="shm_ring"):
    """Why `available(name)` is False (None while it is True or untried)."""
    return _build_errors.get(name)


def _need(name):
    lib = _load(name)
    if lib is None:
        raise RuntimeError(f"native {name} library unavailable: "
                           f"{_build_errors.get(name)}")
    return lib


# `kvstore.cc` hands back malloc'd buffers and has no free of its own
_libc_free = ctypes.CDLL(None).free
_libc_free.argtypes = [ctypes.c_void_p]
_libc_free.restype = None


def _take_buf(pp, ln, free):
    data = ctypes.string_at(pp.value, ln.value)
    free(pp.value)
    return data


class ShmRing:
    """Cross-process blocking byte-record queue in shared memory."""

    def __init__(self, name, capacity=64 << 20, create=True):
        self._lib = lib = _need("shm_ring")
        self.name = name
        self._create = create
        nm = name.encode()
        self._h = (lib.ptn_ring_create(nm, capacity) if create
                   else lib.ptn_ring_attach(nm))
        if not self._h:
            raise RuntimeError(f"ShmRing {'create' if create else 'attach'} "
                               f"failed: {name}")

    def put(self, data: bytes, timeout_ms=-1):
        rc = self._lib.ptn_ring_put(self._h, data, len(data), timeout_ms)
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
        rc = self._lib.ptn_ring_get(self._h, ctypes.byref(pp),
                                    ctypes.byref(ln), timeout_ms)
        if rc == -2:
            return None
        if rc == -1:
            raise TimeoutError("ring get timeout")
        if rc != 0:
            raise RuntimeError(f"ring get failed ({rc})")
        return _take_buf(pp, ln, self._lib.ptn_buf_free)

    def close(self):
        if self._h:
            self._lib.ptn_ring_close(self._h)

    def release(self):
        if self._h:
            self._lib.ptn_ring_release(self._h)
            self._h = None


class TCPStoreServer:
    """The store's server: a thread in this process listening on `port`
    (0 picks a free one; `.port` says which)."""

    def __init__(self, port=0):
        self._lib = lib = _need("kvstore")
        self._h = lib.ptn_store_server_start(port)
        if not self._h:
            raise RuntimeError(f"TCPStore server failed to bind port {port}")
        self.port = lib.ptn_store_server_port(self._h)

    def stop(self):
        if self._h:
            self._lib.ptn_store_server_stop(self._h)
            self._h = None


class TCPStoreClient:
    """One connection to a store's server."""

    def __init__(self, host="127.0.0.1", port=0, timeout_ms=30000):
        self._lib = lib = _need("kvstore")
        self._h = lib.ptn_store_client_connect(host.encode(), port,
                                               timeout_ms)
        if not self._h:
            raise RuntimeError(f"TCPStore connect failed: {host}:{port}")

    def set(self, key, value: bytes):
        if self._lib.ptn_store_set(self._h, key.encode(), value,
                                   len(value)) != 0:
            raise RuntimeError(f"store set failed: {key}")

    def get(self, key):
        """Non-blocking; returns None if absent."""
        pp = ctypes.c_void_p()
        ln = ctypes.c_uint64()
        if self._lib.ptn_store_get(self._h, key.encode(), ctypes.byref(pp),
                                   ctypes.byref(ln)) != 0:
            return None
        return _take_buf(pp, ln, _libc_free)

    def wait(self, key, timeout_ms=-1):
        """Blocks until the key exists (or timeout_ms elapses), returns its
        value."""
        pp = ctypes.c_void_p()
        ln = ctypes.c_uint64()
        rc = self._lib.ptn_store_wait(self._h, key.encode(), timeout_ms,
                                      ctypes.byref(pp), ctypes.byref(ln))
        if rc == -2:
            raise TimeoutError(f"store wait timed out: {key}")
        if rc != 0:
            raise RuntimeError(f"store wait failed: {key}")
        return _take_buf(pp, ln, _libc_free)

    def add(self, key, delta=1):
        out = ctypes.c_int64()
        if self._lib.ptn_store_add(self._h, key.encode(), delta,
                                   ctypes.byref(out)) != 0:
            raise RuntimeError(f"store add failed: {key}")
        return out.value

    def delete(self, key):
        self._lib.ptn_store_delete(self._h, key.encode())

    def close(self):
        if self._h:
            self._lib.ptn_store_client_close(self._h)
            self._h = None
