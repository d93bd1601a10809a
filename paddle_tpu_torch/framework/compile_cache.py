"""The persistent compile cache: the port's kernel libraries, built once
and loaded by every later process.

Counterpart of `paddle_tpu/framework/compile_cache.py`. There an entry
is a serialized XLA executable; here it is one nvcc kernel library
(`lib<name>.so` and its `-Xptxas=-v` log), which `_kernels/build.py`
builds on a miss and loads on a hit. That is the one kind of compiled
artifact the port has.

Keys are content-addressed, as the reference's "lowering" mode: the
caller passes the parts that decide what the compiler produces
(`_kernels/build.py`: the csrc sources and headers, `NVCC_FLAGS`,
`torch.version.cuda`, the device's name and capability), and
`entry_key` digests them with `FORMAT_VERSION`. So an edited `.cu` or
`.cuh`, other flags, another CUDA or another device kind reads as a
miss, while an edited `.py` rebuilds nothing. What the caller can check
only against a committed entry (the compiler's `--version`, which is
unknown where no compiler is installed) goes into the entry's metadata
and is checked by the caller's `check` at lookup.

`framework_fingerprint()` digests the port's `.py` and `csrc/` sources
with the torch and CUDA versions; it is recorded in each entry's
metadata, and is not part of the key.

Commit protocol: each entry is a directory committed through
`framework/ckpt_commit.atomic_commit`: the files are written into a
hidden tempdir (the compiler writes its output straight there), then
the sha256 `MANIFEST.json` last, fsync, and an atomic rename. The
`checkpoint.write` fault site fires inside every commit. A SIGKILL
mid-commit leaves a hidden tempdir that no reader sees and the next
commit sweeps. A torn or bit-rotted entry fails its manifest check in
`lookup` before anything opens its files (a corrupt shared library
loaded into the process would crash it, not miss): it is deleted and
reads as a miss, and so does an entry whose metadata names another
`FORMAT_VERSION` or fails the caller's `check`. A commit whose entry
another process committed first is discarded (`stats["discarded"]`),
never raised; `entry_lock` lets processes that miss the same entry
build it one at a time.

Layout: `CompileCache(path)` keeps its entries in `path/paddle_tpu_torch/`
(`SUBDIR`, its `.path`), never at the top of `path`. The JAX package
reads the same `FLAGS_compile_cache_dir` and writes a serving artifact's
`_compile_cache/` under the same name, and its cache counts, evicts and
clears every manifested directory at its top level; a subdirectory
without a manifest is none of its entries, and the port counts only its
own, so neither package's retention cap evicts the other's entries.

Invalidation: `invalidate()` (and `invalidate_active()`) bypasses every
entry committed before now for the rest of this process. Retention:
`FLAGS_compile_cache_max_entries` or `CompileCache(max_entries=)` caps
the committed entries of a directory, least recently used first (the
directory's mtime, refreshed by every hit), at commit time; the entry
just committed is never evicted; 0 = unlimited.

Metrics: `compile_cache_hits_total`, `compile_cache_misses_total`, and
`compile_cache_compile_seconds{executable}` /
`compile_cache_load_seconds{executable}` (the library's name).

Not ported: `CachedFunction`, `cached_jit` and `aval_signature`, which
persist a traced XLA program. The port's serving executables are CUDA
graphs, and a captured graph cannot outlive its process: each process
captures its own (`serving/graphs.py`) over libraries this cache gives
it (ROADMAP C.9).
"""
import contextlib
import fcntl
import hashlib
import json
import os
import shutil
import time
import warnings

from . import ckpt_commit
from ..observability import metrics as _metrics

__all__ = ["FORMAT_VERSION", "ENTRY_SCHEMA", "ENTRY_META", "SUBDIR",
           "CompileCache",
           "attach", "detach", "active", "invalidate_active",
           "framework_fingerprint"]

FORMAT_VERSION = 1
ENTRY_SCHEMA = "paddle_tpu_torch.compile_cache.v1"
ENTRY_META = "entry.json"
SUBDIR = "paddle_tpu_torch"

_M_HITS = _metrics.counter(
    "compile_cache_hits_total",
    "Persistent compile-cache lookups served from disk")
_M_MISSES = _metrics.counter(
    "compile_cache_misses_total",
    "Persistent compile-cache lookups that had to compile")
_M_COMPILE_S = _metrics.histogram(
    "compile_cache_compile_seconds",
    "Per-library nvcc wall time on a cache miss",
    labelnames=("executable",))
_M_LOAD_S = _metrics.histogram(
    "compile_cache_load_seconds",
    "Per-library load wall time on a hit",
    labelnames=("executable",))

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FINGERPRINT = None


def framework_fingerprint():
    """Digest over every `.py` file of `paddle_tpu_torch` and every source
    of its `csrc/`, plus the torch and CUDA versions. Computed once a
    process."""
    global _FINGERPRINT
    if _FINGERPRINT is not None:
        return _FINGERPRINT
    import torch
    h = hashlib.sha256()
    files = []
    for dirpath, _, names in os.walk(_PKG):
        for name in names:
            if name.endswith((".py", ".cu", ".cuh", ".h")):
                full = os.path.join(dirpath, name)
                files.append((os.path.relpath(full, _PKG), full))
    for rel, full in sorted(files):
        h.update(rel.encode())
        try:
            with open(full, "rb") as f:
                h.update(hashlib.sha256(f.read()).digest())
        except OSError:
            h.update(b"<unreadable>")
    h.update(torch.__version__.encode())
    h.update(str(torch.version.cuda).encode())
    _FINGERPRINT = h.hexdigest()
    return _FINGERPRINT


def _digest(parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x1f")
    return h.hexdigest()


def _safe_name(name):
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in name)[:80]


class _Discarded(Exception):
    """Another process committed the entry first."""


class PendingEntry:
    """An entry being built: the caller writes its files into `tmp` (a
    hidden tempdir of `ckpt_commit.atomic_commit`), then `commit()`s or
    `abort()`s it."""

    def __init__(self, cache, name, dirname, digest):
        self._cache = cache
        self.name, self.dirname, self.digest = name, dirname, digest
        self.final = cache._entry_dir(dirname)
        self._cm = ckpt_commit.atomic_commit(self.final)
        self.tmp = self._cm.__enter__()

    def abort(self):
        """Drop the tempdir; nothing is committed."""
        if self._cm is not None:
            self._cm.__exit__(RuntimeError, RuntimeError("aborted"), None)
            self._cm = None

    def commit(self, compile_seconds=None, extra_meta=None):
        """Write the metadata and commit. True when the entry is now this
        one; False when another process committed it first (discarded)
        or the commit failed (a warning; nothing half-written is
        visible). An entry this process bypasses (`invalidate`) is
        replaced, not kept."""
        cache, cm, self._cm = self._cache, self._cm, None
        meta = {"schema": ENTRY_SCHEMA, "name": self.name,
                "digest": self.digest, "format_version": FORMAT_VERSION,
                "fingerprint": framework_fingerprint(),
                "compile_seconds": compile_seconds, **(extra_meta or {})}
        try:
            with open(os.path.join(self.tmp, ENTRY_META), "w") as f:
                json.dump(meta, f, indent=1)
            held = ckpt_commit.read_manifest(self.final)
            if held is not None and \
                    float(held.get("ts", 0.0)) >= cache._min_ts:
                raise _Discarded()
        except BaseException as e:                   # noqa: BLE001
            cm.__exit__(type(e), e, e.__traceback__)
            if isinstance(e, _Discarded):
                cache.stats["discarded"] += 1
                return False
            raise
        try:
            cm.__exit__(None, None, None)
        except Exception as e:                               # noqa: BLE001
            warnings.warn(f"compile cache commit of {self.name} failed "
                          f"({type(e).__name__}: {str(e)[:200]}); entry "
                          f"not persisted")
            cache.stats["uncacheable"] += 1
            return False
        if compile_seconds is not None:
            _M_COMPILE_S.labels(executable=self.name).observe(
                compile_seconds)
        cache._sweep_retention(protect=self.dirname)
        return True


class CompileCache:
    """The committed entries under cache directory `path` (`root`), kept
    in its `SUBDIR` (`path`). `lookup` verifies an entry's manifest and
    metadata and treats any failure as a miss (the entry is deleted, so
    the next build recommits it)."""

    def __init__(self, path, max_entries=None):
        self.root = os.path.abspath(str(path))
        self.path = os.path.join(self.root, SUBDIR)
        os.makedirs(self.path, exist_ok=True)
        # entries committed before this stamp are bypassed (invalidate())
        self._min_ts = 0.0
        if max_entries is None:
            # the raw dict: flags.py attaches the global cache at import
            # time, before its accessors are defined
            from .flags import _FLAGS
            max_entries = _FLAGS.get("FLAGS_compile_cache_max_entries", 0)
        self.max_entries = int(max_entries or 0)
        self.stats = {"hits": 0, "misses": 0, "bypass": 0, "corrupt": 0,
                      "uncacheable": 0, "evicted": 0, "discarded": 0}

    # -- key --------------------------------------------------------------
    def entry_key(self, name, parts):
        """(dirname, digest) of entry `name` whose content is decided by
        `parts` (a tuple of reprable values)."""
        digest = _digest((FORMAT_VERSION,) + tuple(parts))
        return f"{_safe_name(name)}.{digest[:24]}", digest

    def _entry_dir(self, dirname):
        return os.path.join(self.path, dirname)

    def invalidate(self):
        """Bypass every entry committed before now for the rest of this
        process: they read as misses and the next build recommits them.
        Fresh processes see every entry again."""
        self._min_ts = time.time()

    def clear(self):
        """Delete every committed entry."""
        for name in os.listdir(self.path):
            full = self._entry_dir(name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)

    def entries(self):
        """Names of committed (manifested) entries."""
        out = []
        for name in sorted(os.listdir(self.path)):
            full = self._entry_dir(name)
            if not name.startswith(".") and os.path.isdir(full) \
                    and ckpt_commit.read_manifest(full) is not None:
                out.append(name)
        return out

    @contextlib.contextmanager
    def entry_lock(self, dirname):
        """An exclusive lock on entry `dirname` across processes (flock on
        a hidden file beside it): hold it from a miss until the commit, so
        that processes missing the same entry build it once."""
        fd = os.open(os.path.join(self.path, f".{dirname}.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    # -- load -------------------------------------------------------------
    def lookup(self, name, dirname, digest, loader=None, check=None):
        """The entry, or None (a miss). With `loader(entry_dir, meta)` the
        result is what it returns (timed as the load seconds), else the
        entry's directory. `check(meta)` may raise to reject an entry
        whose metadata this process cannot use. Never raises: torn,
        corrupt, skewed or unloadable entries are deleted and miss."""
        full = self._entry_dir(dirname)
        if not os.path.isdir(full):
            self._miss()
            return None
        try:
            manifest = ckpt_commit.verify_dir(full)
        except ckpt_commit.CheckpointCorruptError as e:
            warnings.warn(f"compile cache entry {dirname} failed "
                          f"verification ({e}); rebuilding")
            shutil.rmtree(full, ignore_errors=True)
            self.stats["corrupt"] += 1
            self._miss()
            return None
        if float(manifest.get("ts", 0.0)) < self._min_ts:
            self.stats["bypass"] += 1
            self._miss()
            return None
        try:
            meta = self._read_meta(full, digest)
            if check is not None:
                check(meta)
            t0 = time.perf_counter()
            out = loader(full, meta) if loader is not None else full
            _M_LOAD_S.labels(executable=name).observe(
                time.perf_counter() - t0)
        except Exception as e:                               # noqa: BLE001
            warnings.warn(f"compile cache entry {dirname} failed to load "
                          f"({type(e).__name__}: {str(e)[:200]}); "
                          f"rebuilding")
            shutil.rmtree(full, ignore_errors=True)
            self.stats["corrupt"] += 1
            self._miss()
            return None
        self.stats["hits"] += 1
        _M_HITS.inc()
        try:
            os.utime(full)        # LRU recency: a served entry is "used"
        except OSError:
            pass
        return out

    @staticmethod
    def _read_meta(full, digest):
        with open(os.path.join(full, ENTRY_META)) as f:
            meta = json.load(f)
        if meta.get("schema") != ENTRY_SCHEMA:
            raise ValueError(f"entry schema {meta.get('schema')!r}")
        if meta.get("digest") != digest:
            raise ValueError("entry digest mismatch")
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"format version skew: entry {meta.get('format_version')} "
                f"vs runtime {FORMAT_VERSION}")
        return meta

    def _miss(self):
        self.stats["misses"] += 1
        _M_MISSES.inc()

    # -- store ------------------------------------------------------------
    def begin(self, name, dirname, digest):
        """A `PendingEntry` whose `tmp` directory the build writes into."""
        return PendingEntry(self, name, dirname, digest)

    def store(self, name, dirname, digest, write, compile_seconds=None,
              extra_meta=None):
        """Commit an entry whose files `write(tmp_dir)` writes; returns
        `PendingEntry.commit`'s answer."""
        pending = self.begin(name, dirname, digest)
        try:
            write(pending.tmp)
        except BaseException:
            pending.abort()
            raise
        return pending.commit(compile_seconds, extra_meta)

    def _sweep_retention(self, protect=None):
        """Keep at most `max_entries` committed entries, evicting the
        least recently used first (directory mtime, refreshed by commits
        and hits); `protect` (the entry just committed) stays."""
        if self.max_entries <= 0:
            return
        aged = []
        for name in self.entries():
            if name == protect:
                continue
            try:
                aged.append((os.path.getmtime(self._entry_dir(name)), name))
            except OSError:
                continue
        excess = len(aged) + (1 if protect else 0) - self.max_entries
        if excess <= 0:
            return
        aged.sort()
        for _, name in aged[:excess]:
            shutil.rmtree(self._entry_dir(name), ignore_errors=True)
            self.stats["evicted"] += 1


# ---------------------------------------------------- process-global tier

_ACTIVE = None


def attach(path):
    """Attach (or re-point) the process-global cache: the one
    `_kernels/build.py` uses when no engine-private cache applies."""
    global _ACTIVE
    _ACTIVE = CompileCache(path)
    return _ACTIVE


def detach():
    global _ACTIVE
    _ACTIVE = None


def active():
    return _ACTIVE


def invalidate_active():
    """Bypass the attached cache's current entries for the rest of this
    process (a no-op when none is attached)."""
    if _ACTIVE is not None:
        _ACTIVE.invalidate()
