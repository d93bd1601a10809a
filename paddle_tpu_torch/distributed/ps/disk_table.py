"""The disk tier of the sparse table (counterpart of
`paddle_tpu/distributed/ps/disk_table.py`, copied; the log format is the
JAX package's, so a log written by either package reopens in the other).

Reference: paddle/fluid/distributed/ps/table/ssd_sparse_table.{h,cc}, the
tier for embedding spaces larger than host memory: hot rows cached in the
MemorySparseTable layout over a value store on disk, cold rows faulted in
on pull and spilled on eviction. Without RocksDB:

  hot tier   the native table (`native/src/ps_table.cc`), so the sparse
             rules (sgd / adagrad / adam) run on hot rows exactly as in
             the memory table;
  cold tier  one append-only log: a fixed header, then fixed-size records
             `i64 key | (dim + slot) * f32` (values and optimizer slots).
             The newest record of a key wins; an index in memory maps a
             key to its latest record;
  movement   pull / push fault cold keys hot (`assign` restores values and
             optimizer state); past `hot_capacity` the least recently used
             rows are appended to the log and erased from the hot tier;
  compaction when dead records pass `compact_ratio` of the log, the live
             ones are rewritten to a side file that replaces the log
             atomically (os.replace);
  recovery   reopening a path replays its log (later records shadow
             earlier ones) and drops a torn tail record, so a kill after
             `flush()` loses nothing; rows changed only in the hot tier
             since the last flush or eviction are the crash window.

Registered as the table type "SSDSparseTable" (`distributed.ps`).
"""
import os
import shutil
import struct
import threading
from collections import OrderedDict

import numpy as np

from ... import native

__all__ = ["DiskSparseTable"]

_MAGIC = 0x0070745353440001          # "ptSSD" v1
_FHDR = struct.Struct("<QiiQ")       # magic | dim | slot | reserved


class DiskSparseTable:
    """SparseTable-compatible SSD-tier table: same pull/push/save/load
    surface, so SparseEmbedding, AsyncCommunicator and PSServer work
    unchanged on top of it."""

    def __init__(self, dim, path, rule="adagrad", lr=0.05, init_range=0.01,
                 seed=0, hot_capacity=4096, compact_ratio=0.5,
                 min_compact_bytes=1 << 16):
        self.dim = int(dim)
        self.rule = rule
        self.path = path
        self.hot_capacity = max(int(hot_capacity), 1)
        self.compact_ratio = float(compact_ratio)
        self.min_compact_bytes = int(min_compact_bytes)
        self._hot = native.SparseTable(dim, rule=rule, lr=lr,
                                       init_range=init_range, seed=seed)
        self.slot = self._hot.slot
        self._width = self.dim + self.slot
        self._rec = 8 + 4 * self._width
        self._lru = OrderedDict()        # hot keys, oldest first
        self._index = {}                 # key -> latest record offset
        self._dead = 0                   # bytes shadowed by newer records
        self.compactions = 0
        self._lock = threading.RLock()
        self._f = None
        self._open()

    # -- log file ----------------------------------------------------------
    def _open(self):
        fresh = (not os.path.exists(self.path)
                 or os.path.getsize(self.path) < _FHDR.size)
        if fresh:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            with open(self.path, "wb") as f:
                f.write(_FHDR.pack(_MAGIC, self.dim, self.slot, 0))
        else:
            self._replay()
        self._f = open(self.path, "r+b")

    def _replay(self):
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            magic, dim, slot, _ = _FHDR.unpack(f.read(_FHDR.size))
            if magic != _MAGIC or dim != self.dim or slot != self.slot:
                raise IOError(
                    f"DiskSparseTable log {self.path!r} does not match: "
                    f"file dim={dim}/slot={slot}, table dim={self.dim}/"
                    f"slot={self.slot}")
            n_rec = (size - _FHDR.size) // self._rec
            off = _FHDR.size
            for _ in range(n_rec):
                buf = f.read(self._rec)
                (key,) = struct.unpack_from("<q", buf)
                if key in self._index:
                    self._dead += self._rec
                self._index[key] = off
                off += self._rec
        good_end = _FHDR.size + n_rec * self._rec
        if good_end != size:
            # torn tail record from a crash mid-append: drop it
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def _read_rows(self, keys):
        vals = np.empty((len(keys), self.dim), np.float32)
        state = np.empty((len(keys), self.slot), np.float32)
        for j, k in enumerate(keys):
            self._f.seek(self._index[k])
            buf = self._f.read(self._rec)
            (stored,) = struct.unpack_from("<q", buf)
            if stored != k:
                raise IOError(f"DiskSparseTable log corrupt: index points "
                              f"key {k} at a record for {stored}")
            row = np.frombuffer(buf, np.float32, self._width, 8)
            vals[j] = row[:self.dim]
            state[j] = row[self.dim:]
        return vals, state

    def _append_rows(self, keys, vals, state):
        self._f.seek(0, os.SEEK_END)
        off = self._f.tell()
        for j, k in enumerate(keys):
            row = np.concatenate([vals[j], state[j]]) if self.slot \
                else vals[j]
            self._f.write(struct.pack("<q", int(k))
                          + np.ascontiguousarray(row, np.float32).tobytes())
            if k in self._index:
                self._dead += self._rec
            self._index[k] = off
            off += self._rec

    # -- tier movement -----------------------------------------------------
    def _fault_in(self, keys):
        """Load the batch's cold keys into the hot tier and mark the whole
        batch most-recently-used. Eviction deliberately happens in
        `_shrink()` AFTER the table op: a batch larger than hot_capacity
        must be fully resident while the op runs, else just-evicted keys
        would re-init mid-batch."""
        uniq = np.unique(np.asarray(keys, np.int64).reshape(-1)).tolist()
        load = [k for k in uniq if k not in self._lru and k in self._index]
        if load:
            vals, state = self._read_rows(load)
            self._hot.assign(np.asarray(load, np.int64), vals,
                             state if self.slot else None)
        for k in uniq:
            self._lru[k] = None
            self._lru.move_to_end(k)

    def _shrink(self):
        over = len(self._lru) - self.hot_capacity
        if over > 0:
            victims = [self._lru.popitem(last=False)[0] for _ in range(over)]
            self._spill(victims, erase=True)
            self._maybe_compact()

    def _spill(self, keys, erase):
        ks = np.asarray(keys, np.int64)
        vals, state = self._hot.pull_with_state(ks)
        self._append_rows(keys, vals,
                          state if self.slot else
                          np.empty((ks.size, 0), np.float32))
        if erase:
            self._hot.erase(ks)

    def _maybe_compact(self):
        total = self._f.seek(0, os.SEEK_END) - _FHDR.size
        if total < self.min_compact_bytes or \
                self._dead < self.compact_ratio * total:
            return
        self._compact()

    def _compact(self):
        """Rewrite live records to a sidecar, atomically swap it in."""
        tmp = self.path + ".compact"
        live = sorted(self._index.items(), key=lambda kv: kv[1])
        with open(tmp, "wb") as out:
            out.write(_FHDR.pack(_MAGIC, self.dim, self.slot, 0))
            new_index = {}
            off = _FHDR.size
            for k, old_off in live:
                self._f.seek(old_off)
                out.write(self._f.read(self._rec))
                new_index[k] = off
                off += self._rec
            out.flush()
            os.fsync(out.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "r+b")
        self._index = new_index
        self._dead = 0
        self.compactions += 1

    # -- SparseTable surface -----------------------------------------------
    def pull(self, keys):
        """Fault cold rows hot (values + optimizer state), then serve from
        the hot tier; unseen keys get the hot table's deterministic init."""
        with self._lock:
            self._fault_in(keys)
            out = self._hot.pull(keys)
            self._shrink()
            return out

    def push(self, keys, grads):
        """Sparse-grad update THROUGH the hot tier: the native optimizer
        rule (sgd/adagrad/adam) runs on the hot rows; the result reaches
        disk on eviction or flush()."""
        with self._lock:
            self._fault_in(keys)
            self._hot.push(keys, grads)
            self._shrink()

    def pull_with_state(self, keys):
        with self._lock:
            self._fault_in(keys)
            out = self._hot.pull_with_state(keys)
            self._shrink()
            return out

    def assign(self, keys, values, state=None):
        with self._lock:
            self._fault_in(keys)
            self._hot.assign(keys, values, state)
            self._shrink()

    def flush(self):
        """Write-through checkpoint: every hot row is appended to the log
        (staying hot) and the log is fsynced — after this, kill -9 loses
        nothing."""
        with self._lock:
            hot = list(self._lru.keys())
            if hot:
                self._spill(hot, erase=False)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._maybe_compact()

    def save(self, path):
        with self._lock:
            self.flush()
            if os.path.abspath(path) != os.path.abspath(self.path):
                shutil.copyfile(self.path, path)

    def load(self, path):
        with self._lock:
            self._f.close()
            if os.path.abspath(path) != os.path.abspath(self.path):
                shutil.copyfile(path, self.path)
            if self._lru:
                self._hot.erase(np.asarray(list(self._lru), np.int64))
                self._lru.clear()
            self._index.clear()
            self._dead = 0
            self._open()

    def __len__(self):
        with self._lock:
            return len(set(self._index) | set(self._lru))

    @property
    def stats(self):
        with self._lock:
            return {"hot_rows": len(self._lru),
                    "disk_rows": len(self._index),
                    "dead_bytes": self._dead,
                    "file_bytes": (os.path.getsize(self.path)
                                   if os.path.exists(self.path) else 0),
                    "compactions": self.compactions}

    def close(self):
        with self._lock:
            if self._f is not None and not self._f.closed:
                self.flush()
                self._f.close()

    def destroy(self):
        try:
            self.close()
        except (IOError, OSError, ValueError):
            pass
        self._hot.destroy()

    def __del__(self):
        try:
            if self._f is not None and not self._f.closed:
                self._f.close()
        except Exception:
            pass
