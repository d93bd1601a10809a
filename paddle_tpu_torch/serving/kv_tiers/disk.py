"""Disk KV tier: an append-only block log and an in-memory index.

Counterpart of `paddle_tpu/serving/kv_tiers/disk.py`, copied with the
log format unchanged, so a log written by either package opens and
restores in the other. One `blocks.log` of framed records, each

    b"KVT1" | u32 header_len | header JSON | payload bytes

where the header pins the payload's byte count, the array shapes and
dtypes, and its sha256. Every append is flushed and fsynced before the
index learns the record exists, and the committed end offset (`_end`)
only advances past fully fsynced records, so a kill mid-spill (or the
`serving.kv_spill` truncate fault, which tears the record bytes on
purpose) leaves a torn tail that the open-time scan stops at and
truncates away. A torn record is never indexed and never restored: the
chain is lost (a miss and a recompute), never corrupt.

A restore verifies the payload's sha256 against the header before
handing the bytes back; a mismatch drops the record and reports the
corruption, which the caller counts in `serving_kv_tier_corrupt_total`
and treats as a miss.

Capacity is counted in entries (one entry is one block); superseded and
dropped records leave dead bytes in the log, and when they exceed
`compact_threshold` of the file a compaction rewrites the live records
to a temporary file and replaces the log atomically (tmp, fsync,
`os.replace`, directory fsync).

Standard library and numpy only.
"""
import hashlib
import json
import os
import struct

import numpy as np

__all__ = ["DiskTier", "MAGIC"]

MAGIC = b"KVT1"
_PRELUDE = struct.Struct("<4sI")        # magic, header_len


def _fsync_dir(path):
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass                  # platform without directory fsync


def _serialize(key, rec):
    """(header_json_bytes, payload_bytes) for one block record. Arrays
    serialize in sorted-name order so the sha256 is layout-stable."""
    names = sorted(rec["arrays"])
    payload = b"".join(np.ascontiguousarray(rec["arrays"][n]).tobytes()
                       for n in names)
    header = {
        "key": str(key),
        "ns": rec.get("ns"),
        "parent": rec.get("parent"),
        "quant": bool(rec.get("quant", False)),
        "arrays": [{"name": n,
                    "shape": list(np.asarray(rec["arrays"][n]).shape),
                    "dtype": str(np.asarray(rec["arrays"][n]).dtype)}
                   for n in names],
        "payload_bytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    return json.dumps(header, sort_keys=True).encode("utf-8"), payload


def _deserialize(header, payload):
    """Rebuild the record dict from a verified header + payload."""
    arrays = {}
    off = 0
    for spec in header["arrays"]:
        dt = np.dtype(spec["dtype"])
        n = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
        arrays[spec["name"]] = np.frombuffer(
            payload[off:off + n], dt).reshape(spec["shape"]).copy()
        off += n
    return {"ns": header.get("ns"), "parent": header.get("parent"),
            "quant": bool(header.get("quant", False)), "arrays": arrays}


class DiskTier:
    """Append-log block store. The index maps chain key ->
    (offset, record_len, header); insertion order doubles as LRU-ish
    recency (a re-put moves the key to the end)."""

    def __init__(self, directory, capacity_blocks=256,
                 compact_threshold=0.5):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "blocks.log")
        self.capacity = int(capacity_blocks)
        self.compact_threshold = float(compact_threshold)
        self._index = {}             # key -> (offset, length, header)
        self._end = 0                # committed good end offset
        self._dead = 0               # superseded/dropped record bytes
        self.recovered_torn_bytes = 0
        self._recover()

    def __len__(self):
        return len(self._index)

    def __contains__(self, key):
        return key in self._index

    def keys(self):
        return list(self._index)

    def header(self, key):
        """The indexed record's header dict (or None): namespace/parent
        attribution without reading — or risking dropping — the payload.
        What the store consults BEFORE a restore that might drop the
        entry as corrupt."""
        ent = self._index.get(key)
        return ent[2] if ent is not None else None

    # -- open-time scan ------------------------------------------------------
    def _recover(self):
        """Walk the log from offset 0, indexing every structurally
        complete record; stop at the first torn/foreign frame and
        truncate the file back to the last good end — the append-log
        recovery contract. Content (sha256) is verified lazily at
        restore, not here: a bit-rotted middle record must not cost the
        chains behind it."""
        if not os.path.exists(self.path):
            with open(self.path, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(self.path)
            return
        size = os.path.getsize(self.path)
        with open(self.path, "rb") as f:
            off = 0
            while off + _PRELUDE.size <= size:
                f.seek(off)
                magic, hlen = _PRELUDE.unpack(f.read(_PRELUDE.size))
                if magic != MAGIC or hlen <= 0 or hlen > 1 << 24:
                    break
                raw = f.read(hlen)
                if len(raw) < hlen:
                    break
                try:
                    header = json.loads(raw.decode("utf-8"))
                    pbytes = int(header["payload_bytes"])
                    key = str(header["key"])
                except (ValueError, KeyError, UnicodeDecodeError):
                    break
                total = _PRELUDE.size + hlen + pbytes
                if off + total > size:
                    break                       # torn tail: payload short
                if key in self._index:
                    self._dead += self._index[key][1]
                self._index[key] = (off, total, header)
                off += total
            self._end = off
        if self._end < size:
            self.recovered_torn_bytes = size - self._end
            with open(self.path, "r+b") as f:
                f.truncate(self._end)
                f.flush()
                os.fsync(f.fileno())

    # -- append --------------------------------------------------------------
    def put(self, key, rec, torn=False):
        """Append one record; True once it is fsync'd AND indexed.
        `torn=True` is the `serving.kv_spill` truncate contract: write
        only a prefix of the record's bytes (the mid-spill SIGKILL
        image), fsync that, and report failure WITHOUT advancing the
        committed end — the next append overwrites the torn bytes, and
        a crash-then-reopen scan truncates them, so a torn record can
        never be restored."""
        hjson, payload = _serialize(key, rec)
        blob = _PRELUDE.pack(MAGIC, len(hjson)) + hjson + payload
        if torn:
            blob = blob[:max(_PRELUDE.size + 1, len(blob) // 2)]
        with open(self.path, "r+b") as f:
            f.seek(self._end)
            f.truncate(self._end)     # discard any prior torn bytes
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        if torn:
            return False
        if key in self._index:
            self._dead += self._index[key][1]
        header = json.loads(hjson.decode("utf-8"))
        self._index[key] = (self._end, len(blob), header)
        self._end += len(blob)
        return True

    # -- restore -------------------------------------------------------------
    def get(self, key, torn=False):
        """(record, corrupt): the verified record or None. `torn=True`
        (the `serving.kv_restore` truncate contract) makes the read see
        only half the payload — the sha256 check then fails exactly as
        it would for real bit rot, the record is dropped, and
        (None, True) tells the caller to latch the corruption counter
        and treat the chain as a miss."""
        ent = self._index.get(key)
        if ent is None:
            return None, False
        off, total, header = ent
        with open(self.path, "rb") as f:
            f.seek(off)
            blob = f.read(total)
        if len(blob) != total or blob[:4] != MAGIC:
            self.drop(key)
            return None, True
        hlen = _PRELUDE.unpack(blob[:_PRELUDE.size])[1]
        payload = blob[_PRELUDE.size + hlen:]
        if torn:
            payload = payload[:len(payload) // 2]
        if len(payload) != int(header["payload_bytes"]) or \
                hashlib.sha256(payload).hexdigest() != header["sha256"]:
            self.drop(key)
            return None, True
        return _deserialize(header, payload), False

    # -- drop / capacity / compaction ---------------------------------------
    def drop(self, key):
        ent = self._index.pop(key, None)
        if ent is None:
            return False
        self._dead += ent[1]
        self._maybe_compact()
        return True

    def enforce_capacity(self):
        """Drop oldest entries beyond capacity; returns [(key, header)]
        of the dropped so the store can emit `tier_drop` events."""
        out = []
        while len(self._index) > max(self.capacity, 0):
            key = next(iter(self._index))
            out.append((key, self._index[key][2]))
            self.drop(key)
        return out

    def dead_fraction(self):
        return self._dead / self._end if self._end else 0.0

    def _maybe_compact(self):
        if self._end and self._dead > self.compact_threshold * self._end:
            self.compact()

    def compact(self):
        """Rewrite live records to a temp log and atomically replace
        (tmp + fsync + os.replace + dir fsync — the ckpt_commit
        `update_latest` pattern), so a crash mid-compaction leaves
        either the old log or the new one, never a hybrid."""
        tmp = self.path + ".compact.tmp"
        new_index = {}
        with open(self.path, "rb") as src, open(tmp, "wb") as dst:
            off = 0
            for key, (src_off, total, header) in self._index.items():
                src.seek(src_off)
                blob = src.read(total)
                dst.write(blob)
                new_index[key] = (off, total, header)
                off += total
            dst.flush()
            os.fsync(dst.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(self.path)
        self._index = new_index
        self._end = off
        self._dead = 0
