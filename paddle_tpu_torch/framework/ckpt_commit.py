"""Crash-safe checkpoint commit protocol, shared by every writer.

Counterpart of `paddle_tpu/framework/ckpt_commit.py`, copied (stdlib plus
the port's fault sites): the manifest schema, the `LATEST` pointer and
the tempdir naming stay as they are, so a checkpoint committed by either
package verifies and resolves in the other. Used by
`distributed/checkpoint.py` (state dicts) and the serving worker's
hot-swap source. The protocol:

  1. write every file into a hidden sibling tempdir (`.<name>.tmp.*`),
  2. hash each file (sha256) into `MANIFEST.json`, written LAST inside
     the tempdir, so a dir without a manifest is by definition torn,
  3. fsync files, manifest, and directories,
  4. atomically rename the tempdir onto the final name,
  5. update the root's `LATEST` pointer only after the rename.

A crash (SIGKILL included) at ANY point leaves either the previous
committed checkpoint untouched (steps 1-4: the tempdir is garbage that
readers ignore and the next save sweeps) or both checkpoints valid with
LATEST pointing at one of them (step 5). Readers verify digests against
the manifest and fall back to the newest sibling that verifies, so a
torn or bit-rotted checkpoint is skipped, never loaded.

The `checkpoint.write` fault site (the port's `observability.faults`)
fires between steps 1 and 2: `delay` holds the commit open, `truncate`
tears a data file and raises (a failed write can never commit).

Stdlib-only; tensor encodings are the callers' business.
"""
import hashlib
import json
import os
import re
import shutil
import time
from contextlib import contextmanager

from ..observability import faults as _faults

__all__ = ["MANIFEST", "LATEST", "MANIFEST_SCHEMA", "CheckpointCorruptError",
           "atomic_commit", "read_manifest", "verify_dir", "is_valid",
           "update_latest", "resolve_latest", "find_valid", "resolve_valid",
           "has_commits", "gc_old", "sweep_stale_tmp", "lineage"]

MANIFEST = "MANIFEST.json"
LATEST = "LATEST"
MANIFEST_SCHEMA = "paddle_tpu.ckpt_manifest.v1"
_TMP_PREFIX = "."
_TMP_TAG = ".tmp."


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed digest/manifest verification and no valid
    fallback exists."""


def _fsync_path(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass          # some filesystems refuse dir fsync; rename still wins
    finally:
        os.close(fd)


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root):
    for dirpath, _, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            yield os.path.relpath(full, root), full


@contextmanager
def atomic_commit(final_path, extra_meta=None):
    """`with atomic_commit(dst) as tmp:` — write the checkpoint's files
    into `tmp`; on clean exit they are manifested, fsynced, and renamed
    onto `dst` in one step. On ANY exception the tempdir is removed and
    `dst` is left exactly as it was. `extra_meta` lands under the
    manifest's `meta` key (e.g. {"epoch_no": 3})."""
    final_path = os.path.abspath(final_path)
    parent = os.path.dirname(final_path)
    base = os.path.basename(final_path)
    os.makedirs(parent, exist_ok=True)
    sweep_stale_tmp(parent)
    tmp = os.path.join(parent,
                       f"{_TMP_PREFIX}{base}{_TMP_TAG}{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        yield tmp
        # fault site: data files are on disk, nothing is committed yet.
        # `delay` holds this window open; `truncate` tears a file + raises.
        spec = _faults.fire("checkpoint.write")
        if spec is not None and spec.mode == "truncate":
            for rel, full in _walk_files(tmp):
                size = os.path.getsize(full)
                with open(full, "r+b") as f:
                    f.truncate(size // 2)
                break
            raise OSError(
                "[fault-injection] torn write during checkpoint commit")
        files = {}
        for rel, full in sorted(_walk_files(tmp)):
            files[rel] = {"sha256": _sha256(full),
                          "bytes": os.path.getsize(full)}
            _fsync_path(full)
        manifest = {"schema": MANIFEST_SCHEMA, "ts": time.time(),
                    "pid": os.getpid(), "meta": dict(extra_meta or {}),
                    "files": files}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        if os.path.exists(final_path):
            # overwrite: move the old dir aside first (dir-onto-dir rename
            # is not atomic on posix), then swap in the new one. The
            # aside name is VISIBLE and keeps its manifest, so a crash
            # between the two renames leaves a checkpoint that
            # find_valid() recovers — and the stale-tmp sweep (hidden
            # names only) can never destroy it. On success it is removed
            # immediately.
            prev = os.path.join(parent, f"{base}.prev.{os.getpid()}")
            if os.path.exists(prev):
                shutil.rmtree(prev)
            os.rename(final_path, prev)
            os.rename(tmp, final_path)
            shutil.rmtree(prev, ignore_errors=True)
        else:
            os.rename(tmp, final_path)
        _fsync_path(parent)
        # with a fresh commit in place, overwrite-swap leftovers of THIS
        # name from crashed saves (dead pids) are superseded — reclaim
        # them so each crash costs at most one checkpoint of disk, once
        _sweep_prev(parent, base)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _sweep_prev(parent, base):
    """Remove `<base>.prev.<pid>` swap leftovers whose saver is dead."""
    try:
        entries = os.listdir(parent)
    except OSError:
        return
    prefix = f"{base}.prev."
    for name in entries:
        if name.startswith(prefix):
            pid_s = name[len(prefix):]
            if pid_s.isdigit() and int(pid_s) != os.getpid() \
                    and not _pid_alive(int(pid_s)):
                shutil.rmtree(os.path.join(parent, name),
                              ignore_errors=True)


def read_manifest(path):
    """The manifest dict of a committed checkpoint dir, or None (legacy
    or torn dir)."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            m = json.load(f)
        return m if isinstance(m, dict) and "files" in m else None
    except (OSError, ValueError):
        return None


def verify_dir(path):
    """Raise CheckpointCorruptError when `path` fails verification: no
    manifest, a listed file missing/resized, or a digest mismatch. A dir
    is NEVER partially valid — one bad byte rejects it whole."""
    manifest = read_manifest(path)
    if manifest is None:
        raise CheckpointCorruptError(
            f"{path}: no readable {MANIFEST} (torn or pre-manifest "
            f"checkpoint)")
    for rel, want in manifest["files"].items():
        full = os.path.join(path, rel)
        if not os.path.isfile(full):
            raise CheckpointCorruptError(f"{path}: missing file {rel}")
        if os.path.getsize(full) != want["bytes"]:
            raise CheckpointCorruptError(
                f"{path}: {rel} is {os.path.getsize(full)} bytes, manifest "
                f"says {want['bytes']} (torn write)")
        if _sha256(full) != want["sha256"]:
            raise CheckpointCorruptError(
                f"{path}: {rel} content digest mismatch")
    return manifest


def is_valid(path):
    try:
        verify_dir(path)
        return True
    except CheckpointCorruptError:
        return False


def update_latest(root, name):
    """Point `root/LATEST` at checkpoint `name` — written via a sibling
    temp file + atomic replace, and only ever called AFTER the
    checkpoint itself committed."""
    tmp = os.path.join(root, f"{_TMP_PREFIX}{LATEST}{_TMP_TAG}{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, LATEST))
    _fsync_path(root)


def resolve_latest(root):
    try:
        with open(os.path.join(root, LATEST)) as f:
            name = f.read().strip()
        return name or None
    except OSError:
        return None


def _committed_dirs(root):
    """[(ts, name)] of every manifested checkpoint dir under root,
    newest first. Hidden names (in-flight tempdirs) are invisible."""
    out = []
    try:
        entries = os.listdir(root)
    except OSError:
        return out
    for name in entries:
        if name.startswith(_TMP_PREFIX):
            continue
        full = os.path.join(root, name)
        if not os.path.isdir(full):
            continue
        m = read_manifest(full)
        if m is not None:
            out.append((float(m.get("ts", 0.0)), name))
    out.sort(reverse=True)
    return out


def lineage(name):
    """The checkpoint-family key of a dir name: the overwrite-swap
    `.prev.<pid>` marker is stripped FIRST (so `ckpt-2.prev.123` keys
    like `ckpt-2` does), then trailing version/stamp segments (`-0004`,
    `.2`) — `step-0003`/`step-0007` share a lineage while sibling state
    dicts `model` and `opt` do NOT: a fallback must never hand back a
    different family's tensors."""
    base = re.sub(r"\.prev\.\d+$", "", name)
    return re.sub(r"(?:[-._]\d+)+$", "", base)


def find_valid(root, exclude=(), same_lineage_as=None):
    """Path of the newest checkpoint under `root` that VERIFIES, or None.
    `exclude` names are skipped (e.g. the torn one just rejected);
    `same_lineage_as` restricts candidates to one checkpoint family."""
    want = lineage(same_lineage_as) if same_lineage_as else None
    for _, name in _committed_dirs(root):
        if name in exclude:
            continue
        if want is not None and lineage(name) != want:
            continue
        full = os.path.join(root, name)
        if is_valid(full):
            return full
    return None


def has_commits(root):
    """True when `root` carries ANY commit-protocol artifacts (a LATEST
    pointer or manifested checkpoint dirs, valid or torn). Readers use
    this to distinguish 'legacy layout' from 'everything is corrupt' —
    the latter must be loud, never a silent fresh start."""
    return resolve_latest(root) is not None or bool(_committed_dirs(root))


def resolve_valid(root, same_lineage_as=None):
    """(path, latest_name) of the newest VALID checkpoint under `root`:
    the LATEST pointer's target when it verifies, else the newest
    sibling of its lineage that does (`same_lineage_as` overrides the
    lineage key). `path` is None when nothing verifies; `latest_name` is
    None when the root has no LATEST pointer. The single resolution
    routine both checkpoint readers share, so torn-checkpoint fallback
    semantics stay uniform."""
    name = resolve_latest(root)
    if name is not None:
        candidate = os.path.join(root, name)
        if is_valid(candidate):
            return candidate, name
        return find_valid(root, exclude={name},
                          same_lineage_as=same_lineage_as or name), name
    return find_valid(root, same_lineage_as=same_lineage_as), None


def gc_old(root, keep, protect=(), same_lineage_as=None):
    """Retention: delete committed checkpoint dirs beyond the newest
    `keep`, never touching `protect` names, in-flight tempdirs, or (when
    `same_lineage_as` is given) checkpoints of OTHER families sharing
    the root. Runs only after a successful commit, so the survivor set
    always contains the checkpoint just written."""
    keep = max(int(keep), 1)
    want = lineage(same_lineage_as) if same_lineage_as else None
    names = [name for _, name in _committed_dirs(root)
             if want is None or lineage(name) == want]
    victims = [name for name in names[keep:] if name not in protect]
    for name in victims:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return victims


def sweep_stale_tmp(root):
    """Best-effort removal of tempdirs left behind by crashed saves."""
    try:
        entries = os.listdir(root)
    except OSError:
        return
    for name in entries:
        if name.startswith(_TMP_PREFIX) and _TMP_TAG in name:
            pid_s = name.rsplit(".", 1)[-1]
            if pid_s.isdigit() and int(pid_s) != os.getpid() \
                    and not _pid_alive(int(pid_s)):
                full = os.path.join(root, name)
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                else:
                    try:
                        os.remove(full)
                    except OSError:
                        pass


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True
