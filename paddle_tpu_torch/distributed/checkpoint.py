"""State-dict checkpoints on one device, in the JAX package's layout.

Counterpart of the single-device part of `paddle_tpu/distributed/
checkpoint.py`: `save_state_dict` and `load_state_dict`. One directory
per checkpoint:

  meta.json        tensor name -> {shape, dtype, spec, chunks}
  <name>.<i>.npy   one file per chunk with its index window

The port writes one chunk per tensor covering the whole array (`spec`
empty) and reads any chunk layout by stitching the windows, so a
checkpoint either package writes loads in the other. bfloat16 is stored
as float32 data under dtype "bfloat16" (exact), as the JAX file does.

Saves go through `framework.ckpt_commit`: the files land in a hidden
tempdir, are sha256-manifested and fsynced, and rename onto `path`; the
parent's `LATEST` pointer moves only after the rename, and `keep=K`
garbage-collects older siblings of the same lineage. Loads verify the
digests and, pointed at a root holding `LATEST` or at a checkpoint that
fails verification, fall back to the newest sibling that verifies.

Re-slicing across meshes (`convert_state_dict`, the `mesh=` argument)
waits for multi-GPU (ROADMAP A.10).
"""
import json
import os
import re
import warnings

import numpy as np
import torch

from ..core.device import resolve_device
from ..framework import ckpt_commit as _commit
from ..framework.ckpt_commit import CheckpointCorruptError  # noqa: F401

__all__ = ["save_state_dict", "load_state_dict", "CheckpointCorruptError"]


def _sanitize(name):
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", name)


def _host_array(value):
    """(numpy array, dtype name) of a tensor or array-like; bfloat16
    becomes float32 data named "bfloat16"."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.astype(np.float32), "bfloat16"
    return arr, str(arr.dtype)


def save_state_dict(state_dict, path, keep=None):
    """Write `state_dict` ({name: tensor | array}) as a committed
    checkpoint at `path`. `keep=K` retains only the newest K committed
    checkpoints of its lineage in path's parent (never the one just
    written)."""
    path = os.path.abspath(path)
    with _commit.atomic_commit(path) as tmp:
        meta = {}
        for name, value in state_dict.items():
            data, dtype = _host_array(value)
            fn = f"{_sanitize(name)}.0.npy"
            np.save(os.path.join(tmp, fn), np.ascontiguousarray(data))
            meta[name] = {"shape": list(data.shape), "dtype": dtype,
                          "spec": [],
                          "chunks": [{"file": fn,
                                      "index": [[0, s] for s in data.shape]}]}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
    root, base = os.path.dirname(path), os.path.basename(path)
    _commit.update_latest(root, base)
    if keep is not None:
        _commit.gc_old(root, keep, protect={base}, same_lineage_as=base)


def _assemble(path, entry):
    """Stitch an entry's chunks into the full host array (float32 for a
    bfloat16 entry)."""
    dtype = entry["dtype"]
    np_dtype = np.float32 if dtype == "bfloat16" else np.dtype(dtype)
    full = np.zeros(entry["shape"], dtype=np_dtype)
    for ch in entry["chunks"]:
        data = np.load(os.path.join(path, ch["file"]))
        full[tuple(slice(a, b) for a, b in ch["index"])] = data
    return full


def _resolve_checkpoint(path):
    """Map `path` (a checkpoint dir OR a root with a LATEST pointer) to a
    VERIFIED checkpoint dir, falling back to the newest valid sibling of
    its lineage when the preferred one is torn. Raises
    CheckpointCorruptError when a corruption was detected and nothing
    valid remains."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, "meta.json")):
        if _commit.read_manifest(path) is None:
            return path          # pre-manifest checkpoint: load as-is
        try:
            _commit.verify_dir(path)
            return path
        except CheckpointCorruptError as e:
            root, base = os.path.dirname(path), os.path.basename(path)
            fallback = _commit.find_valid(root, exclude={base},
                                          same_lineage_as=base)
            if fallback is None:
                raise
            warnings.warn(f"{e}; falling back to {fallback}",
                          RuntimeWarning, stacklevel=3)
            return fallback
    resolved, latest_name = _commit.resolve_valid(path)
    if latest_name is not None:
        if resolved is None:
            raise CheckpointCorruptError(
                f"{path}: LATEST points at {latest_name!r} which is torn "
                f"or missing, and no sibling checkpoint of its lineage "
                f"verifies")
        if os.path.basename(resolved) != latest_name:
            warnings.warn(
                f"{os.path.join(path, latest_name)} is torn or missing; "
                f"falling back to {resolved}", RuntimeWarning, stacklevel=3)
        return resolved
    if resolved is not None:
        return resolved
    return path                   # let the meta.json open raise cleanly


def load_state_dict(path, device="cuda", return_numpy=False):
    """Load a checkpoint written by either package. `path` may be a
    checkpoint dir or a root holding several; digests are verified and
    torn checkpoints skipped in favour of the newest valid one. Returns
    {name: tensor on `device`} (bfloat16 entries as bfloat16), or with
    `return_numpy=True` {name: numpy array} (bfloat16 entries as their
    exact float32 values: numpy has no bfloat16)."""
    path = _resolve_checkpoint(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dev = None if return_numpy else resolve_device(device)
    out = {}
    for name, entry in meta.items():
        arr = _assemble(path, entry)
        if return_numpy:
            out[name] = arr
            continue
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        out[name] = t.to(dev)
    return out
