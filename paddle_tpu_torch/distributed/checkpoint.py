"""State-dict checkpoints on one device, in the JAX package's layout.

Counterpart of the single-device part of `paddle_tpu/distributed/
checkpoint.py`: `save_state_dict` and `load_state_dict`. One directory
per checkpoint:

  meta.json        tensor name -> {shape, dtype, spec, chunks}
  <name>.<i>.npy   one file per chunk with its index window

A tensor is written as one chunk covering the whole array (`spec`
empty). A sharded leaf of the training step (a list with one piece a
rank, under `plan=`) is written as one chunk per distinct piece, with its
JAX PartitionSpec (`specs=`, default the GPT leaves' `param_specs`), as
the JAX package writes a sharded array. Any chunk layout loads by
stitching the windows, so a checkpoint either package writes loads in
the other. bfloat16 is stored as float32 data under dtype "bfloat16"
(exact), as the JAX file does.

Saves go through `framework.ckpt_commit`: the files land in a hidden
tempdir, are sha256-manifested and fsynced, and rename onto `path`; the
parent's `LATEST` pointer moves only after the rename, and `keep=K`
garbage-collects older siblings of the same lineage. Loads verify the
digests and, pointed at a root holding `LATEST` or at a checkpoint that
fails verification, fall back to the newest sibling that verifies.

Re-slicing across meshes: `load_state_dict(path, plan=...)` cuts every
entry into the plan's per-rank pieces by its stored spec, with the axes
the plan does not name folded away (the JAX `mesh=` argument), and
`convert_state_dict` writes a checkpoint laid out for another plan.
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

__all__ = ["save_state_dict", "load_state_dict", "convert_state_dict",
           "CheckpointCorruptError"]


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


def _spec_to_list(spec):
    return [list(p) if isinstance(p, (tuple, list)) else p for p in spec]


def _grid(plan, devices=None):
    from ..parallel.collectives import RankGrid
    devs = devices or [torch.device("cpu")] * plan.n_devices
    return RankGrid(plan.dims, [resolve_device(d) for d in devs])


def _chunks(name, pieces, spec, plan):
    """(entry, [(file, data)]) of a sharded leaf: one chunk per distinct
    window (replicas deduped), in rank order."""
    from ..parallel.gpt_spmd import _global_shape, _window
    grid = _grid(plan)
    if len(pieces) != grid.size:
        raise ValueError(f"{name}: {len(pieces)} pieces for a plan of "
                         f"{grid.size} ranks")
    first = _host_array(pieces[0])
    shape = _global_shape(tuple(first[0].shape), spec, grid)
    entry = {"shape": list(shape), "dtype": first[1],
             "spec": _spec_to_list(spec), "chunks": []}
    files, seen = [], set()
    for r, piece in enumerate(pieces):
        key = tuple((w.start, w.stop) for w in _window(shape, spec, grid, r))
        if key in seen:
            continue
        seen.add(key)
        fn = f"{_sanitize(name)}.{len(files)}.npy"
        files.append((fn, first[0] if r == 0 else _host_array(piece)[0]))
        entry["chunks"].append({"file": fn, "index": [list(k) for k in key]})
    return entry, files


def save_state_dict(state_dict, path, keep=None, plan=None, specs=None):
    """Write `state_dict` ({name: tensor | array | [one piece a rank]}) as
    a committed checkpoint at `path`. A list is a leaf sharded over
    `plan`'s ranks under `specs[name]` (default: the GPT `param_specs`).
    `keep=K` retains only the newest K committed checkpoints of its
    lineage in path's parent (never the one just written)."""
    path = os.path.abspath(path)
    if specs is None:
        from ..parallel.gpt_spmd import param_specs
        specs = param_specs()
    with _commit.atomic_commit(path) as tmp:
        meta = {}
        for name, value in state_dict.items():
            if isinstance(value, (list, tuple)):
                if plan is None or name not in specs:
                    raise ValueError(f"{name}: a sharded leaf needs plan= "
                                     "and its spec")
                entry, files = _chunks(name, value, specs[name], plan)
            else:
                data, dtype = _host_array(value)
                fn = f"{_sanitize(name)}.0.npy"
                files = [(fn, data)]
                entry = {"shape": list(data.shape), "dtype": dtype,
                         "spec": [],
                         "chunks": [{"file": fn,
                                     "index": [[0, s] for s in data.shape]}]}
            for fn, data in files:
                np.save(os.path.join(tmp, fn), np.ascontiguousarray(data))
            meta[name] = entry
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


def _fold(spec):
    """A stored spec with the axes the port's meshes do not name dropped
    (that degree folded away)."""
    from ..parallel.collectives import AXES
    out = []
    for p in spec:
        if isinstance(p, list):
            p = tuple(p)
        ok = p in AXES if isinstance(p, str) else \
            isinstance(p, tuple) and set(p) <= set(AXES)
        out.append(p if ok else None)
    return tuple(out)


def load_state_dict(path, device="cuda", return_numpy=False, plan=None,
                    devices=None):
    """Load a checkpoint written by either package. `path` may be a
    checkpoint dir or a root holding several; digests are verified and
    torn checkpoints skipped in favour of the newest valid one. Returns
    {name: tensor on `device`} (bfloat16 entries as bfloat16), or with
    `return_numpy=True` {name: numpy array} (bfloat16 entries as their
    exact float32 values: numpy has no bfloat16). With `plan` (any
    plan, whatever the saving mesh was) every entry is re-sliced by its
    stored spec into one piece a rank, rank r's on `devices[r]` (default
    `device`): {name: [pieces]}; an entry without a spec is replicated."""
    path = _resolve_checkpoint(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dev = None if return_numpy else resolve_device(device)
    grid = None
    if plan is not None and not return_numpy:
        from ..parallel.gpt_spmd import _resolve_devices, shard_leaf
        grid = _grid(plan, _resolve_devices(
            devices or [dev] * plan.n_devices, plan.n_devices))
    out = {}
    for name, entry in meta.items():
        arr = _assemble(path, entry)
        if return_numpy:
            out[name] = arr
            continue
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        if grid is not None:
            out[name] = shard_leaf(t, _fold(entry["spec"]), grid)
        else:
            out[name] = t.to(dev)
    return out


def convert_state_dict(src_path, dst_path, plan):
    """Offline re-slice: read a checkpoint saved on one mesh, write it
    laid out for `plan` (the JAX `convert_state_dict`), on the host."""
    src = _resolve_checkpoint(src_path)
    with open(os.path.join(src, "meta.json")) as f:
        meta = json.load(f)
    sd = load_state_dict(src, device="cpu", plan=plan)
    save_state_dict(sd, dst_path, plan=plan,
                    specs={k: _fold(e["spec"]) for k, e in meta.items()})
    return dst_path
