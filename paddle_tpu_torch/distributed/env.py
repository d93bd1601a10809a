"""The distributed environment of the port: the process group, the mesh
of ranks and the live-axis contexts (counterpart of
`paddle_tpu/distributed/env.py`).

The reference bootstraps processes with `jax.distributed.initialize` and
counts devices: one controller a host drives all of its chips, and its
mesh is a grid of devices. The port counts ranks:
  * across processes, a `torch.distributed` process group, one rank a
    process. `init_parallel_env()` reads the launcher's `PADDLE_*`
    variables and calls `init_process_group` over
    `tcp://$PADDLE_MASTER` with the backend asked for ("nccl" on CUDA
    and "gloo" on the CPU by default; two ranks on one card must pass
    "gloo", since NCCL refuses two ranks on one device). With a world
    above 1 and no address it raises: the reference carries on as one
    process there;
  * inside one process, the mesh: a `parallel.collectives.RankGrid` over
    the axes `build_mesh` names, one device a rank (by default the
    current place's device for every rank). Under a process group the mesh's ranks are
    split into consecutive blocks, one block a process, in the order the
    reference's world mesh sorts devices (process index, then id); this
    process drives the ranks of its block (`local_ranks`).

`get_world_size()` is the process group's size, else the size of an
installed one-process mesh, else 1; the reference's is
`jax.device_count()` (8 on the tests' virtual CPU host). `get_rank()` is
this process's rank in the group (0 without one).

Axis contexts mark which axes are "live": `axis_context(dp="dp")` says the
code inside drives the ranks of a manual region in lockstep (the
reference's shard_map body), where a collective takes one value a local
rank (`collective.py`). A process group of world > 1 also counts as a
live dp group for `DataParallel` and `SyncBatchNorm`.
"""
import math
import os
import threading

import torch
import torch.distributed as dist

__all__ = ["HYBRID_AXES", "new_mesh", "ParallelEnv", "axis_context",
           "axis_index", "axis_size", "build_mesh", "current_axis_name",
           "get_mesh", "get_rank", "get_world_size", "in_manual_region",
           "init_parallel_env", "is_initialized", "set_mesh",
           "process_group_live", "global_batch", "global_batch_live"]

# canonical hybrid-parallel axis order (reference: fleet/base/topology.py
# [dp, pp, sharding, mp], with sequence parallelism as "sp"); the same as
# `parallel.collectives.AXES`
HYBRID_AXES = ("dp", "pp", "sharding", "sp", "mp")

_state = threading.local()
_global_mesh = None
_initialized = False
_backend = None


def is_initialized():
    return _initialized


def _selected_device(device):
    """The torch.device this process runs on: `device`, else the current
    place's; a CUDA device without an index takes the launcher's
    `FLAGS_selected_devices` (one card a rank)."""
    from ..core.device import place_device, resolve_device, set_device
    if device is None:
        dev = place_device()
    else:
        dev = resolve_device(device)
    sel = os.environ.get("FLAGS_selected_devices")
    if dev.type == "cuda" and sel is not None and device is None:
        dev = resolve_device(f"cuda:{int(sel.split(',')[0])}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        set_device(f"gpu:{dev.index}")
    return dev


def init_parallel_env(backend=None, device=None):
    """paddle.distributed.init_parallel_env (reference:
    python/paddle/distributed/parallel.py:104).

    With `PADDLE_TRAINERS_NUM` > 1, joins the process group at
    `tcp://$PADDLE_MASTER` as rank `PADDLE_TRAINER_ID`, also after a mesh
    was installed (whose ranks are then split over the processes).
    `backend` defaults to "nccl" when this process runs on CUDA and
    "gloo" on the CPU; `get_backend()` reports the one chosen. Installs
    the world mesh `{"dp": world}` (one rank a process) unless a mesh is
    set."""
    global _initialized, _backend
    n_procs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    joined = n_procs == 1 or dist.is_initialized()
    if _initialized and joined and _mesh_spans_group(_global_mesh):
        return ParallelEnv()
    dev = _selected_device(device)
    if not joined:
        master = os.environ.get("PADDLE_MASTER")
        if not master:
            raise RuntimeError(
                f"init_parallel_env: PADDLE_TRAINERS_NUM={n_procs} but no "
                "PADDLE_MASTER address to rendezvous at; start the job "
                "through `python -m paddle_tpu_torch.distributed.launch`, "
                "which sets it")
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{master}",
                                rank=rank, world_size=n_procs, **kw)
        _backend = backend
    elif dist.is_initialized():
        _backend = dist.get_backend()
    mesh = _global_mesh
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        build_mesh({"dp": world}, devices=[dev])
    elif not _mesh_spans_group(mesh):
        # a mesh installed before the group was joined: its ranks split
        # into one block a process, each keeping its device
        if mesh.nproc != 1:
            raise RuntimeError(
                f"init_parallel_env: the installed mesh spans {mesh.nproc} "
                f"processes, the process group {dist.get_world_size()}")
        world, me = dist.get_world_size(), dist.get_rank()
        per = mesh.size // world
        by_slot = sorted(range(mesh.size), key=mesh.slots.__getitem__)
        set_mesh(new_mesh(mesh.dims, [mesh.devices[r] for r in
                                      by_slot[me * per:(me + 1) * per]],
                          world, me, mesh.order))
    _initialized = True
    return ParallelEnv()


def _mesh_spans_group(mesh):
    """True unless `mesh` was built for another number of processes than
    the process group's (or for one, under a group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return mesh is None or mesh.nproc == world


def backend():
    """The process group's backend, or None without one."""
    if dist.is_initialized():
        return _backend or dist.get_backend()
    return None


def process_group_live():
    """True under a `torch.distributed` process group of world > 1."""
    return dist.is_initialized() and dist.get_world_size() > 1


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    if dist.is_initialized():
        return dist.get_world_size()
    if _global_mesh is not None:
        return _global_mesh.size
    return 1


def get_rank(group=None):
    if group is not None:
        return group.rank
    if dist.is_initialized():
        return dist.get_rank()
    return 0


def get_mesh():
    return _global_mesh


def set_mesh(mesh):
    global _global_mesh, _initialized
    _global_mesh = mesh
    _initialized = True
    return mesh


def new_mesh(dims, local_devices, nproc=1, proc=0, order=None):
    """The port's mesh: a `RankGrid` over the axes of `dims` (in their
    order) whose ranks are split into blocks of device slots, one block a
    process (`nproc`, `proc`; this process drives `local_ranks`). `order`:
    the axes slowest first over the devices (default the order of
    `dims`), so its first axis is the one whose groups span the processes.
    `local_devices`: one device for the block, or one a rank of it, in
    `local_ranks` order; a remote rank's device is None."""
    size = math.prod(int(v) for v in dims.values())
    if size % nproc:
        raise ValueError(f"mesh {dict(dims)} of {size} ranks does not "
                         f"split over {nproc} processes")
    per = size // nproc
    if len(local_devices) == 1:
        local_devices = list(local_devices) * per
    if len(local_devices) != per:
        raise ValueError(f"{len(local_devices)} devices for this "
                         f"process's {per} ranks")
    from ..parallel.collectives import RankGrid
    grid = RankGrid(dict(dims), [None] * size, axes=tuple(dims),
                    nproc=nproc, proc=proc, order=order)
    for r, d in zip(grid.local_ranks, local_devices):
        grid.devices[r] = d
    return grid


def build_mesh(axis_dims, axis_names=None, devices=None, order=None):
    """Create and install the global mesh; axis_dims like
    {'dp': 2, 'mp': 2}. `devices`: this process's ranks' devices (one for
    all of them, or one a rank; default the current place's device).
    Under a process group the ranks split into one block a process, over
    `order` (see `new_mesh`)."""
    if isinstance(axis_dims, dict):
        dims = {str(k): int(v) for k, v in axis_dims.items()}
    else:
        dims = dict(zip(axis_names, (int(d) for d in axis_dims)))
    if devices is None:
        from ..core.device import place_device
        devices = [place_device()]
    devices = [torch.device(d) for d in devices]
    nproc, proc = (dist.get_world_size(), dist.get_rank()) \
        if dist.is_initialized() else (1, 0)
    return set_mesh(new_mesh(dims, devices, nproc, proc, order))


class ParallelEnv:
    """Reference: python/paddle/fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        sel = os.environ.get("FLAGS_selected_devices")
        return int(sel.split(",")[0]) if sel else 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def nranks(self):
        return get_world_size()

    @property
    def local_rank(self):
        return get_rank()


# ---------------------------------------------------------------------------
# Live-axis tracking: which axes a manual region drives
# ---------------------------------------------------------------------------

def _live_axes():
    if not hasattr(_state, "axes"):
        _state.axes = {}
    return _state.axes


class axis_context:
    """Marks mesh axes as live for the duration: the code inside drives
    the ranks of a manual region, one value a local rank, and the
    collectives of `collective.py` run over the live axis."""

    def __init__(self, **kind_to_axis):
        self.mapping = kind_to_axis

    def __enter__(self):
        axes = _live_axes()
        self._saved = dict(axes)
        axes.update(self.mapping)
        return self

    def __exit__(self, *exc):
        _state.axes = self._saved
        return False


def current_axis_name(kind):
    """The live mesh-axis name for a parallelism kind ('dp', 'mp', 'pp',
    'sharding', 'sep', 'ep', 'world'), or None outside a manual
    region."""
    return _live_axes().get(kind)


def in_manual_region():
    """True while any mesh axis is live."""
    return bool(_live_axes())


def axis_index(axis_name):
    """This process's ranks' coordinates on `axis_name`, in local rank
    order (the reference's `lax.axis_index`, one value a rank)."""
    mesh = get_mesh()
    if mesh is None:
        raise RuntimeError("axis_index: no mesh is set (build_mesh)")
    return [mesh.coords[r][axis_name] for r in mesh.local_ranks]


def axis_size(mesh_or_name, name=None):
    if isinstance(mesh_or_name, str):
        mesh = get_mesh()
        return mesh.dims[mesh_or_name] if mesh is not None else 1
    return mesh_or_name.dims[name]


# ---------------------------------------------------------------------------
# The global-batch scope of `Model`'s dp route
# ---------------------------------------------------------------------------

class global_batch:
    """While open, every training BatchNorm reduces its statistics over
    the process group (each process holds its rank's rows of one global
    batch): `Model`'s dp route, the reference's GSPMD program over the
    whole batch."""

    def __enter__(self):
        self._saved = getattr(_state, "global_batch", False)
        _state.global_batch = True
        return self

    def __exit__(self, *exc):
        _state.global_batch = self._saved
        return False


def global_batch_live():
    return getattr(_state, "global_batch", False) and process_group_live()
