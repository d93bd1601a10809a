"""Collective communication (counterpart of
`paddle_tpu/distributed/collective.py`).

The reference has two contexts: inside a manual region (shard_map) a
collective is a `lax` op over the live axis, and eagerly it runs a tiny
compiled program over the mesh, or, with several processes, over a world
mesh of every process's devices. The port has four, chosen per call:

1. Across processes (the world group, eagerly, under a process group):
   `torch.distributed` calls, one value a process.
   * gloo has no AVG, so AVG is SUM then a divide (for both backends);
     floats narrower than f32 are summed in f32 and cast back.
   * Integer SUM / AVG and every PROD gather the processes' values and
     reduce them in process order, so they are exact (the reference's
     gather path); AVG of integers returns f32, as the reference's does.
   * Under gloo a CUDA tensor is staged through the host (gloo's own
     all-reduce and broadcast do the same).
   * `barrier()` is `torch.distributed.barrier()`, a real rendezvous.
   The reference moves only all_reduce, broadcast and barrier across
   processes; the port also moves all_gather and reduce_scatter (ROADMAP
   C.21). Its other collectives keep the single participant's identity
   there, as the reference's do.
2. Inside a one-controller manual region (`env.axis_context(dp="dp")`):
   the value is a list with one Tensor a local rank of the mesh
   (`mesh.local_ranks`), and the collective applies the list collectives
   of `parallel/collectives.py` to each group of the live axis
   (`RankGrid.over`). A group that spans this process's ranks and other
   processes' runs over the `torch.distributed` group of the processes it
   spans (the world, or a subgroup made once:
   `parallel.collectives.process_group_of`): a floating SUM / AVG and a
   SUM reduce_scatter as each process's partial sum and one all-reduce
   (reduce-scatter) of them, the rest by gathering the members and
   running the collective on the whole group in every member process,
   bit for bit as one controller's.
3. Eagerly over an axis of a one-process mesh (an explicit axis group,
   no live axis): as the reference's `_eager_axis_op`, the value is taken
   as replicated over the axis, so SUM over `dp`=8 gives 8·x, MAX / MIN /
   AVG give x, PROD x**8, broadcast x. The reference's other collectives
   raise there (an unbound axis name), and so do the port's. On a mesh
   split over processes with one rank of the axis group a process (the
   groups of fleet's `HybridCommunicateGroup` across processes),
   `all_reduce` and `broadcast` run over the group's processes
   (`Group.process_group`).
4. Outside all three, the single participant's identity, as in the
   reference.

Every collective is a `comm.<kind>` span of type Communication in the
port's profiler, carrying `collective`, `payload_bytes` (over the Tensor
arguments) and `group_size`, while the profiler records.
"""
import functools

import torch
import torch.distributed as dist

from ..core.tensor import Tensor, _wrap
from ..parallel import collectives as C
from ..profiler import _tracer as _TRACER
from . import env

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_concat", "reduce_scatter", "broadcast",
           "reduce", "scatter", "alltoall", "alltoall_single", "send", "recv",
           "p2p_shift", "barrier", "is_initialized", "get_backend",
           "destroy_process_group", "wait", "stream_sync",
           "all_reduce_mean_"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


class Group:
    """A communication group: one mesh axis, the whole world, or the full
    list of world ranks.

    The port counts ranks where the reference counts devices: the world
    group's size is `env.get_world_size()` (the process group's size, or
    an installed one-process mesh's); an axis group's is the mesh's size
    on that axis."""

    def __init__(self, axis_name=None, mesh=None, id=0, ranks=None):
        self.axis_name = axis_name
        self._mesh = mesh
        self.id = id
        self._ranks = list(ranks) if ranks is not None else None

    @property
    def mesh(self):
        return self._mesh if self._mesh is not None else env.get_mesh()

    @property
    def nranks(self):
        if self._ranks is not None:
            return len(self._ranks)
        if self.axis_name is None:
            return env.get_world_size()
        if self.mesh is None:
            return 1
        return int(self.mesh.dims[self.axis_name])

    @property
    def rank(self):
        """This process's rank in the group (-1 when not a member); on an
        axis, the coordinate of this process's first rank."""
        me = env.get_rank()
        if self._ranks is not None:
            return self._ranks.index(me) if me in self._ranks else -1
        if self.axis_name is None or self.mesh is None:
            return me
        mesh = self.mesh
        return int(mesh.coords[mesh.local_ranks[0]][self.axis_name])

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        if self._ranks is not None:
            return self._ranks.index(rank) if rank in self._ranks else -1
        return rank

    def _procs(self):
        """The processes holding this process's group of the axis, one
        entry a member in rank order; None without a process group."""
        mesh = self.mesh
        if not dist.is_initialized() or mesh is None or \
                self.axis_name is None:
            return None
        g = mesh.whole_groups(mesh.local_ranks[:1], (self.axis_name,))[0]
        return [mesh.process_of(r) for r in g]

    @property
    def process_group(self):
        """The `torch.distributed` group of the processes that hold this
        process's group of the axis (None for the world, or without a
        process group), made once."""
        procs = self._procs()
        return None if procs is None else C.process_group_of(procs)

    def spans_processes(self):
        """True when this axis group's ranks lie one a process, in more
        than one process: its eager collectives run across them."""
        procs = self._procs()
        return procs is not None and len(procs) > 1 and \
            len(set(procs)) == len(procs)

    @property
    def process_ids(self):
        if self._ranks is not None:
            return list(self._ranks)
        return list(range(self.nranks))


_WORLD = None
_group_counter = 0


def _world_group():
    global _WORLD
    if _WORLD is None:
        _WORLD = Group(axis_name=None)
    return _WORLD


def new_group(ranks=None, backend=None, axis_name=None, timeout=None):
    """A communication group (reference: collective.py:353 new_group).
    `ranks` naming the whole world gives the world group; a proper subset
    raises, as in the reference. Pass `axis_name` to group along a mesh
    axis."""
    global _group_counter
    _group_counter += 1
    if ranks is not None and axis_name is None:
        world = env.get_world_size()
        r = sorted(int(x) for x in ranks)
        if r == list(range(world)):
            return Group(axis_name=None, id=_group_counter, ranks=r)
        raise NotImplementedError(
            f"new_group(ranks={list(ranks)}): arbitrary rank subsets are not "
            "mesh axes; build a mesh whose axis matches the desired group "
            "(distributed.env.build_mesh) and pass axis_name=<axis>")
    return Group(axis_name=axis_name, id=_group_counter, ranks=ranks)


def get_group(gid=0):
    return _world_group()


def _axis_of(group, default_kind="dp"):
    """The axis a collective runs over: the group's axis, else the live
    axis of the default kind, else None (single participant)."""
    if group is not None and group.axis_name is not None:
        return group.axis_name
    live = env.current_axis_name(default_kind)
    if live is not None:
        return live
    if group is None:
        return env.current_axis_name("world")
    return None


def _traced_collective(fn):
    """A Communication span per call while the port's profiler records:
    the kind, the bytes of every Tensor argument, the group's size."""
    kind = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _TRACER.enabled:
            return fn(*args, **kwargs)
        group = kwargs.get("group")
        if group is None:
            group = next((a for a in args if isinstance(a, Group)), None)
        nbytes = 0
        for a in args:
            items = a if isinstance(a, (list, tuple)) else (a,)
            for t in items:
                if isinstance(t, Tensor):
                    nbytes += t._data.numel() * t._data.element_size()
        gsz = group.nranks if group is not None else env.get_world_size()
        rec = _TRACER.begin(f"comm.{kind}", "Communication",
                            {"collective": kind, "payload_bytes": nbytes,
                             "group_size": gsz})
        try:
            return fn(*args, **kwargs)
        finally:
            _TRACER.end(rec)
    return wrapper


# ---------------------------------------------------------------------------
# 1. Across processes: torch.distributed, one value a process
# ---------------------------------------------------------------------------

def _cross_process(group):
    """True when an eager call runs over the world's processes: a process
    group is initialized (of any size: a one-rank group still runs its
    backend), no axis is live, and the group is the world."""
    return (dist.is_initialized() and not env.in_manual_region()
            and (group is None or group.axis_name is None))


def _axis_across(group):
    """True for an eager call on an axis group whose ranks lie one a
    process over several processes (no axis live)."""
    return (group is not None and not env.in_manual_region()
            and group.spans_processes())


def _comm(x):
    """`x` as the process group takes it: contiguous, on the host under
    gloo."""
    x = x.contiguous()
    if x.is_cuda and env.backend() == "gloo":
        return x.cpu()
    return x


def _world_gather(x, pg=None):
    """Every process's `x` (of the group `pg`, default the world), in
    process order, on `x`'s device."""
    c = _comm(x)
    parts = [torch.empty_like(c) for _ in range(dist.get_world_size(pg))]
    dist.all_gather(parts, c, group=pg)
    return [p.to(x.device) for p in parts]


_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN}


def _reduce_stack(st, op, dtype):
    """Reduce a stack of values over dim 0 exactly, in stack order."""
    if op == ReduceOp.AVG:
        return st.to(torch.float32).mean(0)
    if op == ReduceOp.SUM:
        return st.sum(0).to(dtype)
    if op == ReduceOp.PROD:
        return st.prod(0).to(dtype)
    if op == ReduceOp.MAX:
        return st.amax(0)
    return st.amin(0)


def _world_reduce(x, op, pg=None):
    """Reduce torch tensor `x` over the world's processes (or those of
    the group `pg`)."""
    if op == ReduceOp.PROD or (op in (ReduceOp.SUM, ReduceOp.AVG)
                               and not x.is_floating_point()):
        return _reduce_stack(torch.stack(_world_gather(x, pg)), op, x.dtype)
    wide = x.is_floating_point() and x.element_size() < 4 \
        and op in (ReduceOp.SUM, ReduceOp.AVG)
    y = _comm(x.float() if wide else x)
    if y is x:
        y = x.clone()
    dist.all_reduce(y, _DIST_OP[op], group=pg)
    if op == ReduceOp.AVG:
        y = y / dist.get_world_size(pg)
    return y.to(x.device, x.dtype)


def _world_broadcast(x, src, pg=None):
    """`x` of the process with group rank `src` of `pg` (the world)."""
    y = _comm(x)
    if y is x:
        y = x.clone()
    dist.broadcast(y, src if pg is None else dist.get_global_rank(pg, src),
                   group=pg)
    return y.to(x.device)


class _WorldSum(torch.autograd.Function):
    """All-reduce SUM across processes whose backward all-reduces the
    cotangent (psum's transpose is a psum): each process's loss is a
    distinct part of the global loss."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _world_reduce(x, ReduceOp.SUM, pg)

    @staticmethod
    def backward(ctx, g):
        return _world_reduce(g, ReduceOp.SUM, ctx.pg), None


def world_sum(x, pg=None):
    """Differentiable SUM of torch tensor `x` over the processes (of the
    group `pg`, default the world)."""
    return _WorldSum.apply(x, pg)


def all_reduce_mean_(tensors, pg=None):
    """Average torch tensors in place over the processes (of `pg`, default
    the world) with one all-reduce of their f32 concatenation (the
    gradient all-reduce of `DataParallel`, `HybridParallelOptimizer` and
    `Model`'s dp route)."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = _world_reduce(flat, ReduceOp.AVG, pg)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view(t.shape))
        i += n
    return tensors


# ---------------------------------------------------------------------------
# 2. Manual regions: one value a local rank, list collectives over the axis
# ---------------------------------------------------------------------------

def _region_mesh():
    mesh = env.get_mesh()
    if mesh is None:
        raise RuntimeError("a manual region needs a mesh (build_mesh)")
    return mesh


def _raw_list(xs):
    return [x._data if isinstance(x, Tensor) else x for x in xs]


def _region_apply(xs, axis, fn, mesh=None):
    """Apply the one-controller group collective `fn` (a list of torch
    tensors, one a group member in rank order -> the same) to every group
    of `axis` (`RankGrid.over`; a group spanning processes gathers its
    members first). `mesh` defaults to the installed one."""
    mesh = mesh or _region_mesh()
    return mesh.over(mesh.local_ranks, axis, fn, _raw_list(xs))


def region_reduce(xs, axis, op, mesh=None):
    """all_reduce over `axis` (an axis name or a tuple of them) in a
    manual region: each group reduced in rank order (SUM / AVG in f32),
    across processes too (floating SUM / AVG there as partial sums and
    one all-reduce: `RankGrid.over`). `xs`: one value a rank of
    `mesh.local_ranks`; `mesh` defaults to the installed one."""
    fn = functools.partial(_list_reduce, op=op)
    raw = _raw_list(xs)
    if raw and all(torch.is_tensor(x) and x.is_floating_point()
                   for x in raw):
        fn = {ReduceOp.SUM: C.psum, ReduceOp.AVG: C.pmean}.get(op, fn)
    return _region_apply(xs, axis, fn, mesh)


def _list_reduce(xs, op):
    """A group's reduction on one controller: SUM / AVG through
    `parallel.collectives` (f32, rank order), the rest in rank order."""
    if op == ReduceOp.SUM:
        return C.psum(xs)
    if op == ReduceOp.AVG:
        if not xs[0].is_floating_point():
            m = torch.stack([x.to(torch.float32) for x in xs]).mean(0)
            return [m.to(x.device, copy=True) for x in xs]
        return C.pmean(xs)
    if op == ReduceOp.MAX:
        return C.pmax(xs)
    dev = xs[0].device
    st = torch.stack([x.to(dev) for x in xs])
    r = _reduce_stack(st, op, xs[0].dtype)
    return [r.to(x.device, copy=True) for x in xs]


def _rebind_all(ts, vals):
    for t, v in zip(ts, vals):
        t._data = v
    return ts


def _is_region_value(x):
    return env.in_manual_region() and isinstance(x, (list, tuple))


# ---------------------------------------------------------------------------
# 3. Eagerly over a one-process mesh axis: the value is replicated
# ---------------------------------------------------------------------------

def _eager_axis_size(axis):
    mesh = env.get_mesh()
    if mesh is None or axis not in mesh.dims:
        return None
    if mesh.nproc > 1:
        raise NotImplementedError(
            f"an eager collective over mesh axis {axis!r} of a mesh split "
            "over processes: call it inside a manual region "
            "(env.axis_context), or on the world group")
    return mesh.dims[axis]


def _unbound(axis):
    return NameError(f"unbound axis name: {axis} (this collective runs "
                     "inside a manual region, env.axis_context)")


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------

@_traced_collective
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    if _is_region_value(tensor):
        axis = _axis_of(group)
        if axis is None:
            return tensor
        return _rebind_all(tensor, region_reduce(tensor, axis, op))
    if _cross_process(group):
        tensor._data = _world_reduce(tensor._data, op)
        return tensor
    if _axis_across(group):
        tensor._data = _world_reduce(tensor._data, op, group.process_group)
        return tensor
    axis = _axis_of(group)
    n = None if axis is None else _eager_axis_size(axis)
    if n is None:
        return tensor
    d = tensor._data
    if op == ReduceOp.SUM:
        tensor._data = d * n
    elif op == ReduceOp.PROD:
        tensor._data = d.expand((n,) + tuple(d.shape)).prod(0).to(d.dtype)
    elif op == ReduceOp.AVG and not d.is_floating_point():
        tensor._data = d.to(torch.float32)
    return tensor


@_traced_collective
def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    if _is_region_value(tensor):
        ax = _axis_of(group)
        if ax is None:
            out = [t.clone() for t in tensor]
        else:
            out = [_wrap(v) for v in _region_apply(
                tensor, ax, lambda xs: C.all_gather(
                    [x.unsqueeze(0) for x in xs], 0))]
        if isinstance(tensor_list, list):
            n = out[0].shape[0]
            for i in range(n):
                tensor_list.append([o[i] for o in out])
            return tensor_list
        return out
    if _cross_process(group):
        parts = [_wrap(p) for p in _world_gather(tensor._data)]
        if isinstance(tensor_list, list):
            tensor_list.extend(parts)
            return tensor_list
        return _wrap(torch.stack([p._data for p in parts]))
    ax = _axis_of(group)
    if ax is None:
        if isinstance(tensor_list, list):
            tensor_list.append(tensor.clone())
            return tensor_list
        return tensor
    raise _unbound(ax)


@_traced_collective
def all_gather_concat(tensor, group=None, concat_axis=0):
    """Gather shards and concat along concat_axis (TP activation gather)."""
    if _is_region_value(tensor):
        ax = _axis_of(group, "mp")
        if ax is None:
            return tensor
        return [_wrap(v) for v in _region_apply(
            tensor, ax, lambda xs: C.all_gather(xs, concat_axis))]
    ax = _axis_of(group, "mp")
    if ax is None:
        return tensor
    raise _unbound(ax)


def _chunk_of(full, n, i):
    if full.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({full.shape[0]}) not "
                         f"divisible by group size {n}")
    per = full.shape[0] // n
    return full[i * per:(i + 1) * per]


@_traced_collective
def reduce_scatter(tensor, tensor_or_tensor_list=None, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    src = tensor_or_tensor_list if tensor_or_tensor_list is not None \
        else tensor
    if _is_region_value(tensor):
        ax = _axis_of(group, "sharding")
        if ax is None:
            return [_wrap(v) for v in _raw_list(src)]

        def fn(xs):
            full = _list_reduce(xs, op)
            return [_chunk_of(f, len(xs), i) for i, f in enumerate(full)]
        if op == ReduceOp.SUM:
            fn = functools.partial(C.psum_scatter, dim=0)
        return [_wrap(v) for v in _region_apply(src, ax, fn)]
    if isinstance(src, (list, tuple)):
        src = _wrap(torch.cat([s._data for s in src], 0))
    if _cross_process(group):
        full = _world_reduce(src._data, op)
        return _wrap(_chunk_of(full, dist.get_world_size(),
                               dist.get_rank()).clone())
    ax = _axis_of(group, "sharding")
    if ax is None:
        return src
    raise _unbound(ax)


@_traced_collective
def broadcast(tensor, src=0, group=None, sync_op=True):
    if _is_region_value(tensor):
        ax = _axis_of(group)
        if ax is None:
            return tensor
        return _rebind_all(tensor, _region_apply(
            tensor, ax, lambda xs: [xs[src].to(x.device, copy=True)
                                    for x in xs]))
    if _cross_process(group):
        tensor._data = _world_broadcast(tensor._data, src)
        return tensor
    if _axis_across(group):
        tensor._data = _world_broadcast(tensor._data, src,
                                        group.process_group)
        return tensor
    ax = _axis_of(group)
    if ax is not None:
        _eager_axis_size(ax)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """On a mesh, reduce == all_reduce (the result is defined on every
    participant), as in the reference."""
    return all_reduce(tensor, op, group, sync_op)


@_traced_collective
def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    if _is_region_value(tensor):
        ax = _axis_of(group)
        if ax is None or tensor_list is None:
            return tensor
        mesh = _region_mesh()
        vals = []
        for j, r in enumerate(mesh.local_ranks):
            i = mesh.coords[r][ax]
            v = tensor_list[i]
            v = v[j] if isinstance(v, (list, tuple)) else v
            vals.append(_raw_list([v])[0].clone())
        return _rebind_all(tensor, vals)
    ax = _axis_of(group)
    if ax is None or tensor_list is None:
        return tensor
    raise _unbound(ax)


@_traced_collective
def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    region = _is_region_value(in_tensor_list) and in_tensor_list \
        and isinstance(in_tensor_list[0], (list, tuple))
    if region:
        # in_tensor_list: n entries, each one value a local rank
        xs = [torch.stack(_raw_list(col)) for col in zip(*in_tensor_list)]
        ax = _axis_of(group, "ep")
        if ax is not None:
            xs = _region_apply(xs, ax, lambda v: C.all_to_all(v, 0, 0))
        out = [_wrap(x) for x in xs]
        if isinstance(out_tensor_list, list):
            for i in range(out[0].shape[0]):
                out_tensor_list.append([o[i] for o in out])
            return out_tensor_list
        return out
    if isinstance(in_tensor_list, (list, tuple)):
        x = torch.stack([t._data for t in in_tensor_list])
    else:
        x = in_tensor_list._data
    ax = _axis_of(group, "ep")
    if ax is not None:
        raise _unbound(ax)
    out = _wrap(x)
    if isinstance(out_tensor_list, list):
        for i in range(x.shape[0]):
            out_tensor_list.append(out[i])
        return out_tensor_list
    return out


@_traced_collective
def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    if _is_region_value(in_tensor):
        ax = _axis_of(group, "ep")
        if ax is None:
            return in_tensor
        return [_wrap(v) for v in _region_apply(
            in_tensor, ax, lambda xs: C.all_to_all(xs, 0, 0))]
    ax = _axis_of(group, "ep")
    if ax is None:
        return in_tensor
    raise _unbound(ax)


def _region_permute(xs, ax, pairs):
    """ppermute over `ax` with explicit (source, destination) pairs; as
    in `lax.ppermute`, no two pairs share a source or a destination."""
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute pairs {pairs} repeat a source or a "
                         "destination")

    def fn(v):
        out = [torch.zeros_like(x) for x in v]
        for s, d in pairs:
            out[d] = v[s].to(v[d].device, copy=True)
        return out
    return _region_apply(xs, ax, fn)


@_traced_collective
def send(tensor, dst=0, group=None, sync_op=True):
    """P2P send: in a manual region, the reference's collective_permute
    of every rank to `dst` along the live 'pp' axis."""
    if _is_region_value(tensor):
        ax = _axis_of(group, "pp")
        if ax is None:
            return tensor
        n = env.axis_size(ax)
        return [_wrap(v) for v in _region_permute(
            tensor, ax, [(i, dst) for i in range(n)])]
    ax = _axis_of(group, "pp")
    if ax is None:
        return tensor
    raise _unbound(ax)


@_traced_collective
def recv(tensor, src=0, group=None, sync_op=True):
    if _is_region_value(tensor):
        ax = _axis_of(group, "pp")
        if ax is None:
            return tensor
        n = env.axis_size(ax)
        return _rebind_all(tensor, _region_permute(
            tensor, ax, [(src, i) for i in range(n)]))
    ax = _axis_of(group, "pp")
    if ax is None:
        return tensor
    raise _unbound(ax)


@_traced_collective
def p2p_shift(tensor, shift=1, group=None):
    """Ring shift along the live pp/sp axis (ring attention, 1F1B p2p)."""
    if _is_region_value(tensor):
        ax = _axis_of(group, "pp") or _axis_of(group, "sp")
        if ax is None:
            return tensor
        return [_wrap(v) for v in _region_apply(
            tensor, ax, lambda xs: C.ppermute(xs, shift))]
    ax = _axis_of(group, "pp") or _axis_of(group, "sp")
    if ax is None:
        return tensor
    raise _unbound(ax)


@_traced_collective
def barrier(group=None):
    """Synchronize. Across processes, `torch.distributed.barrier()`;
    otherwise drain the work queued on this process's devices. Inside a
    manual region it raises, as in the reference: a barrier there has no
    effect on the ranks' lockstep order."""
    if env.in_manual_region():
        raise RuntimeError(
            "barrier() inside a manual region has no effect: order "
            "collectives by data dependency instead")
    if _cross_process(group):
        if env.backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
        return
    mesh = env.get_mesh()
    devs = {mesh.devices[r] for r in mesh.local_ranks} if mesh else set()
    for d in devs:
        if d is not None and d.type == "cuda":
            torch.cuda.synchronize(d)


def is_initialized():
    return env.is_initialized()


def get_backend(group=None):
    """The process group's backend ("gloo" / "nccl"); "local" without
    one (the reference reports "xla")."""
    return env.backend() or "local"


def destroy_process_group(group=None):
    if dist.is_initialized():
        dist.destroy_process_group()


def wait(tensor, group=None, use_calc_stream=True):
    d = tensor._data if isinstance(tensor, Tensor) else tensor
    if isinstance(d, torch.Tensor) and d.is_cuda:
        torch.cuda.synchronize(d.device)


def stream_sync():
    pass
