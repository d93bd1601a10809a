"""The pipeline runner for any `PipelineLayer` (counterpart of
`paddle_tpu/distributed/fleet/meta_parallel/pp_compiled.py`; reference:
fleet/meta_parallel/pipeline_parallel.py, 1F1B over per-stage processes
with send_v2 / recv_v2).

The reference compiles the whole pipeline into one shard_map program
over the mesh's pp axis. The port runs the same schedule with one
controller, eagerly, over the same tick tables
(`parallel/pipeline_schedule.py` `build_tables` / `arrival_tables` /
`required_slots`, as `gpt_spmd`'s pipeline does):

  * each tick a stage runs at most one microbatch forward and one
    backward of its segment, on its rank's device (the first rank of the
    mesh with that pp coordinate); activations and cotangents hop to the
    next / previous stage at the tick's end and are parked, the tick they
    arrive, in circular buffers of `required_slots` entries;
  * a forward runs without autograd and parks the buffer values it ran
    with; the backward recomputes the stage's forward from its parked
    input (stage-granular rematerialization) and pulls the parked
    cotangent back with `torch.autograd.grad`. The last stage's only
    forward runs inside its backward, from the loss;
  * a parameter used by one stage lives on that stage's device; one used
    by two stages (a `SharedLayerDesc`) gets both stages' gradients
    summed, as `allreduce_shared_weight_gradients` does; gradients are
    accumulated in f32 and divided by the microbatch count;
  * buffers (BatchNorm's running statistics) update once a microbatch, in
    schedule order, each stage's its own (a buffer on a layer that two
    stages share is refused, as in the reference);
  * with mp > 1 every stage body runs under `env.axis_context(mp="mp")`,
    so fleet's mp layers compute their ranks' pieces with the list
    collectives (`mp_layers.py`); with dp > 1 the microbatch m is the
    union of each dp shard's m-th slice (the batch splits over dp first),
    computed as one batch: one controller gains nothing from splitting it
    (ROADMAP C.22), and every BatchNorm sees the statistics the
    reference's SyncBatchNorm syncs.

Across processes (a mesh split over processes with its pp axis first in
the order, so each stage's ranks lie in one process), each process runs
the ticks of its own stages. An activation or cotangent whose next stage
lives in another process goes by `torch.distributed` send / recv at the
tick's end (an activation after a header with its shape and dtype); the
loss is broadcast from the last stage's process; a shared parameter's
gradient is summed over the processes whose stages use it, and each
stage's buffers are written back by the process that runs it. A
parameter no local stage uses gets no gradient. Shared gradients are
accumulated a stage at a time and the stages' sums added in stage order,
in one process as across processes, so both give the same bits for a
parameter two stages share.
"""
from contextlib import nullcontext

import torch
import torch.distributed as dist

from ....core.tensor import _wrap
from ....nn.layer.layers import Layer, functional_call
from ....parallel import collectives as C
from ....parallel.pipeline_schedule import (arrival_tables, build_tables,
                                            required_slots)
from ... import env

__all__ = ["make_compiled_pipeline_step"]

_HEAD = 10                   # ndim, dtype code, up to 8 dimensions
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool)


def _header(y):
    if y.dim() > _HEAD - 2:
        raise ValueError(f"a stage output of {y.dim()} dims is more than "
                         f"the pipeline's hop header carries")
    h = [y.dim(), _DTYPES.index(y.dtype)] + list(y.shape)
    return torch.tensor(h + [0] * (_HEAD - len(h)), dtype=torch.int64)


def _unheader(h):
    h = h.tolist()
    return tuple(h[2:2 + h[0]]), _DTYPES[h[1]]


def _param_ownership(pl, pp):
    """(owned, shared, used): owned[s] the names only stage s uses;
    shared the names two or more stages use, or none (a parameter held
    outside every stage); used[s] every name stage s uses."""
    name_of = {id(p): n for n, p in pl.named_parameters()}
    stages_of = {}
    for i, (layer, _) in enumerate(pl._built):
        if isinstance(layer, Layer):
            s = pl.stage_of_layer(i)
            for p in layer.parameters():
                stages_of.setdefault(name_of[id(p)], set()).add(s)
    owned = {s: sorted(n for n, ss in stages_of.items() if ss == {s})
             for s in range(pp)}
    shared = sorted(n for n, _ in pl.named_parameters()
                    if len(stages_of.get(n, ())) != 1)
    used = {s: sorted(n for n, ss in stages_of.items() if s in ss)
            for s in range(pp)}
    return owned, shared, used


def _stage_buffers(pl, pp):
    """{stage: buffer names of its layers}; raises for a buffer that two
    stages reach."""
    name_of = {id(b): n for n, b in pl.named_buffers()}
    stages_of = {}
    for i, (layer, _) in enumerate(pl._built):
        if isinstance(layer, Layer):
            for b in layer.buffers():
                n = name_of.get(id(b))
                if n is not None:
                    stages_of.setdefault(n, set()).add(pl.stage_of_layer(i))
    bad = sorted(n for n, ss in stages_of.items() if len(ss) > 1)
    if bad:
        raise ValueError(
            f"buffers on layers shared across pipeline stages are not "
            f"supported in the compiled step (their per-stage updates "
            f"cannot be merged): {bad}")
    return {s: sorted(n for n, ss in stages_of.items() if ss == {s})
            for s in range(pp)}


def make_compiled_pipeline_step(pl, mesh, microbatches, schedule="1f1b"):
    """step(params, buffers, x, y) -> (loss, grads, new_buffers) over
    `mesh` (its pp axis of size `pl.get_num_stages()`; dp and mp axes
    compose), the arguments and results raw torch tensors keyed as
    `functional_state(pl)`: the mean loss over the microbatches, every
    parameter's gradient (None for one no stage reaches) and the updated
    buffers. `step.stats` holds the last step's schedule record."""
    pp = int(mesh.dims.get("pp", 1))
    mp = int(mesh.dims.get("mp", 1))
    dp = int(mesh.dims.get("dp", 1))
    M = int(microbatches)
    if pp < 2:
        raise ValueError("compiled pipeline needs pp >= 2")
    if pl._loss_fn is None:
        raise ValueError("PipelineLayer needs loss_fn for the compiled step")
    if pl.get_num_stages() != pp:
        raise ValueError(f"the PipelineLayer has {pl.get_num_stages()} "
                         f"stages, the mesh's pp axis {pp}")
    owner = []
    for s in range(pp):
        procs = {mesh.process_of(r) for r in mesh.ranks_where(pp=s)}
        if len(procs) != 1:
            raise ValueError(
                f"pipeline stage {s}'s ranks lie in processes "
                f"{sorted(procs)}: build the mesh with order=('pp',) so "
                "each stage lies in one process")
        owner.append(procs.pop())
    mine = [s for s in range(pp) if owner[s] == mesh.proc]
    if schedule not in ("1f1b", "eager1f1b", "gpipe"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         "expected 1f1b | eager1f1b | gpipe")
    stage_bufs = _stage_buffers(pl, pp)
    owned, shared, used = _param_ownership(pl, pp)
    named = dict(pl.named_parameters())
    split = [n for n, p in named.items()
             if mp > 1 and getattr(p, "is_distributed", False)
             and getattr(p, "split_axis", None) is not None]
    for n in split:
        p = named[n]
        if p.shape[p.split_axis] % mp:
            raise ValueError(f"param {n}: dim {p.split_axis} of "
                             f"{tuple(p.shape)} is not divisible by mp={mp}")
    bad = sorted(set(split) & set(shared))
    if bad:
        raise ValueError(
            f"mp-distributed params shared across pipeline stages are not "
            f"supported in the compiled mp x pp path: {bad}")
    devs = [mesh.devices[mesh.ranks_where(pp=s)[0]] for s in range(pp)]
    # a shared parameter: the processes whose stages use it
    shared_procs = {n: sorted({owner[s] for s in range(pp)
                               if n in used[s]}) for n in shared}
    f_t, b_t, _ = build_tables(M, pp, schedule)
    ftbl, btbl = f_t[:, :, None], b_t[:, :, None]
    farr, garr = arrival_tables(ftbl, btbl, pp, 1)
    W = required_slots(ftbl, btbl, farr, garr, M, pp, 1)
    T = ftbl.shape[0]
    bounds = pl._boundaries
    shapes = {n: (tuple(p.shape), p._data.element_size())
              for n, p in named.items()}

    def nbytes(names):
        return sum(torch.Size(shapes[n][0]).numel() * shapes[n][1]
                   for n in names)

    def stage_call(s, params, bufs, x):
        ctx = env.axis_context(mp="mp") if mp > 1 else nullcontext()
        with ctx:
            out, nb = functional_call(
                pl, params, bufs, args=(_wrap(x),), train=True,
                method=lambda layer, h: layer.run_segment(
                    bounds[s], bounds[s + 1], h))
        return out._data, nb

    def loss_of(out, y):
        return pl._loss_fn(_wrap(out), _wrap(y))._data.float()

    def micro(t):
        """(M, union of each dp shard's m-th slice, ...)."""
        B = t.shape[0]
        if B % (dp * M):
            raise ValueError(f"batch {B} does not split over dp={dp} and "
                             f"{M} microbatches")
        return t.reshape((dp, M, B // (dp * M)) + tuple(t.shape[1:])) \
            .transpose(0, 1).reshape((M, B // M) + tuple(t.shape[1:]))

    def step(params, buffers, x, y):
        # another process's stage keeps its parameters where they are
        plain = {n: p.detach() for n, p in params.items()}
        for s in mine:
            for n in owned[s]:
                plain[n] = params[n].detach().to(devs[s])
        bufs = dict(buffers)
        x_mb = micro(x.to(devs[0])) if 0 in mine else None
        y_mb = micro(y.to(devs[pp - 1])) if pp - 1 in mine else None
        acc = {}                 # name (and stage, if shared) -> f32 sum
        losses = []                                 # the last stage's
        buf = [[None] * W for _ in range(pp)]       # parked inputs
        gbuf = [[None] * W for _ in range(pp)]      # parked cotangents
        snap = [[None] * W for _ in range(pp)]      # buffers a forward saw
        out_like = [{} for _ in range(pp)]  # sent outputs' shape, dtype
        fchan, gchan = [None] * pp, [None] * pp
        peak = [0] * pp

        def backward(s, bi):
            xin = x_mb[bi] if s == 0 else buf[s][bi % W]
            leaves = {n: plain[n].to(devs[s]).detach().requires_grad_()
                      for n in used[s]}
            full = dict(plain)
            full.update(leaves)
            xl = xin.detach()
            want_x = s > 0 and xl.is_floating_point()
            if want_x:
                xl.requires_grad_()
            names = list(leaves)
            inputs = [leaves[n] for n in names] + ([xl] if want_x else [])
            with torch.enable_grad():
                if s == pp - 1:
                    out, nb = stage_call(s, full, bufs, xl)
                    loss = loss_of(out, y_mb[bi])
                    got = torch.autograd.grad(loss, inputs, allow_unused=True)
                    for n in stage_bufs[s]:
                        bufs[n] = nb[n].detach()
                    losses.append(loss.detach())
                else:
                    seen = dict(bufs)
                    seen.update(snap[s][bi % W])
                    out, _ = stage_call(s, full, seen, xl)
                    got = torch.autograd.grad(out, inputs,
                                              grad_outputs=gbuf[s][bi % W],
                                              allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    g = g.float()
                    key = (n, s) if n in shared_procs else n
                    acc[key] = g if key not in acc else acc[key] + g.to(
                        acc[key].device)
            buf[s][bi % W] = gbuf[s][bi % W] = snap[s][bi % W] = None
            return got[-1] if want_x else None

        for t in range(T):
            new_y, new_g = [None] * pp, [None] * pp
            for s in mine:
                a_f, a_g = int(farr[t, s, 0]), int(garr[t, s, 0])
                if a_f >= 0:
                    buf[s][a_f % W] = fchan[s]
                if a_g >= 0:
                    gbuf[s][a_g % W] = gchan[s]
                fi, bi = int(ftbl[t, s, 0]), int(btbl[t, s, 0])
                if fi >= 0 and s < pp - 1:
                    xin = x_mb[fi] if s == 0 else buf[s][fi % W]
                    snap[s][fi % W] = {n: bufs[n] for n in stage_bufs[s]}
                    with torch.no_grad():
                        out, nb = stage_call(s, plain, bufs, xin)
                    for n in stage_bufs[s]:
                        bufs[n] = nb[n]
                    new_y[s] = out
                    if owner[s + 1] != mesh.proc and \
                            out.is_floating_point():
                        out_like[s][fi] = (out.shape, out.dtype)
                # microbatches live at the stage: parked, or forwarded and
                # waiting for their backward
                peak[s] = max(peak[s], sum(
                    buf[s][i] is not None or snap[s][i] is not None
                    for i in range(W)))
                if bi >= 0:
                    new_g[s] = backward(s, bi)
            fchan, gchan = [None] * pp, [None] * pp
            for s in range(pp - 1):
                if new_y[s] is not None and owner[s + 1] == mesh.proc:
                    fchan[s + 1] = new_y[s].to(devs[s + 1])
            for s in range(1, pp):
                if new_g[s] is not None and owner[s - 1] == mesh.proc:
                    gchan[s - 1] = new_g[s].to(devs[s - 1])
            if mesh.nproc > 1:
                _exchange(t, new_y, new_g, fchan, gchan, out_like)
        if mesh.nproc > 1:
            loss = torch.zeros((), dtype=torch.float32) if not losses \
                else torch.stack(losses).sum().cpu() / M
            dist.broadcast(loss, owner[pp - 1])
            loss = loss.to(params[next(iter(params))].device)
        else:
            loss = torch.stack(losses).sum() / M
        for n, procs in shared_procs.items():
            # a stage's sum at a time, the stages added in stage order
            parts = [acc.pop((n, s)) for s in range(pp) if (n, s) in acc]
            spans = len(procs) > 1 and mesh.proc in procs
            if not parts:
                if not spans:
                    continue
                # every process of the set joins the all-reduce
                parts = [torch.zeros(params[n].shape, dtype=torch.float32,
                                     device=params[n].device)]
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p.to(tot.device)
            if spans:
                tot = C._dc()._world_reduce(
                    tot, C._dc().ReduceOp.SUM, C.process_group_of(procs))
            acc[n] = tot
        grads = {n: None for n in params}
        for n, g in acc.items():
            grads[n] = (g / M).to(params[n].device, params[n].dtype)
        step.stats = {"schedule": schedule, "ticks": T, "slots": W,
                      "peak_live": peak, "microbatches": M}
        return loss, grads, bufs

    def _exchange(t, new_y, new_g, fchan, gchan, out_like):
        """This tick's hops between processes: stage s's activation to
        stage s + 1 (a header of its shape and dtype code, then the
        values), stage s's cotangent to stage s - 1 (the shape of the
        activation it answers, known there)."""
        size = pp * (M + 1)
        sends, heads = [], []
        for s in range(pp - 1):
            fi = int(ftbl[t, s, 0])
            if fi < 0:
                continue
            if owner[s] == mesh.proc and owner[s + 1] != mesh.proc:
                y = new_y[s]
                sends.append((owner[s + 1], 2 * (s * size + fi) + 1, y))
                heads.append((owner[s + 1], 2 * (s * size + fi),
                              _header(y)))
        recv_heads = [(owner[s], 2 * (s * size + int(ftbl[t, s, 0])),
                       torch.zeros(_HEAD, dtype=torch.int64))
                      for s in range(pp - 1)
                      if int(ftbl[t, s, 0]) >= 0 and
                      owner[s] != mesh.proc and owner[s + 1] == mesh.proc]
        got_heads = C._p2p(heads, recv_heads)
        recvs, into = [], []
        for (proc, tag, _), h in zip(recv_heads, got_heads):
            s = (tag // 2) // size
            shape, dtype = _unheader(h)
            recvs.append((proc, tag + 1, torch.empty(shape, dtype=dtype,
                                                     device=devs[s + 1])))
            into.append(("f", s + 1))
        gtag = 2 * pp * size
        for s in range(1, pp):
            bi = int(btbl[t, s, 0])
            if bi < 0:
                continue
            if owner[s] == mesh.proc and owner[s - 1] != mesh.proc and \
                    new_g[s] is not None:
                sends.append((owner[s - 1], gtag + s * size + bi, new_g[s]))
            elif owner[s] != mesh.proc and owner[s - 1] == mesh.proc and \
                    bi in out_like[s - 1]:
                shape, dtype = out_like[s - 1].pop(bi)
                recvs.append((owner[s], gtag + s * size + bi,
                              torch.empty(shape, dtype=dtype,
                                          device=devs[s - 1])))
                into.append(("g", s - 1))
        for (kind, s), v in zip(into, C._p2p(sends, recvs)):
            if kind == "f":
                fchan[s] = v
            else:
                gchan[s] = v

    step.stats = {}
    step.stage_devices = devs
    step.stage_param_bytes = [nbytes(owned[s]) for s in range(pp)]
    step.packed_bytes_per_device = max(step.stage_param_bytes + [0])
    step.replicated_param_bytes = nbytes(shared)
    return step

