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

The pipeline runs in one process; a mesh split over processes raises
(ROADMAP A.13f(iii)).
"""
from contextlib import nullcontext

import torch

from ....core.tensor import _wrap
from ....nn.layer.layers import Layer, functional_call
from ....parallel.pipeline_schedule import (arrival_tables, build_tables,
                                            required_slots)
from ... import env

__all__ = ["make_compiled_pipeline_step"]


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
    if mesh.nproc > 1:
        raise NotImplementedError(
            "the pipeline runner drives every stage from one process; a "
            f"mesh split over {mesh.nproc} processes comes with ROADMAP "
            "A.13f(iii)")
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
        plain = {}
        for s in range(pp):
            for n in owned[s]:
                plain[n] = params[n].detach().to(devs[s])
        for n in shared:
            plain[n] = params[n].detach()
        bufs = dict(buffers)
        x_mb = micro(x.to(devs[0]))
        y_mb = micro(y.to(devs[pp - 1]))
        acc = {}
        losses = []                                 # the last stage's
        buf = [[None] * W for _ in range(pp)]       # parked inputs
        gbuf = [[None] * W for _ in range(pp)]      # parked cotangents
        snap = [[None] * W for _ in range(pp)]      # buffers a forward saw
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
                    acc[n] = g if n not in acc else acc[n] + g.to(
                        acc[n].device)
            buf[s][bi % W] = gbuf[s][bi % W] = snap[s][bi % W] = None
            return got[-1] if want_x else None

        for t in range(T):
            new_y, new_g = [None] * pp, [None] * pp
            for s in range(pp):
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
                # microbatches live at the stage: parked, or forwarded and
                # waiting for their backward
                peak[s] = max(peak[s], sum(
                    buf[s][i] is not None or snap[s][i] is not None
                    for i in range(W)))
                if bi >= 0:
                    new_g[s] = backward(s, bi)
            fchan, gchan = [None] * pp, [None] * pp
            for s in range(pp - 1):
                if new_y[s] is not None:
                    fchan[s + 1] = new_y[s].to(devs[s + 1])
            for s in range(1, pp):
                if new_g[s] is not None:
                    gchan[s - 1] = new_g[s].to(devs[s - 1])
        grads = {n: None for n in params}
        for n, g in acc.items():
            grads[n] = (g / M).to(params[n].device, params[n].dtype)
        step.stats = {"schedule": schedule, "ticks": T, "slots": W,
                      "peak_live": peak, "microbatches": M}
        return torch.stack(losses).sum() / M, grads, bufs

    step.stats = {}
    step.stage_devices = devs
    step.stage_param_bytes = [nbytes(owned[s]) for s in range(pp)]
    step.packed_bytes_per_device = max(step.stage_param_bytes + [0])
    step.replicated_param_bytes = nbytes(shared)
    return step

