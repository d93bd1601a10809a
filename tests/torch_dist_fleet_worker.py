"""One rank of the port's two-process fleet job in
`test_torch_dist_fleet.py`.

Started by the port's launcher (`paddle_tpu_torch.distributed.launch`),
it joins a gloo process group on the CPU and runs this process's part of:

  (a) the multi-controller `gpt_spmd` plans whose sp or pp axis crosses
      the processes (first in `axis_order`): sp2 ring, sp2 Ulysses, GPipe
      and the interleaved schedule (vpp=2), 3 steps each from the JAX
      initial weights in `<dir>/gpt_<plan>.npz`, every leaf of every
      local rank to `<dir>/gpt_<plan>_rank<r>.npz`; and one step of
      dp4 x mp2 with dp across, whose dp groups hold two members a
      process (the partial-sum reduction's tolerance case), from the
      port's own initial weights;
  (b) `Model` over a fleet `PipelineLayer` with one pp stage a process:
      the three pp tests of tests/test_hapi_hybrid.py (dp4 x pp2,
      mp2 x pp2, dp2 x pp2 x mp2), losses and the parameters of this
      process's stage after the steps;
  (c) `Model` over tests/test_hapi_hybrid.py's TinyErnie (the JAX
      weights in `<dir>/ernie.npz`) with dp across the processes and mp
      within them (dp2 x mp2), and with mp across them, two mp ranks a
      process (dp2 x mp4): 4 steps each.

After the process group is gone, each rank computes the goldens the test
holds (a) and (b) to: (a)'s plans as one controller over all 8 ranks
(rank 0 the sp plans and the tolerance plan, rank 1 the pipeline plans)
into `<dir>/one_<plan>.npz`, and (b)'s one-controller pipelines and the
same networks trained serially (both ranks). It writes
`<dir>/rank<r>.json`, imports neither JAX nor `paddle_tpu` (checked at the
end), and kills itself after `TIMEOUT_S` seconds.

    worker: torch_dist_fleet_worker.py <dir>
"""
import faulthandler
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch.distributed import env  # noqa: E402
import torch_dist_hybrid_worker as H  # noqa: E402

TIMEOUT_S = 240
# (tag, MeshPlan fields, the axis across the processes)
PLANS = (("dp4_sp2_ring_sp_cross", dict(dp=4, sp=2, sp_mode="ring"),
          ("sp",)),
         ("dp2_sp2_mp2_ulysses_sp_cross",
          dict(dp=2, sp=2, mp=2, sp_mode="ulysses"), ("sp",)),
         ("dp2_pp2_mp2_gpipe_pp_cross",
          dict(dp=2, pp=2, mp=2, microbatches=2, schedule="gpipe"),
          ("pp",)),
         ("dp2_pp2_mp2_vpp2_pp_cross",
          dict(dp=2, pp=2, mp=2, microbatches=4, vpp=2), ("pp",)))
# one step: the dp groups hold two ranks in each process
TOL_PLAN = ("dp4_mp2_dp_cross", dict(dp=4, mp=2), ("dp",))
# (tag, mesh, microbatches, seed, the descs' kind, batch, data seed, steps)
PP_CASES = (("dp4_pp2", {"dp": 4, "pp": 2}, 4, 7, "mlp", 16, 3, 3),
            ("mp2_pp2", {"pp": 2, "mp": 2}, 2, 11, "ernie2", 8, 9, 3),
            ("dp2_pp2_mp2", {"dp": 2, "pp": 2, "mp": 2}, 2, 13, "ernie1",
             8, 17, 2))
# (tag, mesh, the axis first in the order)
MODEL_CASES = (("dp2_mp2_dp_cross", {"dp": 2, "mp": 2}, ("dp",)),
               ("dp2_mp4_mp_cross", {"dp": 2, "mp": 4}, ("mp",)))


def tiny_block(P):
    """tests/test_hapi_hybrid.py:29-40's TinyErnieBlock in package `P`."""
    import importlib
    nn = P.nn
    mp = importlib.import_module(
        f"{P.__name__}.distributed.fleet.layers.mp_layers")

    class TinyErnieBlock(nn.Layer):
        def __init__(self, hidden, ffn):
            super().__init__()
            self.ln = nn.LayerNorm(hidden)
            self.fc1 = mp.ColumnParallelLinear(hidden, ffn,
                                               gather_output=False)
            self.act = nn.GELU()
            self.fc2 = mp.RowParallelLinear(ffn, hidden,
                                            input_is_parallel=True)

        def forward(self, x):
            return x + self.fc2(self.act(self.fc1(self.ln(x))))
    return TinyErnieBlock


def pp_descs(kind):
    """The LayerDescs of tests/test_hapi_hybrid.py's three pp tests."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import LayerDesc
    nn = pt.nn
    if kind == "mlp":
        return [LayerDesc(nn.Linear, 12, 32), LayerDesc(nn.ReLU),
                LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
                LayerDesc(nn.Linear, 32, 4)]
    blk = tiny_block(pt)
    n = 2 if kind == "ernie2" else 1
    return [LayerDesc(nn.Linear, 12, 16)] + \
        [LayerDesc(blk, 16, 32) for _ in range(n)] + \
        [LayerDesc(nn.Linear, 16, 4)]


def pp_case(case, serial=False):
    """One pp test's steps through `Model` on the installed mesh (or, with
    `serial`, the same network and weights trained serially with no
    mesh): (losses, {parameter name: value after the steps} of the stages
    this process runs)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    tag, mesh, M, seed, kind, B, dseed, steps = case
    pt.seed(seed)
    pl = PipelineLayer(pp_descs(kind), num_stages=2,
                       loss_fn=pt.nn.CrossEntropyLoss())
    o = pt.optimizer.SGD(0.1, parameters=pl.parameters())
    rng = np.random.RandomState(dseed)
    data = [(rng.rand(B, 12).astype("float32"), rng.randint(0, 4, B))
            for _ in range(steps)]
    losses = []
    if serial:
        lf = pt.nn.CrossEntropyLoss()
        for x, y in data:
            loss = lf(pl(pt.to_tensor(x)), pt.to_tensor(y))
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        stages = range(2)
    else:
        m = pt.Model(pl)
        m.prepare(o, pt.nn.CrossEntropyLoss(), strategy={"microbatches": M})
        for x, y in data:
            losses.append(m.train_batch([x], [y])[0][0])
        grid = env.get_mesh()
        stages = sorted({grid.coords[r]["pp"] for r in grid.local_ranks})
    names = {n for n, _ in pl.named_parameters()}
    mine = set()
    for i, (layer, _) in enumerate(pl._built):
        if pl.stage_of_layer(i) in stages and hasattr(layer, "parameters"):
            ids = {id(p) for p in layer.parameters()}
            mine |= {n for n, p in pl.named_parameters() if id(p) in ids}
    params = {n: p.numpy() for n, p in pl.named_parameters()
              if n in mine and n in names}
    return losses, params


def model_case(case, out_dir):
    """TinyErnie from the JAX weights through `Model` on a mesh split over
    the processes: 4 losses."""
    tag, dims, order = case
    env.build_mesh(dims, order=order)
    net = H.tiny_ernie(pt)
    net.set_state_dict(H.wait_npz(os.path.join(out_dir, "ernie.npz")))
    m = pt.Model(net)
    m.prepare(pt.optimizer.Adam(1e-2, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss())
    losses = [m.train_batch([x], [y])[0][0] for x, y in H.ernie_batches()]
    fc1 = dict(net.named_parameters())["b1.fc1.weight"]
    return {"losses": losses, "fc1_shape": list(fc1.shape)}


def port_init(plan):
    """The port's initial weights of a plan's config (seed 0)."""
    from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                           make_train_step)
    cfg = GPTSpmdConfig(**H.gpt_cfg(plan))
    _, init_fn = make_train_step(cfg, MeshPlan(), device="cpu")
    return {k: v.numpy() for k, v in init_fn(0)[0].items()}


def save_leaves(path, leaves):
    np.savez(path, **leaves)


def main():
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    pt.set_device("cpu")
    dist.init_parallel_env()
    me = dist.get_rank()
    res = {"rank": me, "world": dist.get_world_size()}
    res["pp"] = {}
    for case in PP_CASES:
        env.build_mesh(case[1], order=("pp",))
        losses, params = pp_case(case)
        save_leaves(os.path.join(out_dir, f"pp_{case[0]}_rank{me}.npz"),
                    params)
        res["pp"][case[0]] = {"losses": losses, "stage_params":
                              sorted(params)}
    tol_p0 = port_init(TOL_PLAN[1])
    losses, leaves = H.gpt_steps(TOL_PLAN[1], tol_p0, TOL_PLAN[2], steps=1)
    save_leaves(os.path.join(out_dir, f"gpt_{TOL_PLAN[0]}_rank{me}.npz"),
                leaves)
    res["gpt"] = {TOL_PLAN[0]: {"losses": losses}}
    res["model"] = {case[0]: model_case(case, out_dir)
                    for case in MODEL_CASES}
    p0s = {}
    for tag, plan, order in PLANS:
        p0s[tag] = H.wait_npz(os.path.join(out_dir, f"gpt_{tag}.npz"))
        losses, leaves = H.gpt_steps(plan, p0s[tag], order)
        save_leaves(os.path.join(out_dir, f"gpt_{tag}_rank{me}.npz"),
                    leaves)
        res["gpt"][tag] = {"losses": losses}
    dist.barrier()
    dist.destroy_process_group()
    # without a process group: one controller over every rank
    res["one_controller"] = {}
    jobs = [(TOL_PLAN[0], TOL_PLAN[1], tol_p0, 1)] + \
        [(tag, plan, p0s[tag], 3) for tag, plan, _ in PLANS]
    for tag, plan, p0, steps in jobs:
        if (plan.get("pp", 1) > 1) == (me == 1):
            losses, leaves = H.gpt_steps(plan, p0, steps=steps)
            save_leaves(os.path.join(out_dir, f"one_{tag}.npz"), leaves)
            res["one_controller"][tag] = losses
    res["pp_one"], res["pp_serial"] = {}, {}
    for case in PP_CASES:
        env.build_mesh(case[1])
        losses, params = pp_case(case)
        save_leaves(os.path.join(out_dir, f"pp_one_{case[0]}_rank{me}.npz"),
                    params)
        res["pp_one"][case[0]] = losses
        env.set_mesh(None)
        losses, params = pp_case(case, serial=True)
        save_leaves(os.path.join(out_dir,
                                 f"pp_serial_{case[0]}_rank{me}.npz"), params)
        res["pp_serial"][case[0]] = losses
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    res["jax_free"] = not bad
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
