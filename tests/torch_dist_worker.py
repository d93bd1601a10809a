"""One rank of the port's two-process job in `test_torch_dist_multiproc.py`.

Started by the port's launcher (`paddle_tpu_torch.distributed.launch`,
which sets the PADDLE_* variables), it joins the gloo process group on
the CPU and runs, after building a mesh first, on this process's part of each recipe:

  (a) the psum of rank+1 over an 8-rank dp mesh, 4 ranks a process, in a
      manual region (the reference's `tests/dist_worker.py` recipe);
  (b) the eager collectives across the two processes (those the
      reference does not move keep their identity), the TCPStore across
      them, and `all_gather_object`;
  (c) the reference's dp MLP: 5 steps over the 8-rank mesh, each rank's
      gradients and loss pmean'd over dp;
  (d) `Model.train_batch` on a dp2 mesh (one rank a process) of a small
      CNN with `SyncBatchNorm`, weights from `<dir>/cnn.npz`, 3 global
      batches;
  (e) the multi-controller `gpt_spmd` dp2 step: its init_fn, and 2 steps
      at a tiny size from the JAX weights in `<dir>/gpt.npz`;
  (f) `DataParallel.apply_collective_grads` and the sampler's defaults.

It writes `<dir>/rank<r>.json`. It imports neither JAX nor `paddle_tpu`
(checked at the end), and kills itself after `TIMEOUT_S` seconds.

    worker: torch_dist_worker.py <dir>
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
from paddle_tpu_torch.parallel import make_train_step  # noqa: E402

TIMEOUT_S = 240
GPT_CFG = dict(vocab_size=128, max_seq_len=64, hidden=64, layers=2, heads=4,
               ffn=128, remat=False)


def cnn(P):
    nn = P.nn

    class CNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.SyncBatchNorm(4)
            self.fc = nn.Linear(4 * 8 * 8, 3)

        def forward(self, x):
            return self.fc(P.nn.functional.relu(self.bn(self.conv(x)))
                           .flatten(1))
    return CNN()


def cnn_batches():
    rng = np.random.RandomState(11)
    return [(rng.rand(8, 3, 8, 8).astype("float32") * 2 - 0.5,
             rng.randint(0, 3, (8,)).astype("int64")) for _ in range(3)]


def mlp_recipe():
    """tests/dist_worker.py's dp MLP on this process's 4 of 8 ranks."""
    rng = np.random.RandomState(0)
    w1 = rng.randn(16, 32).astype(np.float32) * 0.1
    w2 = rng.randn(32, 1).astype(np.float32) * 0.1
    X = rng.randn(64, 16).astype(np.float32)
    Y = rng.randn(64, 1).astype(np.float32)
    mesh = env.get_mesh()
    ranks = mesh.local_ranks
    W1 = [torch.from_numpy(w1.copy()) for _ in ranks]
    W2 = [torch.from_numpy(w2.copy()) for _ in ranks]
    losses = []
    for _ in range(5):
        ls, g1s, g2s = [], [], []
        for i, r in enumerate(ranks):
            a = W1[i].clone().requires_grad_(True)
            b = W2[i].clone().requires_grad_(True)
            x, y = torch.from_numpy(X[r * 8:(r + 1) * 8]), \
                torch.from_numpy(Y[r * 8:(r + 1) * 8])
            loss = ((torch.tanh(x @ a) @ b - y) ** 2).mean()
            g1, g2 = torch.autograd.grad(loss, (a, b))
            ls.append(pt.to_tensor(loss.detach()))
            g1s.append(pt.to_tensor(g1))
            g2s.append(pt.to_tensor(g2))
        with env.axis_context(dp="dp"):
            for vals in (ls, g1s, g2s):
                dist.all_reduce(vals, op=dist.ReduceOp.AVG)
        W1 = [w - 0.1 * g._data for w, g in zip(W1, g1s)]
        W2 = [w - 0.1 * g._data for w, g in zip(W2, g2s)]
        losses.append(float(ls[0]))
    return losses


def gpt_batches():
    rng = np.random.RandomState(5)
    return [(rng.randint(0, 128, (4, 32)), rng.randint(0, 128, (4, 32)))
            for _ in range(2)]


def gpt_steps(p0):
    """2 dp2 `gpt_spmd` steps from the JAX global parameters `p0` (with a
    process group, this process's ranks only): (losses, params)."""
    from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                           init_opt_state_leaf,
                                           params_from_jax)
    cfg, plan = GPTSpmdConfig(**GPT_CFG), MeshPlan(dp=2)
    step_fn, _ = make_train_step(cfg, plan, learning_rate=1e-3,
                                 device="cpu")
    params = params_from_jax(p0, device="cpu", cfg=cfg, plan=plan)
    state = {k: [init_opt_state_leaf(p, plan) for p in v]
             for k, v in params.items()}
    losses = []
    for toks, labs in gpt_batches():
        loss, params, state = step_fn(params, state, torch.from_numpy(toks),
                                      torch.from_numpy(labs))
        losses.append(float(loss))
    return losses, params


def main():
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    pt.set_device("cpu")
    # a mesh built before the group is joined: init_parallel_env still
    # joins, and splits the mesh's ranks over the processes
    env.build_mesh({"dp": 2})
    dist.init_parallel_env()
    me, n = dist.get_rank(), dist.get_world_size()
    pre = env.get_mesh()
    res = {"rank": me, "world": n, "backend": dist.get_backend(),
           "trainer_id": int(os.environ["PADDLE_TRAINER_ID"]),
           "mesh_before_init": [pre.nproc, pre.local_ranks, pre.dims]}

    # (a) psum of rank+1 over 8 ranks, 4 a process
    mesh = env.build_mesh({"dp": 8})
    res["local_ranks"] = mesh.local_ranks
    xs = [pt.to_tensor(np.float32([r + 1])) for r in mesh.local_ranks]
    with env.axis_context(dp="dp"):
        dist.all_reduce(xs)
    res["psum"] = [float(x) for x in xs]
    res["mlp_losses"] = mlp_recipe()
    env.set_mesh(None)
    env.build_mesh({"dp": n})

    # (b) eager collectives across the processes
    def full(v, k=3, dt="float32"):
        return pt.to_tensor(np.full((k,), v, dt))
    t = full(me + 1.0)
    dist.all_reduce(t)
    res["eager_allreduce"] = t.numpy().tolist()
    t = full(me + 1.0, 2)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    res["eager_max"] = t.numpy().tolist()
    t = full(me + 1.0, 2)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    res["eager_min"] = t.numpy().tolist()
    t = full(me + 2, 2, "int64")
    dist.all_reduce(t, op=dist.ReduceOp.PROD)
    res["eager_prod_int"] = t.numpy().tolist()
    t = full(me + 1.0, 2)
    dist.all_reduce(t, op=dist.ReduceOp.AVG)
    res["eager_avg"] = t.numpy().tolist()
    b = full(10.0 * (me + 1), 2)
    dist.broadcast(b, src=1)
    res["eager_bcast"] = b.numpy().tolist()
    got = []
    dist.all_gather(got, full(float(me), 2))
    res["all_gather"] = [g.numpy().tolist() for g in got]
    rs = dist.reduce_scatter(pt.to_tensor(np.arange(4, dtype="float32")
                                          * (me + 1)))
    res["reduce_scatter"] = rs.numpy().tolist()
    # the other collectives keep the single participant's identity
    # across processes, as the reference's do
    a2a = []
    dist.alltoall([full(10.0 * me + j, 1) for j in range(n)], a2a)
    sc = full(float(me), 2)
    dist.scatter(sc, [full(5.0 + j, 2) for j in range(n)], src=0)
    r = full(float(me), 1)
    dist.recv(r, src=0)
    res["identities"] = {
        "alltoall": [v.numpy().tolist() for v in a2a],
        "p2p_shift": dist.p2p_shift(full(float(me), 1)).numpy().tolist(),
        "scatter": sc.numpy().tolist(),
        "send": dist.send(full(float(me), 1), dst=1).numpy().tolist(),
        "recv": r.numpy().tolist(),
        "all_gather_concat": dist.all_gather_concat(
            full(float(me), 1)).numpy().tolist()}
    objs = []
    dist.all_gather_object(objs, {"rank": me})
    res["objects"] = objs
    dist.barrier()

    # the TCPStore across the processes: rank 0 hosts it
    store = dist.TCPStore(is_master=True, world_size=n) if me == 0 else None
    port = [None] * n
    torch.distributed.all_gather_object(port, store.port if store else None)
    if store is None:
        store = dist.TCPStore(port=port[0], world_size=n)
    store.set(f"k{me}", f"v{me}")
    res["store_add"] = store.add("count", 1)
    store.barrier("b")
    res["store_get"] = store.get(f"k{1 - me}").decode()
    dist.barrier()              # every rank done with the store: rank 0's
    store.stop()                # server may go

    # (d) Model dp2 with SyncBatchNorm
    net = cnn(pt)
    w = np.load(os.path.join(out_dir, "cnn.npz"))
    net.set_state_dict({k: w[k] for k in w.files})
    model = pt.Model(net)
    model.prepare(pt.optimizer.SGD(0.1, parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
    res["model_dp_mesh"] = model._dp_mesh() is env.get_mesh()
    res["model_losses"] = [model.train_batch([x], [y])[0][0]
                           for x, y in cnn_batches()]
    res["model_bn_mean"] = net.bn._mean.numpy().tolist()

    # (e) the multi-controller gpt_spmd dp2 step: init_fn's leaves, then
    # 2 steps from the JAX weights in `<dir>/gpt.npz`
    from paddle_tpu_torch.parallel import GPTSpmdConfig, MeshPlan
    g = np.load(os.path.join(out_dir, "gpt.npz"))
    losses, params = gpt_steps({k: g[k] for k in g.files})
    res["gpt_losses"] = losses
    res["gpt_leaves"] = len(params["w_qkv"])
    res["gpt_wte_sum"] = float(params["wte"][0].detach().double().sum())
    _, init_fn = make_train_step(GPTSpmdConfig(**GPT_CFG), MeshPlan(dp=2),
                                 device="cpu")
    res["gpt_init_wte_sum"] = float(init_fn(0)[0]["wte"][0].double().sum())

    # (f) DataParallel and the sampler's defaults
    torch.manual_seed(0)
    lin = pt.nn.Linear(4, 2)
    dp = pt.DataParallel(lin)
    x = pt.to_tensor(np.full((3, 4), me + 1.0, "float32"))
    dp(x).sum().backward()
    dp.apply_collective_grads()
    res["dp_grad"] = lin.weight.grad.numpy().tolist()
    s = pt.io.DistributedBatchSampler(list(range(10)), 2)
    res["sampler"] = [s.nranks, s.local_rank, list(s)]

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    res["jax_free"] = not bad
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
