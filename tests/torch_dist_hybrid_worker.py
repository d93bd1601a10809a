"""One rank of the port's two-process hybrid job in
`test_torch_dist_hybrid.py`.

Started by the port's launcher (`paddle_tpu_torch.distributed.launch`),
it joins a gloo process group on the CPU and runs this process's part of:

  (a) the multi-controller `gpt_spmd` hybrid plans of
      `tests/dist_hybrid_worker.py`, each with the axis the reference's
      device reordering puts across the processes first in `axis_order`:
      plan 1 dp2 x pp2 x mp2 with pp across, plan 2 dp4 x mp2 with mp
      across, plan 3 dp4 x sharding2 with sharding across; 3 steps each
      from the JAX initial weights in `<dir>/gpt_<plan>.npz`, every leaf
      of every local rank written to `<dir>/gpt_<plan>_rank<r>.npz`;
  (b) fleet's mp layers and `distributed.split` with mp=2 across the
      processes (each process its rows of the weight), forward and
      gradients against the full-weight computation;
  (c) `Model` over fleet's mp=2 across the processes: tests/
      test_hapi_hybrid.py's TinyErnie from `<dir>/ernie.npz`, 4 steps;
  (d) `group_sharded_parallel` os_g and p_g_os with sharding=2 across the
      processes (each process half the batch) against one process's
      update of the whole batch, computed here; the model and optimizer
      saved by `save_group_sharded_model`, restored into a fresh sharded
      model, and its next step held to one process's;
  (e) the HybridCommunicateGroup's ranks and groups under the process
      group, and an eager all_reduce over its dp group.

It starts with (b), (d) and (e), which need no input, and waits for
each input file as it comes to need it (the test writes them while the
ranks run). After the process group is gone, each rank runs its share
of the plans as one controller over all 8 ranks (rank 0 plan 1, rank 1
plans 2 and 3), the golden of (a), into `<dir>/one_<plan>.npz`. It
writes `<dir>/rank<r>.json`, imports neither JAX nor `paddle_tpu`
(checked at the end), and kills itself after `TIMEOUT_S` seconds.

    worker: torch_dist_hybrid_worker.py <dir>
"""
import faulthandler
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.distributed as dist  # noqa: E402
from paddle_tpu_torch.distributed import env, fleet  # noqa: E402

TIMEOUT_S = 240
# (tag, MeshPlan fields, the axis across the processes)
PLANS = (("dp2_pp2_mp2_pp_cross", dict(dp=2, pp=2, mp=2, microbatches=2),
          ("pp",)),
         ("dp4_mp2_mp_cross", dict(dp=4, mp=2), ("mp",)),
         ("dp4_sharding2_sharding_cross", dict(dp=4, sharding=2),
          ("sharding",)))


def write_npz(path, arrays):
    """`np.savez` under a temporary name, then renamed: a reader that
    sees `path` sees it whole."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def wait_npz(path):
    """The arrays of `path`, once it exists."""
    while not os.path.exists(path):
        time.sleep(0.05)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def gpt_cfg(plan):
    """tests/dist_hybrid_worker.py's config of a plan (a dict of its
    fields), for either package's GPTSpmdConfig."""
    mp, pp = plan.get("mp", 1), plan.get("pp", 1)
    return dict(vocab_size=64 * mp, max_seq_len=64, hidden=16 * mp,
                layers=2 * pp, heads=mp * 2, ffn=32 * mp, remat=False,
                fused_ce_chunks=4)


def gpt_batch(plan):
    cfg = gpt_cfg(plan)
    B = 4 * plan.get("dp", 1) * plan.get("sharding", 1) * \
        plan.get("microbatches", 1)
    S = 16 * plan.get("sp", 1)
    rng = np.random.RandomState(0)
    return (rng.randint(0, cfg["vocab_size"], (B, S)),
            rng.randint(0, cfg["vocab_size"], (B, S)))


def gpt_steps(plan, p0, axis_order=None, steps=3):
    """3 steps of the port's plan from the JAX weights `p0`: (losses,
    {"<rank>/<leaf>": that rank's piece of the leaf}) over the local
    ranks."""
    from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                           init_opt_state_leaf,
                                           make_train_step, params_from_jax)
    cfg, mp = GPTSpmdConfig(**gpt_cfg(plan)), MeshPlan(**plan)
    step_fn, _ = make_train_step(cfg, mp, learning_rate=1e-3, device="cpu",
                                 axis_order=axis_order)
    params = params_from_jax(p0, device="cpu", cfg=cfg, plan=mp,
                             axis_order=axis_order)
    state = {k: [init_opt_state_leaf(p, mp) for p in v]
             for k, v in params.items()}
    toks, labs = (torch.from_numpy(a) for a in gpt_batch(plan))
    losses = []
    for _ in range(steps):
        loss, params, state = step_fn(params, state, toks, labs, 1e-3)
        losses.append(float(loss))
    leaves = {f"{r}/{k}": v[i].detach().float().numpy()
              for i, r in enumerate(step_fn.grid.local_ranks)
              for k, v in params.items()}
    return losses, leaves


def tiny_ernie(P):
    """tests/test_hapi_hybrid.py:29-55's TinyErnie."""
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

    class TinyErnie(nn.Layer):
        def __init__(self, vocab=64, hidden=16, ffn=32, n_cls=4):
            super().__init__()
            self.emb = nn.Embedding(vocab, hidden)
            self.b1 = TinyErnieBlock(hidden, ffn)
            self.b2 = TinyErnieBlock(hidden, ffn)
            self.head = nn.Linear(hidden, n_cls)

        def forward(self, ids):
            h = self.emb(ids)
            h = self.b2(self.b1(h))
            return self.head(h.mean(axis=1))
    return TinyErnie()


def ernie_batches(n=4):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 64, (8, 12)), rng.randint(0, 4, 8))
            for _ in range(n)]


def _init_fleet(**degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(degrees)
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b).max() + 1e-12)))


def mp_layers_check(me):
    """(b): each mp layer and `split` against the full weights."""
    from paddle_tpu_torch.distributed.fleet.layers import mp_layers as M
    hcg = _init_fleet(mp_degree=2)
    rank = hcg.get_model_parallel_rank()
    pg = hcg.get_model_parallel_group().process_group
    rng = np.random.RandomState(3)
    x = rng.rand(4, 8).astype("float32")
    errs = {}

    def run(name, make, inp, full_fn, out_slice, in_slice=None):
        pt.seed(7)
        layer = make()
        full = {n: p._data.detach().clone() for n, p in
                layer.named_parameters()}
        M.shard_mp_params(layer, rank, 2, pg)
        xin = torch.from_numpy(inp)
        xl = xin if in_slice is None else in_slice(xin)
        xt = pt.to_tensor(xl.numpy(), stop_gradient=not
                          xl.is_floating_point())
        out = layer(xt)
        coef = torch.from_numpy(np.random.RandomState(5).rand(
            *full_fn(xin, full).shape).astype("float32"))
        (out * pt.to_tensor(out_slice(coef).numpy())).sum().backward()
        fw = {n: v.clone().requires_grad_() for n, v in full.items()}
        xf = xin.clone().requires_grad_(xin.is_floating_point())
        ref = full_fn(xf, fw)
        (ref * coef).sum().backward()
        e = {"out": _err(out.numpy(), out_slice(ref).detach().numpy())}
        for n, p in layer.named_parameters():
            ax = getattr(p, "split_axis", None)
            g = fw[n].grad
            if getattr(p, "_mp_local", None) is not None:
                g = g.chunk(2, ax)[rank]
            e[f"grad_{n}"] = _err(p.grad.numpy(), g.numpy())
        if xin.is_floating_point():
            gx = xf.grad if in_slice is None else in_slice(xf.grad)
            e["grad_x"] = _err(xt.grad.numpy(), gx.numpy())
        errs[name] = e

    def cols(t):
        return t.chunk(2, -1)[rank]

    same = (lambda t: t)
    run("column_gather", lambda: M.ColumnParallelLinear(8, 12),
        x, lambda a, w: a @ w["weight"] + w["bias"], same)
    run("column_shard", lambda: M.ColumnParallelLinear(
        8, 12, gather_output=False),
        x, lambda a, w: a @ w["weight"] + w["bias"], cols)
    run("row_split", lambda: M.RowParallelLinear(8, 6),
        x, lambda a, w: a @ w["weight"] + w["bias"], same)
    run("row_parallel_input", lambda: M.RowParallelLinear(
        8, 6, input_is_parallel=True),
        x, lambda a, w: a @ w["weight"] + w["bias"], same, cols)
    ids = rng.randint(0, 10, (3, 5))
    run("vocab_embedding", lambda: M.VocabParallelEmbedding(10, 6),
        ids, lambda i, w: w["weight"][i.long()], same)
    # the parallel cross entropy of a process's logit columns
    logits = rng.randn(6, 10).astype("float32")
    lab = rng.randint(0, 10, 6)
    lt = pt.to_tensor(np.ascontiguousarray(logits[:, rank * 5:(rank + 1)
                                                  * 5]), stop_gradient=False)
    loss = M.ParallelCrossEntropy()(lt, pt.to_tensor(lab))
    loss.sum().backward()
    lf = torch.from_numpy(logits).requires_grad_()
    ref = torch.nn.functional.cross_entropy(lf, torch.from_numpy(lab),
                                            reduction="none")
    ref.sum().backward()
    errs["parallel_cross_entropy"] = {
        "out": _err(loss.numpy()[:, 0], ref.detach().numpy()),
        "grad_logits": _err(lt.grad.numpy(),
                            lf.grad[:, rank * 5:(rank + 1) * 5].numpy())}
    # distributed.split against the full layer from the same seed
    xs = pt.to_tensor(x)
    split = {}
    for name, args, make in (
            ("linear_axis1", ((8, 12), "linear", 1),
             lambda: M.ColumnParallelLinear(8, 12)),
            ("linear_axis0", ((8, 6), "linear", 0),
             lambda: M.RowParallelLinear(8, 6)),
            ("embedding", ((10, 6), "embedding", 0),
             lambda: M.VocabParallelEmbedding(10, 6))):
        inp = pt.to_tensor(ids) if args[1] == "embedding" else xs
        pt.seed(9)
        got = dist.split(inp, args[0], args[1], axis=args[2])
        pt.seed(9)
        want = make()(inp)
        split[name] = _err(got.numpy(), want.numpy())
    errs["split"] = split
    return errs


def model_mp(out_dir):
    """(c): Model over fleet's mp=2 across the processes."""
    hcg = _init_fleet(mp_degree=2)
    net = tiny_ernie(pt)
    net.set_state_dict(wait_npz(os.path.join(out_dir, "ernie.npz")))
    net = fleet.distributed_model(net)
    m = pt.Model(net)
    m.prepare(pt.optimizer.Adam(1e-2, parameters=net.parameters()),
              pt.nn.CrossEntropyLoss())
    losses = [m.train_batch([x], [y])[0][0] for x, y in ernie_batches()]
    fc1 = dict(net.named_parameters())["_layers.b1.fc1.weight"]
    return {"losses": losses, "fc1_shape": list(fc1.shape),
            "mp_rank": hcg.get_model_parallel_rank()}


def sharded_check(me, level):
    """(d): group_sharded_parallel across the processes against one
    process's update of the whole batch; then a save and a restore of
    the model and its optimizer, and one more step."""
    from paddle_tpu_torch.distributed import sharding
    _init_fleet(sharding_degree=2)
    rng = np.random.RandomState(4)
    batches = [(rng.rand(16, 8).astype("float32"), rng.randint(0, 4, 16))
               for _ in range(3)]
    lf = pt.nn.CrossEntropyLoss()

    def make():
        pt.seed(12)
        net = pt.nn.Sequential(pt.nn.Linear(8, 64), pt.nn.ReLU(),
                               pt.nn.Linear(64, 4))
        return net, pt.optimizer.Adam(
            1e-2, parameters=net.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(0.5))

    def step(net, o, x, y):
        loss = lf(net(pt.to_tensor(x)), pt.to_tensor(y))
        loss.backward()
        o.step()
        o.clear_grad()
        return float(loss)

    def param_errs(net, ref):
        return {n: _err(p.numpy(), q.numpy()) for (n, p), (_, q) in
                zip(net.named_parameters(), ref.named_parameters())}
    rows = slice(me * 8, (me + 1) * 8)
    ref, ref_o = make()
    net, o = make()
    net, o, _ = sharding.group_sharded_parallel(net, o, level)
    losses = []
    for x, y in batches[:2]:
        step(ref, ref_o, x, y)
        losses.append(step(net, o, x[rows], y[rows]))
    rows_shape = list(net[0].weight.shape)
    state_rows = [list(v.shape) for v in
                  o._rows[id(net[0].weight)][2].values() if v.dim()]
    out = os.path.join(os.environ["HYBRID_OUT"], f"{level}_{me}")
    sharding.save_group_sharded_model(net, out, o)
    errs = param_errs(net, ref)
    saved = pt.framework.io.load(os.path.join(out, "model.pdopt"),
                                 return_numpy=True)
    want = ref_o.state_dict()
    state_err = {f"{k}.{m}": _err(saved[k][m], want[k][m].numpy())
                 for k in want if k.startswith("param_") for m in want[k]}
    # a fresh sharded model from the saved files takes the third step
    net2, o2 = make()
    net2, o2, _ = sharding.group_sharded_parallel(net2, o2, level)
    net2.set_state_dict(pt.framework.io.load(
        os.path.join(out, "model.pdmodel"), return_numpy=True))
    o2.set_state_dict(saved)
    x, y = batches[2]
    step(ref, ref_o, x, y)
    step(net2, o2, x[rows], y[rows])
    sharding._gather_params(net2)
    return {"param_err": errs, "rows_shape": rows_shape,
            "state_rows": state_rows, "losses": losses,
            "saved_state_err": state_err,
            "saved_moment_shape": list(saved["param_0"]["moment1"].shape),
            "restored_param_err": param_errs(net2, ref)}


def topology_check(me):
    """(e): the HybridCommunicateGroup under the process group."""
    out = {}
    hcg = _init_fleet(dp_degree=2)
    g = hcg.get_data_parallel_group()
    t = pt.to_tensor(np.float32([me + 1.0]))
    dist.all_reduce(t, group=g)
    out["dp"] = [hcg.get_data_parallel_rank(), g.nranks,
                 g.spans_processes(), float(t), hcg.get_parallel_mode(),
                 fleet.worker_index(), fleet.worker_num()]
    hcg = _init_fleet(mp_degree=2)
    g = hcg.get_model_parallel_group()
    b = pt.to_tensor(np.float32([10.0 * (me + 1)]))
    dist.broadcast(b, src=1, group=g)
    out["mp"] = [hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                 g.nranks, float(b), hcg.get_parallel_mode(),
                 env.get_mesh().local_ranks]
    return out


def main():
    faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    os.environ["HYBRID_OUT"] = out_dir
    pt.set_device("cpu")
    dist.init_parallel_env()
    me = dist.get_rank()
    res = {"rank": me, "world": dist.get_world_size()}
    res["mp_layers"] = mp_layers_check(me)
    res["sharded"] = {lv: sharded_check(me, lv) for lv in ("os_g", "p_g_os")}
    res["topology"] = topology_check(me)
    res["model_mp"] = model_mp(out_dir)
    res["gpt"] = {}
    p0s = {}
    for tag, plan, order in PLANS:
        p0s[tag] = wait_npz(os.path.join(out_dir, f"gpt_{tag}.npz"))
        losses, leaves = gpt_steps(plan, p0s[tag], order)
        np.savez(os.path.join(out_dir, f"gpt_{tag}_rank{me}.npz"), **leaves)
        res["gpt"][tag] = {"losses": losses}
    dist.barrier()
    dist.destroy_process_group()
    # without a process group the step is one controller over every rank
    res["one_controller"] = {}
    for i, (tag, plan, _) in enumerate(PLANS):
        if min(i, 1) == me:
            losses, leaves = gpt_steps(plan, p0s[tag])
            np.savez(os.path.join(out_dir, f"one_{tag}.npz"), **leaves)
            res["one_controller"][tag] = losses
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    res["jax_free"] = not bad
    with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
