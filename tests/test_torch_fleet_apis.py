"""Fleet's user-facing APIs of the port against the JAX package, one
process on the CPU: the counterparts of `tests/test_fleet_apis.py`'s
sharding and meta-optimizer tests, every test of
`tests/test_meta_optimizers.py` and `tests/test_fleet_utils.py` (with
`tests/test_final_namespaces.py`'s `recompute_sequential`), the fleet
namespace and the topology.

Each trajectory runs in both packages from the same weights (the JAX
`state_dict` carried over) on the same numpy inputs; the port's losses
and weights are held to the JAX package's at the reference test's
tolerance (f32: rtol 1e-5 on losses unless stated). The ZeRO partition
each wrapper records is held to the reference's `sharding.spec`.
"""
import importlib
import os

import numpy as np
import pytest

import paddle_tpu_torch as pt
from torch_jax_init import numpy_initializers


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import env as penv
    from paddle_tpu_torch.distributed import fleet as pfleet
    for env in (jenv, penv):
        monkeypatch.setattr(env, "_global_mesh", None)
        monkeypatch.setattr(env, "_initialized", False)
    for f in (jfleet, pfleet):
        monkeypatch.setattr(f, "_fleet_state", dict(f._fleet_state))
    pt.set_device("cpu")
    with numpy_initializers():
        yield


def jx():
    import paddle_tpu as pj
    return pj


def mod(P, path):
    return importlib.import_module(f"{P.__name__}.{path}")


def carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


def both(factory, seed):
    pj = jx()
    pj.seed(seed)
    jnet = factory(pj)
    pnet = factory(pt)
    carry(jnet, pnet)
    return {pj: jnet, pt: pnet}


def _data(P, n=32, d=8, c=4, seed=0):
    rng = np.random.RandomState(seed)
    return (P.to_tensor(rng.rand(n, d).astype("float32")),
            P.to_tensor(rng.randint(0, c, n)))


# ------------------------------------------------------------------ fleet

def test_fleet_namespace_exports_the_reference_names():
    import re
    src = open(os.path.join(os.path.dirname(jx().__file__), "distributed",
                            "fleet", "__init__.py")).read()
    names = set(re.findall(r"^(?:def|class) ([A-Za-z]\w*)", src, re.M)) | \
        set(re.findall(r"^([A-Za-z]\w*) = ", src, re.M)) | \
        {"DistributedStrategy", "CommunicateTopology",
         "HybridCommunicateGroup", "recompute", "meta_parallel", "utils"}
    fleet = pt.distributed.fleet
    assert sorted(n for n in names if not hasattr(fleet, n)) == []
    for m in ("layers.mp_layers", "meta_parallel", "utils",
              "meta_optimizers", "base.topology",
              "base.distributed_strategy"):
        importlib.import_module(f"paddle_tpu_torch.distributed.fleet.{m}")
    assert pt.distributed.fleet.DistributedStrategy().to_dict() == \
        jx().distributed.fleet.DistributedStrategy().to_dict()


@pytest.mark.parametrize("hybrid", [
    dict(dp_degree=2, mp_degree=4), dict(dp_degree=2, pp_degree=2,
                                         mp_degree=2),
    dict(sharding_degree=4, dp_degree=2), dict(dp_degree=8)])
def test_topology_matches_reference(hybrid):
    """Every size, rank, group size and parallel mode of the
    HybridCommunicateGroup equals the reference's (one controller: every
    rank reads 0)."""
    got = {}
    for P in (jx(), pt):
        fleet = P.distributed.fleet
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(hybrid)
        fleet.init(is_collective=True, strategy=s)
        h = fleet.get_hybrid_communicate_group()
        got[P] = (
            [getattr(h, f"get_{k}_world_size")() for k in
             ("data_parallel", "model_parallel", "pipe_parallel",
              "sharding_parallel", "sep_parallel")],
            [h.get_data_parallel_rank(), h.get_model_parallel_rank(),
             h.get_stage_id(), h.get_sharding_parallel_rank()],
            [getattr(h, f"get_{k}_group")().nranks for k in
             ("data_parallel", "model_parallel", "pipe_parallel",
              "sharding_parallel")],
            h.get_parallel_mode(), h.topology().world_size(),
            fleet.worker_num() if P is jx() else 8)
    assert got[pt] == got[jx()]
    assert pt.distributed.get_world_size() == 8     # ranks (C.21)


def test_fleet_util_and_data_generator():
    for P in (jx(), pt):
        fleet = P.distributed.fleet
        assert fleet.util.all_reduce([1, 2], "sum").tolist() == [1, 2]
        assert fleet.util.all_gather(5) == [5]
        assert fleet.util.get_file_shard(["a", "b", "c"]) == \
            ["a", "b", "c"][fleet.worker_index()::fleet.worker_num()]

        class Gen(fleet.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    yield [("ids", [int(v) for v in line.split()]),
                           ("len", [len(line.split())])]
                return it
        assert Gen().run_from_memory(["1 2 3"]) == ["3 1 2 3 1 3"]
        assert fleet.Fleet().worker_index() == 0


# ------------------------------------------------------- group_sharded (ZeRO)

def _sharded(P, level, net_fn, opt_fn):
    mod(P, "distributed.env").build_mesh({"dp": 2, "sharding": 4})
    net = net_fn(P)
    o = opt_fn(P, net)
    return mod(P, "distributed.sharding").group_sharded_parallel(net, o,
                                                                 level)


def test_group_sharded_stage3_partition_and_update():
    """p_g_os: each parameter's recorded partition equals the reference's
    placement spec; the one-controller step equals the reference's
    sharded step (rtol 1e-5)."""
    nets = both(lambda P: P.nn.Sequential(P.nn.Linear(8, 64), P.nn.ReLU(),
                                          P.nn.Linear(64, 4)), 4)
    losses, weights = {}, {}
    for P, net in nets.items():
        mod(P, "distributed.env").build_mesh({"dp": 2, "sharding": 4})
        o = P.optimizer.Adam(1e-3, parameters=net.parameters())
        net, o, _ = mod(P, "distributed.sharding").group_sharded_parallel(
            net, o, "p_g_os")
        x, y = _data(P)
        loss = P.nn.CrossEntropyLoss()(net(x), y)
        loss.backward()
        o.step()
        o.clear_grad()
        losses[P] = float(loss)
        weights[P] = net[0].weight.numpy()
    jw = nets[jx()][0].weight
    assert nets[pt][0].weight.partition_spec == tuple(jw._data.sharding.spec)
    for (n, p), (_, q) in zip(nets[pt].named_parameters(),
                              nets[jx()].named_parameters()):
        want = tuple(q._data.sharding.spec) if hasattr(q, "_dist_attr") \
            else None
        assert getattr(p, "partition_spec", None) == want, n
    np.testing.assert_allclose(losses[pt], losses[jx()], rtol=1e-5)
    np.testing.assert_allclose(weights[pt], weights[jx()], rtol=1e-5,
                               atol=1e-6)


def test_group_sharded_stage2_state_partition():
    """os_g: the optimizer state's recorded partitions equal the
    reference's placement specs; the parameters stay whole."""
    nets = both(lambda P: P.nn.Linear(8, 64), 5)
    specs = {}
    for P, net in nets.items():
        mod(P, "distributed.env").build_mesh({"dp": 2, "sharding": 4})
        base = P.optimizer.Adam(1e-3, parameters=net.parameters())
        net, o, _ = mod(P, "distributed.sharding").group_sharded_parallel(
            net, base, "os_g")
        params = {n: p._data for n, p in net.named_parameters()}
        st = o.functional_state(params)
        if P is pt:
            specs[P] = o.state_specs
        else:
            specs[P] = {n: {k: tuple(v.sharding.spec) for k, v in s.items()}
                        for n, s in st.items()}
    assert specs[pt] == specs[jx()]
    assert "sharding" in specs[pt]["weight"]["moment1"]
    assert getattr(nets[pt].weight, "partition_spec", None) is None


def test_group_sharded_bad_level_and_offload():
    net = pt.nn.Linear(4, 4)
    sh = pt.distributed.sharding
    with pytest.raises(ValueError):
        sh.group_sharded_parallel(net, pt.optimizer.SGD(
            parameters=net.parameters()), "stage9")
    pt.distributed.env.build_mesh({"sharding": 2})
    with pytest.raises(NotImplementedError, match="offload"):
        sh.group_sharded_parallel(net, pt.optimizer.SGD(
            parameters=net.parameters()), "os", offload=True)


def test_save_group_sharded_model(tmp_path):
    """save_group_sharded_model writes a plain state_dict the reference
    loads."""
    net = pt.nn.Linear(4, 3)
    o = pt.optimizer.Adam(1e-3, parameters=net.parameters())
    pt.distributed.sharding.save_group_sharded_model(net, str(tmp_path), o)
    got = jx().load(str(tmp_path / "model.pdmodel"))
    np.testing.assert_array_equal(np.asarray(got["weight"]),
                                  net.weight.numpy())


# ------------------------------------------------------- meta-optimizer flags

def _strategy(P, **flags):
    s = P.distributed.fleet.DistributedStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    P.distributed.fleet.init(is_collective=True, strategy=s)
    return s


def test_strategy_lars_substitution():
    """LARS swaps Momentum for LarsMomentum; the step equals the
    reference's (rtol 1e-5)."""
    nets = both(lambda P: P.nn.Linear(8, 4), 0)
    ws = {}
    for P, net in nets.items():
        s = _strategy(P, lars=True)
        o = P.distributed.fleet.distributed_optimizer(
            P.optimizer.Momentum(0.1, parameters=net.parameters()), s)
        assert type(o._inner_opt).__name__ == "LarsMomentum"
        x, y = _data(P)
        P.nn.CrossEntropyLoss()(net(x), y).backward()
        o.step()
        o.clear_grad()
        ws[P] = net.weight.numpy()
    np.testing.assert_allclose(ws[pt], ws[jx()], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("api", ["minimize", "step"])
def test_gradient_merge(api):
    """k_steps=2: the first call accumulates only (weights unchanged), the
    second applies the merged update; both equal the reference's."""
    nets = both(lambda P: P.nn.Linear(8, 4), 3)
    ws = {}
    for P, net in nets.items():
        s = _strategy(P, gradient_merge=True)
        s.gradient_merge_configs = {"k_steps": 2, "avg": True}
        w0 = net.weight.numpy().copy()
        o = P.distributed.fleet.distributed_optimizer(
            P.optimizer.SGD(0.1, parameters=net.parameters()), s)
        x, y = _data(P)
        lf = P.nn.CrossEntropyLoss()
        for i in range(2):
            if api == "minimize":
                o.minimize(lf(net(x), y))
            else:
                lf(net(x), y).backward()
                o.step()
                o.clear_grad()
            if i == 0:
                np.testing.assert_array_equal(net.weight.numpy(), w0)
        assert not np.allclose(net.weight.numpy(), w0)
        ws[P] = net.weight.numpy()
    np.testing.assert_allclose(ws[pt], ws[jx()], rtol=1e-5, atol=1e-7)


# ------------------------------------------------ test_meta_optimizers.py

def _tiny_problem(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(32, 8).astype("float32")
    return x, x @ rng.rand(8, 1).astype("float32")


def _train(P, net, opt, steps):
    x_np, y_np = _tiny_problem()
    losses = []
    for _ in range(steps):
        loss = ((net(P.to_tensor(x_np)) - P.to_tensor(y_np)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _dgc(P, net, **cfg):
    P.distributed.fleet.init()
    s = P.distributed.fleet.DistributedStrategy()
    s.dgc = True
    s.dgc_configs = cfg
    return P.distributed.fleet.distributed_optimizer(
        P.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                             parameters=net.parameters()), strategy=s)


@pytest.mark.parametrize("cfg,steps", [
    ({"rampup_begin_step": 1000, "sparsity": [0.999]}, 10),
    ({"rampup_begin_step": 0, "sparsity": [0.5]}, 40)],
    ids=["rampup_is_momentum", "sparsified"])
def test_dgc_matches_reference(cfg, steps):
    """DGC's trajectory against the reference's (rtol 1e-5): in the rampup
    window it is plain Momentum's; sparsified, the loss still falls by
    half."""
    nets = both(lambda P: P.nn.Linear(8, 1), 7)
    got = {P: _train(P, net, _dgc(P, net, **cfg), steps)
           for P, net in nets.items()}
    np.testing.assert_allclose(got[pt], got[jx()], rtol=1e-5, atol=1e-7)
    if cfg["rampup_begin_step"]:
        plain = both(lambda P: P.nn.Linear(8, 1), 7)[pt]
        np.testing.assert_allclose(got[pt], _train(
            pt, plain, pt.optimizer.Momentum(
                learning_rate=0.05, momentum=0.9,
                parameters=plain.parameters()), steps), rtol=1e-5)
    else:
        assert got[pt][-1] < got[pt][0] * 0.5


def test_dgc_residual_conservation():
    """Sent + residual conserve the accumulated gradient (momentum 0):
    applied + lr * residual == lr * sum of gradients."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DGCMomentumOptimizer
    pt.seed(0)
    net = pt.nn.Linear(4, 1)
    inner = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.0,
                                  parameters=net.parameters())
    o = DGCMomentumOptimizer(inner, rampup_begin_step=0, sparsity=[0.5],
                             momentum=0.0)
    x = pt.to_tensor(np.eye(4, dtype="float32"))
    y = pt.to_tensor(np.ones((4, 1), "float32"))
    w0 = {id(p): p.numpy().astype("float64") for p in net.parameters()}
    g_total = {id(p): 0.0 for p in net.parameters()}
    for _ in range(5):
        ((net(x) - y) ** 2).mean().backward()
        for p in net.parameters():
            g_total[id(p)] = g_total[id(p)] + p.grad.numpy().astype(
                "float64")
        o.step()
        o.clear_grad()
    for p in net.parameters():
        applied = w0[id(p)] - p.numpy().astype("float64")
        residual = o._v[id(p)].double().numpy()
        np.testing.assert_allclose(applied + 0.1 * residual,
                                   0.1 * g_total[id(p)], rtol=2e-3,
                                   atol=1e-6)


def test_dgc_honors_clip_and_decay():
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DGCMomentumOptimizer
    pt.seed(1)
    net = pt.nn.Linear(4, 1)
    clip = pt.nn.ClipGradByGlobalNorm(1e-8)
    inner = pt.optimizer.Momentum(learning_rate=0.5, momentum=0.0,
                                  parameters=net.parameters(), grad_clip=clip)
    o = DGCMomentumOptimizer(inner, rampup_begin_step=0, sparsity=[0.5],
                             momentum=0.0)
    w0 = [p.numpy().copy() for p in net.parameters()]
    x = pt.to_tensor(np.ones((8, 4), "float32"))
    y = pt.to_tensor(np.ones((8, 1), "float32") * 100)
    ((net(x) - y) ** 2).mean().backward()
    o.step()
    for p, w in zip(net.parameters(), w0):
        np.testing.assert_allclose(p.numpy(), w, atol=1e-5)


def test_dgc_state_dict_roundtrip():
    """The residuals and the rampup position survive save / load: a
    restored optimizer repeats the same 3 steps."""
    pt.seed(3)
    net = pt.nn.Linear(8, 1)
    o = _dgc(pt, net, rampup_begin_step=0, sparsity=[0.5])
    _train(pt, net, o, 3)
    snap = o.state_dict()
    assert "DGC" in snap and o._dgc_steps == 3
    w_snap = [p.numpy().copy() for p in net.parameters()]
    _train(pt, net, o, 3)
    w_after = [p.numpy().copy() for p in net.parameters()]
    for p, w in zip(net.parameters(), w_snap):
        p.set_value(pt.to_tensor(w))
    o2 = _dgc(pt, net, rampup_begin_step=0, sparsity=[0.5])
    o2.set_state_dict(snap)
    assert o2._dgc_steps == 3 and o2._v
    _train(pt, net, o2, 3)
    for p, w in zip(net.parameters(), w_after):
        np.testing.assert_allclose(p.numpy(), w, rtol=1e-4, atol=1e-6)


def test_localsgd_matches_reference_and_inner_sgd():
    def local(P, net):
        P.distributed.fleet.init()
        s = P.distributed.fleet.DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 4, "begin_step": 1}
        return P.distributed.fleet.distributed_optimizer(
            P.optimizer.SGD(learning_rate=0.05, parameters=net.parameters()),
            strategy=s)
    nets = both(lambda P: P.nn.Linear(8, 1), 7)
    got = {P: _train(P, net, local(P, net), 12) for P, net in nets.items()}
    np.testing.assert_allclose(got[pt], got[jx()], rtol=1e-5)
    plain = both(lambda P: P.nn.Linear(8, 1), 7)[pt]
    np.testing.assert_allclose(got[pt], _train(pt, plain, pt.optimizer.SGD(
        learning_rate=0.05, parameters=plain.parameters()), 12), rtol=1e-5)


# ---------------------------------------------------- test_fleet_utils.py

def test_recompute_layer_value_and_grad_parity():
    """Values and every gradient (input and weights) of the recomputed
    call equal the direct call's and the reference's recompute's."""
    nets = both(lambda P: P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(),
                                          P.nn.Linear(8, 4)), 0)
    xv = np.random.RandomState(0).rand(2, 4).astype("float32")
    got = {}
    for P, block in nets.items():
        x = P.to_tensor(xv, stop_gradient=False)
        out = P.distributed.fleet.recompute(block, x)
        out.sum().backward()
        got[P] = [out.numpy(), x.grad.numpy()] + \
            [p.grad.numpy() for p in block.parameters()]
    block = nets[pt]
    x = pt.to_tensor(xv, stop_gradient=False)
    for p in block.parameters():
        p.clear_grad()
    out = block(x)
    out.sum().backward()
    direct = [out.numpy(), x.grad.numpy()] + \
        [p.grad.numpy() for p in block.parameters()]
    for a, b, c in zip(got[pt], direct, got[jx()]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-7)


def test_recompute_plain_function_gets_grads():
    """A function that captures its layer: the weights and the input still
    receive their gradients (the reference falls back to a plain call;
    the port recomputes it)."""
    pt.seed(1)
    lin1 = pt.nn.Linear(4, 4)
    x = pt.to_tensor(np.random.RandomState(1).rand(2, 4).astype("float32"),
                     stop_gradient=False)
    pt.distributed.fleet.recompute(lambda t: lin1(t), x).sum().backward()
    assert lin1.weight.grad is not None and x.grad is not None
    np.testing.assert_allclose(lin1.weight.grad.numpy(),
                               np.tile(x.numpy().sum(0)[:, None], (1, 4)),
                               rtol=1e-6)


def test_local_fs_and_hdfs(tmp_path):
    fs = pt.distributed.fleet.utils.LocalFS()
    p = str(tmp_path / "a")
    fs.mkdirs(p)
    fs.touch(os.path.join(p, "f.txt"))
    dirs, files = fs.ls_dir(str(tmp_path))
    assert dirs == ["a"] and files == []
    fs.mv(os.path.join(p, "f.txt"), str(tmp_path / "g.txt"))
    assert fs.is_file(str(tmp_path / "g.txt"))
    fs.delete(p)
    assert not fs.is_exist(p)
    with pytest.raises(RuntimeError, match="hadoop"):
        pt.distributed.fleet.utils.HDFSClient()
    d = pt.distributed.fleet.utils.DistributedInfer(main_program="prog")
    assert d.get_dist_infer_program() == "prog"


def test_recompute_sequential_matches_reference():
    """incubate.distributed.fleet.recompute_sequential over 2 segments:
    output and input gradient against the reference's."""
    nets = both(lambda P: P.nn.Sequential(P.nn.Linear(4, 4), P.nn.ReLU(),
                                          P.nn.Linear(4, 4)), 0)
    got = {}
    for P, seq in nets.items():
        x = P.to_tensor(np.ones((2, 4), "float32"), stop_gradient=False)
        out = P.incubate.distributed.fleet.recompute_sequential(
            {"segments": 2}, list(seq), x)
        out.sum().backward()
        got[P] = (out.numpy(), x.grad.numpy())
    for a, b in zip(got[pt], got[jx()]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_static_amp_decorate_trains_like_reference():
    """static.amp.decorate over SGD: minimize keeps the reference's
    losses (rtol 1e-5, atol 1e-6 of a loss that starts at 19), which
    fall."""
    nets = both(lambda P: P.nn.Linear(4, 1), 0)
    got = {}
    for P, net in nets.items():
        deco = P.static.amp.decorate(P.optimizer.SGD(
            0.05, parameters=net.parameters()))
        x = P.to_tensor(np.ones((8, 4), "float32"))
        y = P.to_tensor(np.ones((8, 1), "float32") * 3)
        losses = []
        for _ in range(15):
            loss = ((net(x) - y) ** 2).mean()
            deco.minimize(loss)
            deco.clear_grad()
            losses.append(float(loss))
        got[P] = losses
    np.testing.assert_allclose(got[pt], got[jx()], rtol=1e-5, atol=1e-6)
    assert got[pt][-1] < got[pt][0]


def test_custom_op_lists_and_passes():
    ls = pt.static.amp.CustomOpLists(custom_white_list=["matmul"])
    assert "matmul" in ls.white_list
    passes = pt.distributed.passes
    pm = passes.PassManager([passes.new_pass("recompute")])
    pm.apply()
    assert pm.context.get_attr("recompute")
    with pytest.raises(ValueError):
        passes.new_pass("not_a_pass").apply()
