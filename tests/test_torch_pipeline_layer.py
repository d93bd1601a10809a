"""`fleet.meta_parallel`'s PipelineLayer, PipelineParallel and the
pipeline runner against the JAX package, one process on the CPU: the
counterparts of `tests/test_fleet_apis.py`'s pipeline tests,
`tests/test_pipeline_schedules.py::test_generic_pipeline_layer_compiled_parity`
and `tests/test_det_nlp_models.py::test_ernie_pipeline_descs`.

Networks are built in both packages and the JAX weights carried over;
losses, gradients and weights are held to the JAX package's at the
reference test's tolerance (f32).
"""
import importlib

import numpy as np
import pytest
import torch

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


def mp_(P):
    return importlib.import_module(
        f"{P.__name__}.distributed.fleet.meta_parallel")


def both(factory, seed):
    pj = jx()
    pj.seed(seed)
    jnet = factory(pj)
    pnet = factory(pt)
    missing, unexpected = pnet.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()})
    assert missing == [] and unexpected == []
    return {pj: jnet, pt: pnet}


def test_segmentation_uniform_param_and_layer():
    """Stage boundaries equal the reference's for every seg_method."""
    def descs(P):
        m = mp_(P)
        return [m.LayerDesc(P.nn.Linear, 8, 8),
                m.LayerDesc(P.nn.Linear, 8, 128),
                m.LayerDesc(P.nn.Linear, 128, 8),
                m.LayerDesc(P.nn.Linear, 8, 8), m.LayerDesc(P.nn.ReLU),
                m.LayerDesc(P.nn.Linear, 8, 8)]
    for method, k in (("uniform", 3), ("param", 2), ("uniform", 2),
                      ("layer:Linear", 2)):
        got = {}
        for P in (jx(), pt):
            pl = mp_(P).PipelineLayer(descs(P), num_stages=k,
                                      seg_method=method)
            got[P] = (pl._boundaries, [len(pl.get_stage_layers(s))
                                       for s in range(k)],
                      [pl.stage_of_layer(i) for i in range(6)])
        assert got[pt] == got[jx()], method


def test_pipeline_shared_layer_is_same_object():
    m = mp_(pt)
    descs = [m.SharedLayerDesc("embed", pt.nn.Linear, None, "weight", 8, 8),
             m.LayerDesc(pt.nn.Linear, 8, 8),
             m.SharedLayerDesc("embed", pt.nn.Linear, None, "weight", 8, 8)]
    layers = m.PipelineLayer(descs, num_stages=1).get_stage_layers(0)
    assert layers[0] is layers[2]


def _mlp_pipe(P, d=8):
    m = mp_(P)
    return m.PipelineLayer(
        [m.LayerDesc(P.nn.Linear, d, 32), m.LayerDesc(P.nn.ReLU),
         m.LayerDesc(P.nn.Linear, 32, 32), m.LayerDesc(P.nn.ReLU),
         m.LayerDesc(P.nn.Linear, 32, 4)],
        num_stages=2, loss_fn=P.nn.CrossEntropyLoss())


@pytest.mark.parametrize("steps,schedule", [(3, "1F1B"), (3, "FThenB")],
                         ids=["1f1b", "gpipe"])
def test_fleet_pipeline_train_batch_matches_reference(steps, schedule):
    """fleet.distributed_model over dp=4 x pp=2 with accumulate_steps 4
    (the pipeline runner): each step's loss and the final weights against
    the reference's compiled pipeline (rtol 3e-5, atol 3e-6), and the
    runner really ran."""
    nets = both(_mlp_pipe, 11)
    rng = np.random.RandomState(3)
    data = [(rng.rand(16, 8).astype("float32"), rng.randint(0, 4, 16))
            for _ in range(steps)]
    got = {}
    for P, pl in nets.items():
        fleet = P.distributed.fleet
        s = fleet.DistributedStrategy()
        s.hybrid_configs["pp_degree"] = 2
        s.hybrid_configs["dp_degree"] = 4
        s.pipeline_configs["accumulate_steps"] = 4
        s.pipeline_configs["schedule_mode"] = schedule
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(pl)
        assert type(model).__name__ == "PipelineParallel"
        o = P.optimizer.SGD(0.1, parameters=pl.parameters())
        got[P] = [float(model.train_batch((P.to_tensor(x), P.to_tensor(y)),
                                          o)) for x, y in data]
        assert model._compiled_step is not None
    np.testing.assert_allclose(got[pt], got[jx()], rtol=3e-5, atol=1e-6)
    w = {P: dict(pl.named_parameters())["seg_0.weight"].numpy()
         for P, pl in nets.items()}
    np.testing.assert_allclose(w[pt], w[jx()], rtol=3e-5, atol=3e-6)


def test_pipeline_train_batch_loop_matches_serial():
    """Without a pp mesh train_batch runs the micro-batch loop: equal to
    the serial step of the same weights (rtol 2e-5)."""
    nets = both(lambda P: _mlp_pipe(P), 7)
    pl = nets[pt]
    golden = pt.nn.Sequential(pt.nn.Linear(8, 32), pt.nn.ReLU(),
                              pt.nn.Linear(32, 32), pt.nn.ReLU(),
                              pt.nn.Linear(32, 4))
    golden.set_state_dict({k.replace("seg_", ""): v
                           for k, v in pl.state_dict().items()})
    strategy = pt.distributed.fleet.DistributedStrategy()
    strategy.pipeline_configs["accumulate_steps"] = 4
    pp = mp_(pt).PipelineParallel(pl, strategy=strategy)
    rng = np.random.RandomState(0)
    x = pt.to_tensor(rng.rand(32, 8).astype("float32"))
    y = pt.to_tensor(rng.randint(0, 4, 32))
    o_pp = pt.optimizer.SGD(0.1, parameters=pl.parameters())
    o_g = pt.optimizer.SGD(0.1, parameters=golden.parameters())
    loss_pp = pp.train_batch((x, y), o_pp)
    loss_g = pt.nn.CrossEntropyLoss()(golden(x), y)
    loss_g.backward()
    o_g.step()
    np.testing.assert_allclose(float(loss_pp), float(loss_g), rtol=2e-5)
    np.testing.assert_allclose(dict(pl.named_parameters())["seg_0.weight"]
                               .numpy(), golden[0].weight.numpy(),
                               rtol=2e-5, atol=2e-6)
    assert np.isfinite(float(pp.eval_batch((x, y))))


def _step_both(nets, dims, M, x, y, schedule="1f1b"):
    from paddle_tpu.distributed.fleet.meta_parallel.pp_compiled import \
        make_compiled_pipeline_step as jmake
    from paddle_tpu.nn.layer.layers import functional_state as jstate
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_compiled \
        import make_compiled_pipeline_step as pmake
    from paddle_tpu_torch.nn.layer.layers import functional_state as pstate
    out = {}
    for P, pl in nets.items():
        env = importlib.import_module(f"{P.__name__}.distributed.env")
        env.build_mesh(dims)
        if P is pt:
            step = pmake(pl, env.get_mesh(), microbatches=M,
                         schedule=schedule)
            params, buffers = pstate(pl)
            loss, grads, _ = step(params, buffers, torch.from_numpy(x),
                                  torch.from_numpy(y))
            out[P] = (float(loss), {n: g.double().numpy()
                                    for n, g in grads.items()}, step)
        else:
            step = jmake(pl, env.get_mesh(), microbatches=M)
            params, buffers = jstate(pl)
            loss, grads, _ = step(params, buffers, x, y)
            out[P] = (float(loss), {n: np.asarray(g, np.float64)
                                    for n, g in grads.items()}, step)
    return out


def test_runner_owns_params_per_stage_and_matches_reference():
    """seg_method "param" over 2 stages: each stage's device holds its own
    parameters (under 3/4 of the total), none is replicated, and the loss
    and gradients equal the reference's compiled step (rtol 2e-4, atol
    2e-5)."""
    def make(P):
        m = mp_(P)
        return m.PipelineLayer(
            [m.LayerDesc(P.nn.Linear, 16, 64), m.LayerDesc(P.nn.ReLU),
             m.LayerDesc(P.nn.Linear, 64, 64), m.LayerDesc(P.nn.ReLU),
             m.LayerDesc(P.nn.Linear, 64, 64), m.LayerDesc(P.nn.ReLU),
             m.LayerDesc(P.nn.Linear, 64, 4)],
            num_stages=2, loss_fn=P.nn.CrossEntropyLoss(), seg_method="param")
    rng = np.random.RandomState(0)
    x = rng.rand(16, 16).astype("float32")
    y = rng.randint(0, 4, 16)
    nets = both(make, 11)
    total = sum(p.numel() * 4 for p in nets[pt].parameters())
    got = _step_both(nets, {"pp": 2}, 4, x, y)
    (pl_, pg, step), (jl, jg, jstep) = got[pt], got[jx()]
    assert step.packed_bytes_per_device < 0.75 * total
    assert step.packed_bytes_per_device == jstep.packed_bytes_per_device
    assert step.replicated_param_bytes == 0
    assert 1 <= max(step.stats["peak_live"]) <= step.stats["slots"]
    np.testing.assert_allclose(pl_, jl, rtol=2e-5)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], rtol=2e-4, atol=2e-5,
                                   err_msg=n)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_runner_shared_layer_gets_both_stages_grads(schedule):
    """A SharedLayerDesc used by the first and last stage: its gradient
    sums both stages' parts; loss and gradients against the reference's
    step (rtol 2e-4, atol 2e-5) under either schedule."""
    def make(P):
        m = mp_(P)
        return m.PipelineLayer(
            [m.SharedLayerDesc("tied", P.nn.Linear, forward_func=None,
                               shared_weight_attr="weight", in_features=8,
                               out_features=8),
             m.LayerDesc(P.nn.ReLU), m.LayerDesc(P.nn.Linear, 8, 8),
             m.LayerDesc(P.nn.ReLU),
             m.SharedLayerDesc("tied", P.nn.Linear, forward_func=None,
                               shared_weight_attr="weight", in_features=8,
                               out_features=8)],
            num_stages=2, loss_fn=P.nn.MSELoss())
    rng = np.random.RandomState(3)
    x = rng.rand(8, 8).astype("float32")
    y = rng.rand(8, 8).astype("float32")
    got = _step_both(both(make, 13), {"pp": 2}, 2, x, y, schedule)
    (pl_, pg, step), (jl, jg, jstep) = got[pt], got[jx()]
    assert step.replicated_param_bytes == jstep.replicated_param_bytes > 0
    np.testing.assert_allclose(pl_, jl, rtol=2e-5)
    for n in jg:
        np.testing.assert_allclose(pg[n], jg[n], rtol=2e-4, atol=2e-5,
                                   err_msg=n)


def test_runner_refuses_what_the_reference_refuses():
    m = mp_(pt)
    pt.distributed.env.build_mesh({"pp": 2})
    mesh = pt.distributed.env.get_mesh()
    make = m.pp_compiled.make_compiled_pipeline_step
    pl = _mlp_pipe(pt)
    with pytest.raises(ValueError, match="schedule"):
        make(pl, mesh, 2, schedule="zigzag")
    with pytest.raises(ValueError, match="pp >= 2"):
        make(pl, pt.distributed.env.build_mesh({"dp": 2}), 2)
    with pytest.raises(ValueError, match="loss_fn"):
        make(m.PipelineLayer([m.LayerDesc(pt.nn.Linear, 4, 4)] * 2,
                             num_stages=2), mesh, 2)


def test_ernie_pipeline_descs_match_reference():
    """ernie_pipeline_descs over 2 stages: the embedding tied to the head
    through one shared Layer, and the whole stack's logits against the
    reference's from the same weights (rtol 1e-4, atol 1e-5)."""
    def make(P):
        tm = importlib.import_module(f"{P.__name__}.text.models.ernie")
        cfg = tm.ernie_tiny_config()
        return mp_(P).PipelineLayer(tm.ernie_pipeline_descs(cfg),
                                    num_stages=2,
                                    loss_fn=P.nn.CrossEntropyLoss())
    nets = both(make, 2)
    ids = np.random.RandomState(3).randint(0, 1000, (2, 8))
    got = {}
    for P, pl in nets.items():
        assert pl.get_num_stages() == 2
        pl.eval()
        got[P] = pl(P.to_tensor(ids)).numpy()
    assert got[pt].shape == (2, 8, 1000)
    np.testing.assert_allclose(got[pt], got[jx()], rtol=1e-4, atol=1e-5)
    pl = nets[pt]
    first, last = pl.get_stage_layers(0)[0], pl.get_stage_layers(1)[-1]
    assert first is last
    assert len(pl._shared) == 1


def test_pipeline_parallel_steps_lr_scheduler():
    """train_batch steps an lr scheduler once a batch (ReduceOnPlateau is
    left to the user), as the reference does."""
    pl = _mlp_pipe(pt)
    sched = pt.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
    o = pt.optimizer.SGD(sched, parameters=pl.parameters())
    strategy = pt.distributed.fleet.DistributedStrategy()
    strategy.pipeline_configs["accumulate_steps"] = 2
    pp = mp_(pt).PipelineParallel(pl, strategy=strategy)
    x = pt.to_tensor(np.ones((4, 8), "float32"))
    y = pt.to_tensor(np.zeros((4,), "int64"))
    pp.train_batch((x, y), o, lr_scheduler=sched)
    pp.train_batch((x, y), o, lr_scheduler=sched)
    assert o.get_lr() == pytest.approx(0.025)
