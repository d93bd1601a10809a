"""The port's `distributed.env`, `TCPStore`, `DataParallel` and `Model`'s dp
route in one process, against the JAX package on its 8 virtual CPU
devices.

The port counts ranks where the reference counts devices (ROADMAP C.21):
with a mesh installed, the port's ranks are the reference's devices, and
the two agree on every group size and rank; with none, the reference's
world is `jax.device_count()` (8 here) and the port's one process is one
rank. The tests compare through that map.

`Model` on a one-process dp mesh computes the reference's global-batch
step (`tests/test_hapi_dp.py`): the MLP of that file and a small CNN with
BatchNorm train from the JAX weights (carried with `set_state_dict`) to
the reference's dp-mesh losses at rtol 2e-5 (f32), and a ragged batch
takes the plain step in both. The TCPStore tests are the port's
counterparts of `tests/test_native.py`'s store tests.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.distributed import env as jenv
from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import env

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def fresh_env(monkeypatch):
    """Both packages' env state back to 'nothing installed' for a test,
    and restored after it."""
    pt.set_device("cpu")
    for mod in (env, jenv):
        monkeypatch.setattr(mod, "_global_mesh", None)
        monkeypatch.setattr(mod, "_initialized", False)
    monkeypatch.delenv("PADDLE_TRAINERS_NUM", raising=False)
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    yield


def carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


# ------------------------------------------------------------------ env

def test_init_parallel_env_one_process():
    penv = pt.distributed.init_parallel_env()
    jpenv = pj.distributed.init_parallel_env()
    # the reference's world is its 8 devices; the port's one process is
    # one rank
    assert (jpenv.world_size, jpenv.rank) == (8, 0)
    assert (penv.world_size, penv.rank, penv.nranks) == (1, 0, 1)
    assert env.get_mesh().dims == {"dp": 1}
    assert jenv.get_mesh().shape["dp"] == 8
    assert pt.distributed.get_backend() == "local"
    assert pt.distributed.is_initialized()
    assert penv.device_id == 0 and penv.local_rank == 0
    assert penv.current_endpoint == jpenv.current_endpoint


def test_init_without_address_raises(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    # the reference carries on as one process (ROADMAP C.21)
    assert pj.distributed.init_parallel_env().rank == 0
    with pytest.raises(RuntimeError, match="PADDLE_MASTER"):
        pt.distributed.init_parallel_env()


def test_init_after_build_mesh_still_needs_an_address(monkeypatch):
    # a mesh installed first must not stand in for the process group
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    env.build_mesh({"dp": 2})
    with pytest.raises(RuntimeError, match="PADDLE_MASTER"):
        pt.distributed.init_parallel_env()


def test_ranks_versus_devices_map():
    # no mesh: the reference counts its devices, the port its one rank
    assert pj.distributed.get_world_size() == 8
    assert pt.distributed.get_world_size() == 1
    assert pt.distributed.get_rank() == pj.distributed.get_rank() == 0
    # a mesh: the port's ranks are the reference's devices
    jm = jenv.build_mesh({"dp": 2, "mp": 4})
    pm = env.build_mesh({"dp": 2, "mp": 4})
    assert pm.dims == dict(jm.shape) and pm.size == jm.size == 8
    assert pm.local_ranks == list(range(8)) and pm.nproc == 1
    assert pt.distributed.get_world_size() == pj.distributed.get_world_size()
    for P in (pj, pt):
        assert P.distributed.get_group().nranks == 8
    for axis in ("dp", "mp"):
        jg = pj.distributed.new_group(axis_name=axis)
        pg = pt.distributed.new_group(axis_name=axis)
        assert (pg.nranks, pg.rank, pg.world_size) == \
            (jg.nranks, jg.rank, jg.world_size)
        assert pg.process_ids == jg.process_ids
        assert pg.get_group_rank(3) == jg.get_group_rank(3)
    jw = pj.distributed.new_group(list(range(8)))
    pw = pt.distributed.new_group(list(range(8)))
    assert (pw.nranks, pw.rank, pw.get_group_rank(5)) == \
        (jw.nranks, jw.rank, jw.get_group_rank(5))
    for P in (pj, pt):
        with pytest.raises(NotImplementedError, match="rank subsets"):
            P.distributed.new_group([0, 1])
    assert env.axis_size("mp") == jenv.axis_size("mp") == 4
    assert env.axis_size(pm, "dp") == jenv.axis_size(jm, "dp") == 2
    assert env.axis_index("mp") == [0, 1, 2, 3] * 2


def test_mesh_devices_and_sampler_defaults():
    m = env.build_mesh({"dp": 4}, devices=["cpu"])
    assert [str(d) for d in m.devices] == ["cpu"] * 4
    with pytest.raises(ValueError, match="devices"):
        env.build_mesh({"dp": 4}, devices=["cpu"] * 3)
    # the port's world is its mesh's ranks; the reference's its devices
    assert pt.io.DistributedBatchSampler(list(range(10)), 2).nranks == 4
    env.build_mesh({"dp": 8})
    jenv.build_mesh({"dp": 8})
    for P in (pj, pt):
        s = P.io.DistributedBatchSampler(list(range(10)), 2)
        assert (s.nranks, s.local_rank) == (8, 0)


def test_axis_context_and_live_axes():
    for E in (env, jenv):
        assert not E.in_manual_region()
        with E.axis_context(dp="dp", mp="mp"):
            assert E.in_manual_region()
            assert E.current_axis_name("dp") == "dp"
            with E.axis_context(dp="x"):
                assert E.current_axis_name("dp") == "x"
            assert E.current_axis_name("dp") == "dp"
        assert E.current_axis_name("dp") is None
    assert env.HYBRID_AXES == jenv.HYBRID_AXES


def test_spawn_calls_once_after_init():
    calls = []
    pt.distributed.spawn(lambda a, b: calls.append((a, b)), args=(1, 2),
                         nprocs=4)
    assert calls == [(1, 2)] and env.is_initialized()


def test_split_raises_naming_its_slice():
    """split builds fleet's mp layers (an embedding here, equal to the
    plain lookup of the same seeded weight without a live mp axis) and
    raises naming the operations it takes for any other."""
    ids = pt.to_tensor(np.array([[0, 1]], "int64"))
    pt.seed(3)
    got = pt.distributed.split(ids, (8, 4), "embedding")
    pt.seed(3)
    want = pt.distributed.fleet.layers.mp_layers.VocabParallelEmbedding(
        8, 4)(ids)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="embedding.linear"):
        pt.distributed.split(ids, (8, 4), "conv")


# ------------------------------------------------------------- the store

def test_store_set_get_add():
    assert native.available("kvstore"), native.build_error("kvstore")
    s = native.TCPStoreServer()
    c = native.TCPStoreClient(port=s.port)
    c.set("alpha", b"1")
    assert c.get("alpha") == b"1"
    assert c.get("nope") is None
    assert c.add("n", 3) == 3
    assert c.add("n", 4) == 7
    c.delete("alpha")
    assert c.get("alpha") is None
    c.close()
    s.stop()
    assert native.library_path("kvstore") != native.library_path()
    with pytest.raises(ValueError, match="unknown native source"):
        native.library_path("nope")


def test_store_wait_blocks_until_set():
    s = native.TCPStoreServer()
    c1 = native.TCPStoreClient(port=s.port)
    c2 = native.TCPStoreClient(port=s.port)
    got = {}

    def waiter():
        got["v"] = c1.wait("late-key")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    assert "v" not in got
    c2.set("late-key", b"now")
    t.join(timeout=5)
    assert not t.is_alive()
    assert got["v"] == b"now"
    c1.close()
    c2.close()
    s.stop()


def test_store_wait_timeout():
    s = native.TCPStoreServer()
    c = native.TCPStoreClient(port=s.port)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        c.wait("never-set", timeout_ms=300)
    assert 0.2 < time.monotonic() - t0 < 5.0
    # the connection stays usable after a timed-out wait
    c.set("k", b"v")
    assert c.wait("k", timeout_ms=1000) == b"v"
    c.close()
    s.stop()


def test_tcpstore_wait_applies_store_timeout():
    st = pt.distributed.TCPStore(is_master=True, world_size=2, timeout=0.3)
    with pytest.raises(TimeoutError):
        st.wait("absent")
    st.set("k", "v")
    assert st.get("k") == b"v" and st.get_nowait("zz") is None
    st.delete_key("k")
    assert st.get_nowait("k") is None
    st.stop()


def test_tcpstore_class_barrier():
    master = pt.distributed.TCPStore(is_master=True, world_size=3)
    peers = [pt.distributed.TCPStore(port=master.port, world_size=3)
             for _ in range(2)]
    stores = [master] + peers
    done = []

    def arrive(st, delay):
        time.sleep(delay)
        for _ in range(2):               # the same name, twice
            st.barrier("b1")
        done.append(time.monotonic())

    ts = [threading.Thread(target=arrive, args=(st, 0.1 * i))
          for i, st in enumerate(stores)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert len(done) == 3
    # all released within a short window of each other
    assert max(done) - min(done) < 1.0
    for st in stores:
        st.stop()


# ------------------------------------------------------- DataParallel

def test_data_parallel_is_transparent():
    lin = pt.nn.Linear(4, 3)
    dp = pt.DataParallel(lin)
    x = pt.to_tensor(np.random.RandomState(0).rand(2, 4).astype("float32"))
    np.testing.assert_array_equal(dp(x).numpy(), lin(x).numpy())
    assert list(dp.state_dict()) == list(lin.state_dict())
    assert dp.scale_loss(x) is x
    dp(x).sum().backward()
    g = lin.weight.grad.numpy().copy()
    dp.apply_collective_grads()           # one process: nothing to average
    np.testing.assert_array_equal(lin.weight.grad.numpy(), g)
    jdp = pj.DataParallel(pj.nn.Linear(4, 3))
    assert list(jdp.state_dict()) == list(dp.state_dict())


# -------------------------------------------------------- Model's dp route

def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Flatten(), nn.Linear(12, 32), nn.ReLU(),
                         nn.Linear(32, 4))


def _cnn(P):
    nn = P.nn

    class CNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(3, 4, 3, padding=1)
            self.bn = nn.BatchNorm2D(4)
            self.fc = nn.Linear(4 * 8 * 8, 3)

        def forward(self, x):
            return self.fc(P.nn.functional.relu(self.bn(self.conv(x)))
                           .flatten(1))
    return CNN()


def _fit(P, net, opt, data, mesh_fn):
    mesh = mesh_fn()
    m = P.Model(net)
    m.prepare(opt(P, net.parameters()), P.nn.CrossEntropyLoss())
    losses = [m.train_batch([x], [y])[0][0] for x, y in data]
    return m, mesh, losses


MODEL_CASES = {
    "mlp_adam": (_mlp, lambda P, ps: P.optimizer.Adam(1e-2, parameters=ps),
                 lambda rng: (rng.rand(16, 12).astype("float32"),
                              rng.randint(0, 4, 16))),
    "cnn_batchnorm_momentum": (
        _cnn, lambda P, ps: P.optimizer.Momentum(0.05, momentum=0.9,
                                                 parameters=ps),
        lambda rng: (rng.rand(16, 3, 8, 8).astype("float32") * 2 - 0.5,
                     rng.randint(0, 3, 16))),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_dp_mesh_matches_the_reference(case):
    make, opt, draw = MODEL_CASES[case]
    rng = np.random.RandomState(0)
    data = [draw(rng) for _ in range(3)]
    pj.seed(3)
    jnet = make(pj)
    pnet = make(pt)
    carry(jnet, pnet)
    jm, jmesh, jl = _fit(pj, jnet, opt, data,
                         lambda: jenv.build_mesh({"dp": 8}))
    pm, pmesh, pl = _fit(pt, pnet, opt, data,
                         lambda: env.build_mesh({"dp": 8}))
    assert jm._dp_mesh() is jmesh and pm._dp_mesh() is pmesh
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)
    for k, v in jnet.state_dict().items():
        np.testing.assert_allclose(pnet.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-5,
                                   atol=1e-5)


def test_model_dp_ragged_batch_takes_the_plain_step():
    pj.seed(0)
    jnet, pnet = pj.nn.Sequential(pj.nn.Linear(8, 4)), \
        pt.nn.Sequential(pt.nn.Linear(8, 4))
    carry(jnet, pnet)
    rng = np.random.RandomState(1)
    data = [(rng.rand(b, 8).astype("float32"), rng.randint(0, 4, b))
            for b in (16, 13)]
    opt = lambda P, ps: P.optimizer.SGD(0.1, parameters=ps)  # noqa: E731
    jm, _, jl = _fit(pj, jnet, opt, data, lambda: jenv.build_mesh({"dp": 8}))
    pm, _, pl = _fit(pt, pnet, opt, data, lambda: env.build_mesh({"dp": 8}))
    assert jm._train_step_plain is not None
    assert pm._train_step_plain is not None
    np.testing.assert_allclose(pl, jl, **LOSS_TOL)


def test_model_refuses_routes_of_the_next_slice():
    """Over a pp mesh Model needs a PipelineLayer; the pipeline runner
    over a mesh split over processes needs each stage's ranks in one
    process (pp first in the mesh's order)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.pp_compiled \
        import make_compiled_pipeline_step
    env.build_mesh({"pp": 2})
    m = pt.Model(pt.nn.Linear(4, 2))
    m.prepare(pt.optimizer.SGD(0.1, parameters=m.parameters()),
              pt.nn.CrossEntropyLoss())
    with pytest.raises(ValueError, match="PipelineLayer"):
        m.train_batch([np.ones((2, 4), "float32")], [np.zeros(2, "int64")])
    pl = PipelineLayer([LayerDesc(pt.nn.Linear, 4, 4)] * 2, num_stages=2,
                       loss_fn=pt.nn.MSELoss())
    dev = [pt.core.device.place_device()]
    split = env.new_mesh({"dp": 2, "pp": 2}, dev, 2, 0)
    with pytest.raises(ValueError, match=r"order=\('pp',\)"):
        make_compiled_pipeline_step(pl, split, 2)
    by_stage = env.new_mesh({"dp": 2, "pp": 2}, dev, 2, 0, order=("pp",))
    step = make_compiled_pipeline_step(pl, by_stage, 2)
    assert step.stage_devices[1] is None      # stage 1: the other process
