"""The port's collectives in one process, against the JAX package on its 8
virtual CPU devices.

  * Eagerly over a one-process mesh axis (`build_mesh({"dp": 8})`, an
    explicit axis group): the reference takes the value as replicated
    over the axis (`_eager_axis_op`), so SUM gives 8·x and PROD x**8; its
    other collectives raise an unbound axis name. The port is held to
    each call's result (f32 exactly, integers exactly, dtypes through
    C.14's width map: the port's int64 is the reference's int32).
  * With no mesh and no live axis every collective is the single
    participant's identity in both.
  * In a manual region: the port's one-controller list collectives over
    the 8 ranks of the mesh against the reference's collective calls
    inside `shard_map` over its 8 devices, on the same per-rank values
    (exact: sums of small integers in f32).
  * The `comm.<kind>` Communication spans carry the reference's
    attributes (`tests/test_profiler_statistic.py:70-88`).
  * The namespace extras of `tests/test_namespace_completion.py:171-183`
    and `tests/test_final_namespaces.py:156-166` (`split` is tested in
    `tests/test_torch_dist_env.py` and, across processes, in
    `tests/test_torch_dist_hybrid.py`).
"""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed import env as jenv
from paddle_tpu_torch.distributed import env

OPS = ("SUM", "MAX", "MIN", "PROD", "AVG")


@pytest.fixture(autouse=True)
def fresh_env(monkeypatch):
    pt.set_device("cpu")
    for mod in (env, jenv):
        monkeypatch.setattr(mod, "_global_mesh", None)
        monkeypatch.setattr(mod, "_initialized", False)
    yield


def both_meshes():
    jenv.build_mesh({"dp": 8})
    env.build_mesh({"dp": 8})


def as_np(t):
    return np.asarray(t.numpy())


# ------------------------------------------------ eager, one-process mesh

@pytest.mark.parametrize("dtype", ["float32", "int"])
@pytest.mark.parametrize("op", OPS)
def test_eager_axis_reduce_matches_the_reference(op, dtype):
    both_meshes()
    v = [1.5, 2.0] if dtype == "float32" else [1, 2]
    jt = pj.to_tensor(np.asarray(v, "float32" if dtype == "float32"
                                 else "int32"))
    pt_ = pt.to_tensor(np.asarray(v, "float32" if dtype == "float32"
                                  else "int64"))
    for P_, t in ((pj, jt), (pt, pt_)):
        g = P_.distributed.new_group(axis_name="dp")
        P_.distributed.all_reduce(t, getattr(P_.distributed.ReduceOp, op),
                                  group=g)
    np.testing.assert_array_equal(as_np(pt_), as_np(jt))
    widths = {"float32": "float32", "int32": "int64"}
    assert str(pt_.numpy().dtype) == widths[str(jt.numpy().dtype)]
    if op == "SUM":
        np.testing.assert_array_equal(as_np(pt_), np.asarray(v) * 8)


def test_eager_axis_broadcast_reduce_and_raises():
    both_meshes()
    for P_ in (pj, pt):
        D = P_.distributed
        g = D.new_group(axis_name="dp")
        t = P_.to_tensor(np.float32([1.5, 2.0]))
        assert as_np(D.broadcast(t, src=3, group=g)).tolist() == [1.5, 2.0]
        assert as_np(D.reduce(P_.to_tensor(np.float32([1.0, 2.0])), 0,
                              group=g)).tolist() == [8.0, 16.0]
        D.barrier(g)
        D.barrier()
        x = P_.to_tensor(np.arange(16, dtype="float32"))
        for call in (lambda: D.all_gather([], x, group=g),
                     lambda: D.all_gather_concat(x, group=g),
                     lambda: D.reduce_scatter(x, group=g),
                     lambda: D.alltoall([x[:1]] * 8, [], group=g),
                     lambda: D.alltoall_single(x[:8], group=g),
                     lambda: D.scatter(x[:2], [x[:2]] * 8, group=g)):
            with pytest.raises(NameError, match="unbound axis name"):
                call()


def test_identity_without_mesh_or_live_axis():
    for P_ in (pj, pt):
        D = P_.distributed
        t = P_.to_tensor(np.float32([1.5, 2.0]))
        for op in OPS:
            D.all_reduce(t, getattr(D.ReduceOp, op))
        D.broadcast(t, src=0)
        assert as_np(t).tolist() == [1.5, 2.0]
        got = D.all_gather([], t)
        assert [as_np(g).tolist() for g in got] == [[1.5, 2.0]]
        x = P_.to_tensor(np.arange(4, dtype="float32"))
        assert as_np(D.reduce_scatter(x)).tolist() == [0.0, 1.0, 2.0, 3.0]
        assert as_np(D.all_gather_concat(x)).tolist() == [0.0, 1.0, 2.0, 3.0]
        assert as_np(D.send(x, 1)).tolist() == [0.0, 1.0, 2.0, 3.0]
        assert as_np(D.p2p_shift(x)).tolist() == [0.0, 1.0, 2.0, 3.0]
        out = D.alltoall([x[i:i + 1] for i in range(4)], [])
        assert [as_np(o).tolist() for o in out] == [[0.0], [1.0], [2.0],
                                                   [3.0]]
        assert D.is_initialized() is False
    assert pt.distributed.get_backend() == "local"
    assert pj.distributed.get_backend() == "xla"


# ------------------------------------------------------- manual regions

def jax_region(call, vals):
    """The reference's collective `call(Tensor)` inside shard_map over the
    8 devices, each holding vals[i]; returns the 8 results stacked."""
    mesh = jenv.build_mesh({"dp": 8})

    def body(x):
        t = JTensor(x[0])
        with jenv.axis_context(dp="dp"):
            out = call(pj.distributed, t)
        out = out[0] if isinstance(out, list) else out
        return out._data[None]

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("dp"),
                              out_specs=P("dp"), check_vma=False))
    return np.asarray(f(vals))


def port_region(call, vals):
    mesh = env.build_mesh({"dp": 8})
    xs = [pt.to_tensor(vals[r]) for r in mesh.local_ranks]
    with env.axis_context(dp="dp"):
        out = call(pt.distributed, xs)
    return np.stack([as_np(o) for o in out])


def _grp(D):
    return D.new_group(axis_name="dp")


REGION = {
    **{f"all_reduce_{op.lower()}": (
        lambda D, t, op=op: D.all_reduce(t, getattr(D.ReduceOp, op)), 4)
        for op in OPS},
    "broadcast_src3": (lambda D, t: D.broadcast(t, src=3), 4),
    "all_gather_concat": (lambda D, t: D.all_gather_concat(t, group=_grp(D)),
                          4),
    "reduce_scatter_sum": (lambda D, t: D.reduce_scatter(t, group=_grp(D)),
                           16),
    "reduce_scatter_max": (lambda D, t: D.reduce_scatter(
        t, op=D.ReduceOp.MAX, group=_grp(D)), 16),
    "alltoall_single": (lambda D, t: D.alltoall_single(t, group=_grp(D)), 8),
    "p2p_shift": (lambda D, t: D.p2p_shift(t, group=_grp(D)), 4),
    "all_gather": (lambda D, t: D.all_gather(None, t, group=_grp(D)), 4),
}


@pytest.mark.parametrize("case", sorted(REGION))
def test_region_collective_matches_shard_map(case):
    call, k = REGION[case]
    rng = np.random.RandomState(len(case))
    vals = rng.randint(1, 4, (8, k)).astype("float32")
    want = jax_region(call, vals)
    got = port_region(call, vals)
    np.testing.assert_array_equal(got, want)


def test_region_integer_sum_and_barrier():
    env.build_mesh({"dp": 8})
    xs = [pt.to_tensor(np.int64([r + 1])) for r in range(8)]
    with env.axis_context(dp="dp"):
        pt.distributed.all_reduce(xs)
        with pytest.raises(RuntimeError, match="manual region"):
            pt.distributed.barrier()
    assert [int(x) for x in xs] == [36] * 8
    jenv.build_mesh({"dp": 8})
    with jenv.axis_context(dp="dp"):
        with pytest.raises(RuntimeError, match="manual region"):
            pj.distributed.barrier()


# ---------------------------------------------------------------- spans

def test_communication_spans_match_the_reference():
    from paddle_tpu.profiler import Profiler as JProfiler
    from paddle_tpu_torch.profiler import Profiler
    spans = {}
    for name, P_, prof in (("jax", pj, JProfiler(timer_only=True)),
                           ("port", pt, Profiler(timer_only=True,
                                                 device="cpu"))):
        with prof:
            t = P_.to_tensor(np.ones(4, np.float32))
            P_.distributed.all_reduce(t)
            P_.distributed.broadcast(P_.to_tensor(np.ones((2, 3),
                                                          np.float32)))
        spans[name] = [(e["name"], e["attrs"]) for e in prof._events
                       if e["type"] == "Communication"]
    assert spans["port"][0] == ("comm.all_reduce", {
        "collective": "all_reduce", "payload_bytes": 16, "group_size": 1})
    # the group sizes differ by the ranks-versus-devices map (C.21)
    for (jn, ja), (pn, pa) in zip(spans["jax"], spans["port"]):
        assert jn == pn
        assert {k: v for k, v in ja.items() if k != "group_size"} == \
            {k: v for k, v in pa.items() if k != "group_size"}
        assert (ja["group_size"], pa["group_size"]) == (8, 1)
    assert len(spans["port"]) == len(spans["jax"]) == 2


# ------------------------------------------------------ namespace extras

def test_distributed_extras():
    objs = []
    pt.distributed.all_gather_object(objs, ("x", 3))
    assert objs == [("x", 3)]
    t = pt.distributed.isend(pt.to_tensor(np.ones(2, "float32")))
    assert t.wait() and t.is_completed()
    t = pt.distributed.irecv(pt.to_tensor(np.ones(2, "float32")))
    assert t.wait() and t.is_completed()
    assert pt.distributed.ParallelMode.TENSOR_PARALLEL == \
        pj.distributed.ParallelMode.TENSOR_PARALLEL == 1
    with pytest.raises(ValueError):
        pt.distributed.ProbabilityEntry(1.5)
    with pytest.raises(ValueError):
        pt.distributed.CountFilterEntry(-1)
    for P_ in (pj, pt):
        D = P_.distributed
        assert D.ProbabilityEntry(0.5)._to_attr() == "probability_entry:0.5"
        assert D.CountFilterEntry(3)._to_attr() == "count_filter_entry:3"
        assert D.ShowClickEntry("s", "c")._to_attr() == \
            "show_click_entry:s:c"
        assert D.gloo_release() is None


def test_streams_and_datasets(tmp_path):
    t = pt.to_tensor(np.ones(4, "float32"))
    task = pt.distributed.communication.stream.all_reduce(t)
    assert task.wait()
    assert pt.distributed.communication.stream.broadcast(t).wait()
    f = tmp_path / "slots.txt"
    f.write_text("1 2\n3 4\n5 6\n")
    for P_ in (pj, pt):
        ds = P_.distributed.InMemoryDataset()
        ds.init(batch_size=2)
        ds.set_filelist([str(f)])
        ds.load_into_memory()
        assert ds.get_memory_data_size() == 3
        assert list(ds) == [[["1", "2"], ["3", "4"]], [["5", "6"]]]
        q = P_.distributed.QueueDataset()
        q.init(batch_size=2)
        q.set_filelist([str(f)])
        assert list(q) == [[["1", "2"], ["3", "4"]], [["5", "6"]]]
        with pytest.raises(RuntimeError):
            q.load_into_memory()
