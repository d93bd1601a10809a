"""The port's parameter-server tables against the JAX package's.

Both packages build the same C++ (`native/src/ps_table.cc`, `arena.cc`,
`monitor.cc`) with the same flags, and the port copies the numpy of the
disk tier and the merges, so the same seed, keys and pushes give the same
rows bit for bit:

  * the native table under sgd / adagrad / adam (rows and optimizer
    state), a saved table loaded by the other package, and the
    reference's rows and state carried into a port table by its own
    `pull_with_state` / `assign`;
  * the `AsyncCommunicator`, `SparseEmbedding` (its gradient a
    `torch.autograd.Function` pushing into the table or the
    communicator), `PSContext` and `make_table`;
  * `DeviceEmbeddingCache` / `CachedEmbedding` on the CPU: a pass through
    the cache leaves the table as pushing the same merged rows does, bit
    for bit, and equal to the reference's cache;
  * `DiskSparseTable`: its tiers against the memory table, its log
    reopened by the other package (both ways), a torn tail, compaction;
  * the host arena and the stat registry (tests/test_native.py:24-72);
  * `static.nn.sparse_embedding`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import native as tn
from paddle_tpu_torch.distributed import ps as tps

DIM = 8


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _jn():
    from paddle_tpu import native
    return native


def _jps():
    from paddle_tpu.distributed import ps
    return ps


def _pushes(seed=0, steps=4, n=24, keys=40):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, keys, n).astype(np.int64),
             rng.randn(n, DIM).astype(np.float32)) for _ in range(steps)]


def _state(t, keys):
    v, s = t.pull_with_state(np.asarray(keys, np.int64))
    return np.concatenate([v, s], 1)


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adam"])
def test_table_rows_equal_reference(rule):
    jt = _jn().SparseTable(DIM, rule=rule, lr=0.1, init_range=0.05, seed=42)
    tt = tn.SparseTable(DIM, rule=rule, lr=0.1, init_range=0.05, seed=42)
    keys = np.arange(40, dtype=np.int64)
    np.testing.assert_array_equal(tt.pull(keys[::-1]), jt.pull(keys[::-1]))
    for k, g in _pushes():                    # repeated keys included
        jt.push(k, g)
        tt.push(k, g)
    assert tt.slot == jt.slot and len(tt) == len(jt) == 40
    np.testing.assert_array_equal(_state(tt, keys), _state(jt, keys))
    tt.erase(keys[:5])
    jt.erase(keys[:5])
    assert len(tt) == len(jt) == 35


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_table_loads_in_the_other_package(tmp_path, writer):
    jt = _jn().SparseTable(DIM, rule="adagrad", lr=0.1, seed=1)
    tt = tn.SparseTable(DIM, rule="adagrad", lr=0.1, seed=1)
    for t in (jt, tt):
        t.pull(np.arange(40))               # every row in the saved file
        for k, g in _pushes(1):
            t.push(k, g)
    path = str(tmp_path / "t.bin")
    (jt if writer == "jax" else tt).save(path)
    jr = _jn().SparseTable(DIM, rule="adagrad", lr=0.1, seed=999)
    tr = tn.SparseTable(DIM, rule="adagrad", lr=0.1, seed=999)
    (tr if writer == "jax" else jr).load(path)
    other = tr if writer == "jax" else jr
    keys = np.arange(40)
    np.testing.assert_array_equal(_state(other, keys), _state(jt, keys))
    g = np.ones((3, DIM), np.float32)
    other.push([3, 4, 3], g)
    jt.push([3, 4, 3], g)
    np.testing.assert_array_equal(_state(other, keys), _state(jt, keys))


@pytest.mark.parametrize("rule", ["sgd", "adagrad", "adam"])
def test_reference_state_carried_by_assign(rule):
    jt = _jn().SparseTable(DIM, rule=rule, lr=0.1, seed=7)
    for k, g in _pushes(2):
        jt.push(k, g)
    keys = np.arange(40, dtype=np.int64)
    vals, state = jt.pull_with_state(keys)
    tt = tn.SparseTable(DIM, rule=rule, lr=0.1, seed=123)
    tt.assign(keys, vals, state if tt.slot else None)
    np.testing.assert_array_equal(_state(tt, keys), _state(jt, keys))
    for k, g in _pushes(3):
        jt.push(k, g)
        tt.push(k, g)
    np.testing.assert_array_equal(_state(tt, keys), _state(jt, keys))


def test_merge_shard_and_communicator_equal_reference():
    jps = _jps()
    k, g = _pushes(4, steps=1)[0]
    for a, b in zip(tps.merge_by_key(k, g, DIM), jps.merge_by_key(k, g, DIM)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tps.shard_for(k, 3), jps.shard_for(k, 3))
    jt = _jn().SparseTable(DIM, rule="adagrad", lr=0.2, seed=5)
    tt = tn.SparseTable(DIM, rule="adagrad", lr=0.2, seed=5)
    # one flush of three batches: the merge window is the whole queue
    for t, mod in ((jt, jps), (tt, tps)):
        c = mod.AsyncCommunicator(t, merge_batches=3)
        for kk, gg in _pushes(5, steps=3):
            c.push_sparse(kk, gg)       # not started: synchronous pushes
        c.start()
        for kk, gg in _pushes(6, steps=3):
            c.push_sparse(kk, gg)
        c.flush()
        c.stop()
    np.testing.assert_array_equal(_state(tt, np.arange(40)),
                                  _state(jt, np.arange(40)))


@pytest.mark.parametrize("comm", [False, True], ids=["table", "communicator"])
def test_sparse_embedding_pushes_like_reference(comm):
    import paddle_tpu as pj
    jps = _jps()
    jt = _jn().SparseTable(DIM, rule="adagrad", lr=0.5, seed=3)
    tt = tn.SparseTable(DIM, rule="adagrad", lr=0.5, seed=3)
    jc = jps.AsyncCommunicator(jt) if comm else None
    tc = tps.AsyncCommunicator(tt) if comm else None
    for c in (jc, tc):
        if c is not None:
            c.start()
    je = jps.SparseEmbedding(DIM, table=jt, communicator=jc)
    te = tps.SparseEmbedding(DIM, table=tt, communicator=tc, device="cpu")
    rng = np.random.RandomState(8)
    for _ in range(3):
        ids = rng.randint(0, 30, (4, 5))
        coef = rng.randn(4, 5, DIM).astype(np.float32)
        jo = je(pj.to_tensor(ids))
        to = te(pt.to_tensor(ids))
        np.testing.assert_array_equal(to.numpy(), jo.numpy())
        assert not to.stop_gradient and to._data.device.type == "cpu"
        (jo * pj.to_tensor(coef)).sum().backward()
        (to * pt.to_tensor(coef)).sum().backward()
        for c in (jc, tc):
            if c is not None:
                c.flush()
    for c in (jc, tc):
        if c is not None:
            c.stop()
    np.testing.assert_array_equal(_state(tt, np.arange(30)),
                                  _state(jt, np.arange(30)))
    with torch.no_grad():
        assert te(np.array([1, 2])).stop_gradient
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            pytest.skip("the card is there")
        tps.SparseEmbedding(DIM, table=tt)


def test_ps_context_registry_and_save_load(tmp_path):
    ctx = tps.PSContext()
    ctx.create_table("emb", dim=4, rule="sgd", lr=0.1, async_push=False)
    ctx.table("emb").pull([1, 2, 3])
    ctx.save(str(tmp_path / "ps"))
    jctx = _jps().PSContext()
    jctx.create_table("emb", dim=4, rule="sgd", lr=0.1, async_push=False)
    jctx.load(str(tmp_path / "ps"))
    np.testing.assert_array_equal(jctx.table("emb").pull([1, 2, 3]),
                                  ctx.table("emb").pull([1, 2, 3]))
    assert sorted(tps.TABLE_TYPES) == ["MemorySparseTable", "SSDSparseTable"]
    with pytest.raises(ValueError, match="unknown table_class"):
        tps.make_table(4, table_class="Nope")
    s = pt.distributed.fleet.DistributedStrategy()
    s.sparse_table_configs = {"table_class": "SSDSparseTable",
                              "ssd_path": str(tmp_path / "ssd.log"),
                              "hot_capacity": 2}
    t = ctx.create_table_from_strategy("ssd", 4, s, async_push=False)
    assert isinstance(t, tps.DiskSparseTable) and t.hot_capacity == 2
    ctx.shutdown()
    jctx.shutdown()


@pytest.mark.parametrize("rule", ["sgd", "adagrad"])
def test_cached_pass_equals_the_table_and_the_reference(rule):
    host = tn.SparseTable(DIM, rule=rule, lr=0.1, seed=11)
    cached = tn.SparseTable(DIM, rule=rule, lr=0.1, seed=11)
    jt = _jn().SparseTable(DIM, rule=rule, lr=0.1, seed=11)
    keys = np.arange(60, dtype=np.int64) * 7 + 3
    cache = tps.DeviceEmbeddingCache(cached, device="cpu").build_pass(keys)
    jcache = _jps().DeviceEmbeddingCache(jt).build_pass(keys)
    rng = np.random.RandomState(0)
    for _ in range(4):
        ids = rng.choice(keys, 40)                # duplicates merge
        g = rng.randn(40, DIM).astype(np.float32)
        host.push(*tps.merge_by_key(ids, g, DIM))
        cache.update(ids, g)
        jcache.update(ids, g)
        np.testing.assert_array_equal(cache.lookup(ids[:6]).numpy(),
                                      host.pull(ids[:6]))
    cache.flush()
    jcache.flush()
    np.testing.assert_array_equal(_state(cached, keys), _state(host, keys))
    np.testing.assert_allclose(_state(cached, keys), _state(jt, keys),
                               rtol=1e-6, atol=1e-7)
    assert cache.capacity == 60
    with pytest.raises(KeyError):
        cache.lookup(np.array([1]))
    with pytest.raises(ValueError, match="adam"):
        tps.DeviceEmbeddingCache(tn.SparseTable(4, rule="adam"),
                                 device="cpu")


def test_cached_embedding_autograd_matches_reference():
    import paddle_tpu as pj
    tt = tn.SparseTable(DIM, rule="adagrad", lr=0.5, seed=1)
    jt = _jn().SparseTable(DIM, rule="adagrad", lr=0.5, seed=1)
    keys = np.arange(10, dtype=np.int64)
    emb = tps.CachedEmbedding(tt, pass_keys=keys, device="cpu")
    jemb = _jps().CachedEmbedding(jt, pass_keys=keys)
    ids = np.array([[0, 1], [2, 1]], np.int64)
    coef = np.random.RandomState(2).randn(2, 2, DIM).astype(np.float32)
    out = emb(pt.to_tensor(ids))
    assert tuple(out.shape) == (2, 2, DIM)
    (out * pt.to_tensor(coef)).sum().backward()
    jout = jemb(pj.to_tensor(ids))
    (jout * pj.to_tensor(coef)).sum().backward()
    emb.flush()
    jemb.flush()
    np.testing.assert_allclose(_state(tt, keys), _state(jt, keys),
                               rtol=1e-6, atol=1e-7)
    assert not np.array_equal(tt.pull([0]), tn.SparseTable(
        DIM, rule="adagrad", lr=0.5, seed=1).pull([0]))


def test_disk_tier_equals_memory_table(tmp_path):
    mem = tn.SparseTable(DIM, rule="adagrad", lr=0.1, seed=4)
    disk = tps.DiskSparseTable(DIM, str(tmp_path / "t.log"), rule="adagrad",
                               lr=0.1, seed=4, hot_capacity=8,
                               min_compact_bytes=0, compact_ratio=0.3)
    for k, g in _pushes(9, steps=6):
        mem.push(k, g)
        disk.push(k, g)
    keys = np.arange(40)
    np.testing.assert_array_equal(_state(disk, keys), _state(mem, keys))
    assert disk.stats["hot_rows"] == 8 and disk.compactions > 0
    assert len(disk) == 40


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_log_reopens_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "t.log")
    mk = {"jax": _jps().DiskSparseTable, "port": tps.DiskSparseTable}
    a = mk[writer](DIM, path, rule="adagrad", lr=0.1, seed=5,
                   hot_capacity=4)
    for k, g in _pushes(10):
        a.push(k, g)
    keys = np.arange(40)
    want = _state(a, keys)
    a.close()
    # a torn tail record: a crash mid-append
    with open(path, "ab") as f:
        f.write(b"\x01" * 13)
    b = mk["port" if writer == "jax" else "jax"](
        DIM, path, rule="adagrad", lr=0.1, seed=99, hot_capacity=4)
    np.testing.assert_array_equal(_state(b, keys), want)
    with pytest.raises(IOError, match="does not match"):
        tps.DiskSparseTable(DIM + 1, path)
    b.destroy()


def test_host_arena_and_stat_registry_equal_reference():
    ja = _jn().HostArena(chunk_bytes=1 << 20)
    ta = tn.HostArena(chunk_bytes=1 << 20)
    for a in (ja, ta):
        bufs = [a.alloc(s) for s in (100, 5000, 70000, 3 << 20)]
        bufs[0][:5] = b"hello"
        assert bytes(bufs[0][:5]) == b"hello"
        a.free(bufs[1])
        a.free(bufs[0])
        bufs.append(a.alloc(4000))                  # reuses the coalesced
        with pytest.raises(ValueError):
            a.free(bufs[1])                         # double free
    assert ta.stats() == ja.stats()
    ta.destroy()
    ja.destroy()
    for mod in (tn, _jn()):
        mod.stat_reset("ps.test")
        assert mod.stat_add("ps.test", 5) == 5
        assert mod.stat_add("ps.test", -3) == 2
        assert (mod.stat_get("ps.test"), mod.stat_peak("ps.test")) == (2, 5)
    assert tn.SOURCES == ("shm_ring", "kvstore", "arena", "monitor",
                          "ps_table")


def test_static_sparse_embedding_looks_up_through_a_table():
    from paddle_tpu_torch.static import nn as snn
    ids = pt.to_tensor(np.array([[1, 2], [2, 9]]))
    out = snn.sparse_embedding(ids, [1000, 4])
    assert out.shape == [2, 2, 4] and not out.stop_gradient
    out.sum().backward()
    assert np.isfinite(out.numpy()).all()
