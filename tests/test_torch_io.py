"""The port's `io` (Dataset, samplers, DataLoader and its three engines),
`batch` / `reader` and the shared-memory ring, against the JAX package on
the CPU.

Sampling draws from numpy's global state in both packages, so one
`np.random.seed` must give the same batch order. Batches compare exactly;
dtypes through ROADMAP C.14's width map (the port keeps int64 where the
JAX package, x64 off, has int32). The ring engine's cases are
`tests/test_native.py`'s `_SquareDataset` / `_BoomDataset`, against the
port's own ring (`paddle_tpu_torch/native`).
"""
import os
import time

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native
from paddle_tpu_torch.observability import faults as tfaults
from paddle_tpu_torch.profiler import _tracer as TRACER


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    tfaults.disarm_all()
    yield pt
    tfaults.disarm_all()


def jax_io():
    import paddle_tpu as pj
    return pj, pj.io


def host(x):
    a = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return a.astype(np.int64) if a.dtype.kind in "iu" else a


def same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g if isinstance(g, (list, tuple)) else [g]
        w = w if isinstance(w, (list, tuple)) else [w]
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(host(a), host(b))


class _SquareDataset:
    def __len__(self):
        return 37

    def __getitem__(self, i):
        return np.full((4, 4), i * i, dtype=np.float32), i


class _BoomDataset:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom on 5")
        return np.zeros(2, dtype=np.float32)


class _Fake:
    """FakeData's sampling: (a [3, 2] float32 image, an int64 label)."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return rng.rand(3, 2).astype(np.float32), np.int64(rng.randint(4))


# ----------------------------------------------------------------- samplers

SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random_replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=30),
    "random_num_samples": lambda io, ds: io.RandomSampler(ds,
                                                          num_samples=7),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, 23), 15),
    "weighted_no_replacement": lambda io, ds: io.WeightedRandomSampler(
        np.linspace(0.1, 2.0, 23), 10, replacement=False),
    "batch": lambda io, ds: io.BatchSampler(ds, batch_size=5),
    "batch_shuffle_drop": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=4, drop_last=True),
    "batch_of_sampler": lambda io, ds: io.BatchSampler(
        sampler=io.RandomSampler(ds), batch_size=6),
    "distributed_r0": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=0),
    "distributed_r2_shuffle": lambda io, ds: io.DistributedBatchSampler(
        ds, 4, num_replicas=3, rank=2, shuffle=True),
    "distributed_drop": lambda io, ds: io.DistributedBatchSampler(
        ds, 3, num_replicas=2, rank=1, shuffle=True, drop_last=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_jax(name):
    _, jio = jax_io()
    ds = list(range(23))
    out = {}
    for pkg, io in (("jax", jio), ("port", tio)):
        s = SAMPLERS[name](io, ds)
        np.random.seed(17)
        first = list(s)
        if hasattr(s, "set_epoch"):
            s.set_epoch(3)
        out[pkg] = (first, list(s), len(s))
    assert out["port"] == out["jax"]
    assert out["port"][2] == len(out["port"][0])


def test_distributed_sampler_env_defaults(monkeypatch):
    # the defaults are distributed.get_world_size() / get_rank(), as in
    # the reference (ROADMAP C.21)
    from paddle_tpu_torch.distributed import env
    monkeypatch.setattr(env, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(env, "get_rank", lambda group=None: 3)
    s = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (s.nranks, s.local_rank) == (4, 3)
    assert list(s) == [[3, 7], [1]]
    monkeypatch.undo()
    s = tio.DistributedBatchSampler(list(range(10)), 4)
    assert (s.nranks, s.local_rank) == (1, 0) and len(s) == 3


# -------------------------------------------------------- datasets, collate

def test_datasets_and_random_split_match_jax():
    pj, jio = jax_io()
    out = {}
    for pkg, io, P in (("jax", jio, pj), ("port", tio, pt)):
        a = np.arange(12, dtype=np.float32).reshape(6, 2)
        b = np.arange(6, dtype=np.int64)
        td = io.TensorDataset([P.to_tensor(a), P.to_tensor(b)])
        comp = io.ComposeDataset([_Fake(6), _Fake(8)])
        sub = io.Subset(_Fake(), [5, 1, 9])
        np.random.seed(3)
        parts = io.random_split(_Fake(10), [6, 4])
        out[pkg] = ([[host(t) for t in td[i]] for i in range(len(td))],
                    len(comp), [host(v) for v in comp[4]],
                    [host(v) for v in sub[2]], [p.indices for p in parts])
        with pytest.raises(ValueError, match="sum of lengths"):
            io.random_split(_Fake(10), [6, 5])
    g, w = out["port"], out["jax"]
    for x, y in zip(g[0], w[0]):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)
    assert g[1] == w[1] == 6
    for a, b in zip(g[2] + g[3], w[2] + w[3]):
        np.testing.assert_array_equal(a, b)
    assert g[4] == w[4]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                                (True, True)])
def test_dataloader_batch_order_matches_jax(shuffle, drop_last):
    _, jio = jax_io()
    got = {}
    for pkg, io in (("jax", jio), ("port", tio)):
        np.random.seed(5)
        dl = io.DataLoader(_Fake(), batch_size=4, shuffle=shuffle,
                           drop_last=drop_last)
        got[pkg] = (len(dl), list(dl), list(dl))
    assert got["port"][0] == got["jax"][0]
    same_batches(got["port"][1], got["jax"][1])
    same_batches(got["port"][2], got["jax"][2])
    assert got["port"][1][0][1].dtype == pt.int64


def test_collate_widths_match_jax():
    """Floats narrow to float32, integers keep int64 (the JAX package's
    int32 under x64 off: C.14), dicts and nested lists keep structure,
    Tensor samples stack."""
    pj, jio = jax_io()
    samples = [{"x": np.float64(i) / 3, "n": i, "v": [np.ones(2) * i, 1.5],
                "b": np.arange(3, dtype=np.int32) + i} for i in range(4)]
    tb = tio.default_collate_fn(samples)
    jb = jio.default_collate_fn(samples)
    assert sorted(tb) == sorted(jb)
    widths = {"x": pt.float32, "n": pt.int64, "b": pt.int32}
    for k, dt in widths.items():
        assert tb[k].dtype == dt, k
        np.testing.assert_array_equal(host(tb[k]), host(jb[k]))
    # a float64 array becomes the default float dtype in to_tensor
    assert tb["v"][0].dtype == pt.float32
    np.testing.assert_array_equal(host(tb["v"][0]), np.stack(
        [np.ones(2) * i for i in range(4)]))
    np.testing.assert_array_equal(host(tb["v"][1]), host(jb["v"][1]))
    tens = [(pt.to_tensor(np.full(2, i, np.float32)), i) for i in range(3)]
    x, y = tio.default_collate_fn(tens)
    np.testing.assert_array_equal(x.numpy(), np.repeat(np.arange(3.0), 2)
                                  .reshape(3, 2))
    assert y.dtype == pt.int64
    assert tio.default_collate_fn(["a", "b"]) == ["a", "b"]


class _Stream:
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((2,), i, np.float32), i


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_iterable_dataset_matches_jax(drop_last, num_workers):
    pj, jio = jax_io()
    got = {}
    for pkg, io in (("jax", jio), ("port", tio)):
        cls = type("S", (io.IterableDataset,), {
            "__init__": lambda self: None,
            "__iter__": lambda self: iter(_Stream(11))})
        chain = io.ChainDataset([cls(), cls()])
        got[pkg] = (list(io.DataLoader(cls(), batch_size=4,
                                       drop_last=drop_last,
                                       num_workers=num_workers)),
                    list(io.DataLoader(chain, batch_size=5,
                                       num_workers=num_workers)))
        with pytest.raises(TypeError):
            len(io.DataLoader(cls(), batch_size=4))
        with pytest.raises(RuntimeError):
            cls()[0]
    same_batches(got["port"][0], got["jax"][0])
    same_batches(got["port"][1], got["jax"][1])
    assert len(got["port"][0]) == (2 if drop_last else 3)


# ------------------------------------------------------------------ engines

def test_ring_engine_equals_serial_and_counts():
    assert native.available()
    tio.reset_engine_stats()
    serial = list(tio.DataLoader(_SquareDataset(), batch_size=5,
                                 num_workers=0))
    parallel = list(tio.DataLoader(_SquareDataset(), batch_size=5,
                                   num_workers=2))
    threaded = list(tio.DataLoader(_SquareDataset(), batch_size=5,
                                   num_workers=2, use_shared_memory=False))
    assert len(serial) == len(parallel) == len(threaded) == 8
    same_batches(parallel, serial)
    same_batches(threaded, serial)
    stats = tio.engine_stats()
    assert (stats["serial"], stats["ring"], stats["thread"]) == (8, 8, 8)
    assert sum(stats["ring_by_worker"].values()) == 8
    assert set(stats["ring_by_worker"]) <= {0, 1}


def test_ring_engine_matches_jax_under_shuffle():
    _, jio = jax_io()
    got = {}
    for pkg, io in (("jax", jio), ("port", tio)):
        np.random.seed(9)
        got[pkg] = list(io.DataLoader(_Fake(40), batch_size=6,
                                      shuffle=True, num_workers=2,
                                      prefetch_factor=1))
    same_batches(got["port"], got["jax"])


def test_worker_exception_reaches_trainer():
    with pytest.raises(RuntimeError, match="boom on 5") as e:
        list(tio.DataLoader(_BoomDataset(), batch_size=4, num_workers=2))
    assert "Traceback" in str(e.value) and "ValueError" in str(e.value)
    with pytest.raises(ValueError, match="boom on 5"):
        list(tio.DataLoader(_BoomDataset(), batch_size=4, num_workers=2,
                            use_shared_memory=False))
    with pytest.raises(ValueError, match="boom on 5"):
        list(tio.DataLoader(_BoomDataset(), batch_size=4))


class _ForkedCuda:
    """What a dataset that makes CUDA tensors meets in a forked worker,
    shown on the CPU: torch's own refusal."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        raise RuntimeError("Cannot re-initialize CUDA in forked subprocess. "
                           "To use CUDA with multiprocessing, you must use "
                           "the 'spawn' start method")


class _DeviceSamples:
    """Samples holding a tensor off the host (the meta device stands in
    for CUDA here)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        import torch
        return pt.Tensor(torch.empty((2,), device="meta")), i


@pytest.mark.parametrize("ds", [_ForkedCuda, _DeviceSamples])
def test_cuda_in_a_worker_names_the_cause(ds):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="forked processes and stay "
                                           "numpy-only"):
        list(tio.DataLoader(ds(), batch_size=2, num_workers=2))
    assert time.perf_counter() - t0 < 30


class _Slow:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        time.sleep(3)
        return np.zeros(1, np.float32)


class _Dies:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        os._exit(3)


def test_timeout_and_dead_worker():
    with pytest.raises(TimeoutError):
        list(tio.DataLoader(_Slow(), batch_size=2, num_workers=1,
                            timeout=0.5))
    with pytest.raises(RuntimeError, match="died unexpectedly"):
        list(tio.DataLoader(_Dies(), batch_size=2, num_workers=1,
                            timeout=1))


class _WorkerIds:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return np.asarray([i, -1 if info is None else info.id,
                           0 if info is None else info.num_workers])


def test_worker_info_and_init_fn():
    assert tio.get_worker_info() is None
    seen = list(tio.DataLoader(_WorkerIds(), batch_size=3, num_workers=2,
                               worker_init_fn=lambda wid: np.random.seed(
                                   wid)))
    rows = np.concatenate([b.numpy() for b in seen])
    np.testing.assert_array_equal(rows[:, 0], np.arange(12))
    assert set(rows[:, 1]) <= {0, 1} and set(rows[:, 2]) == {2}
    rows = np.concatenate([b.numpy() for b in tio.DataLoader(
        _WorkerIds(), batch_size=3)])
    assert set(rows[:, 1]) == {-1}


def test_early_exit_releases_the_ring(monkeypatch):
    made = []
    real = native.ShmRing

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if kw.get("create", True):
                made.append(self)
    monkeypatch.setattr(native, "ShmRing", Spy)
    dl = tio.DataLoader(_SquareDataset(), batch_size=5, num_workers=2)
    it = iter(dl)
    next(it)
    it.close()
    assert made and all(r._h is None for r in made)
    assert not os.path.exists("/dev/shm" + made[0].name)


# ------------------------------------------------ fault site, wait, spans

def test_dataloader_next_fault_fires():
    tfaults.arm("dataloader.next", mode="raise", nth=2, max_fires=1)
    it = iter(tio.DataLoader(_SquareDataset(), batch_size=5))
    next(it)
    with pytest.raises(tfaults.FaultInjected):
        next(it)


def test_wait_histogram_and_spans():
    child = tio._DL_WAIT._require_default()
    n0 = child.count
    TRACER.drain()
    TRACER.enabled = True
    try:
        batches = list(tio.DataLoader(_SquareDataset(), batch_size=10))
    finally:
        TRACER.enabled = False
    spans = [e for e in TRACER.drain() if e["name"] == "DataLoader.next"]
    assert child.count - n0 == len(batches) == 4
    assert len(spans) == 4 and {e["type"] for e in spans} == {"Dataloader"}

    class Ring:
        def __init__(self):
            self.spans = []

        def record_span(self, rec):
            self.spans.append(rec)
    ring = Ring()
    TRACER.ring = ring
    try:
        list(tio.DataLoader(_SquareDataset(), batch_size=20))
    finally:
        TRACER.ring = None
    assert [r["name"] for r in ring.spans] == ["DataLoader.next"] * 2
    assert not [e for e in TRACER.drain() if e["name"] == "DataLoader.next"]


# -------------------------------------------------------- the ring itself

def test_ring_library_is_keyed_and_ignored():
    path = native.library_path()
    assert os.path.dirname(path) == native.build_dir()
    assert path.endswith(".so") and os.path.exists(path)
    assert os.path.join("build", "paddle_tpu_torch", "native") in path
    r = native.ShmRing(f"/ptt_test_{os.getpid()}", 1 << 12)
    try:
        r.put(b"abc")
        assert r.get(timeout_ms=100) == b"abc"
        with pytest.raises(TimeoutError):
            r.get(timeout_ms=10)
        with pytest.raises(ValueError):
            r.put(b"z" * 8192)
        r.close()
        assert r.get(timeout_ms=10) is None
        with pytest.raises(EOFError):
            r.put(b"x")
    finally:
        r.release()


# ----------------------------------------------------- batch and reader

def test_batch_and_reader_match_jax():
    import paddle_tpu as pj
    import paddle_tpu.reader as jreader
    from paddle_tpu_torch import reader as treader
    for P, rd in ((pj, jreader), (pt, treader)):
        r = P.batch(lambda: iter(range(10)), 3)
        assert [len(b) for b in r()] == [3, 3, 3, 1]
        r = P.batch(lambda: iter(range(10)), 3, drop_last=True)
        assert [len(b) for b in r()] == [3, 3, 3]
        with pytest.raises(ValueError):
            P.batch(lambda: iter([]), 0)
        assert list(rd.firstn(lambda: iter(range(10)), 4)()) == [0, 1, 2, 3]
        assert sorted(rd.shuffle(lambda: iter(range(5)), 2)()) == \
            list(range(5))
        assert list(rd.chain(lambda: iter([1]), lambda: iter([2]))()) == \
            [1, 2]
        assert list(rd.map_readers(lambda a, b: a + b,
                                   lambda: iter([1, 2]),
                                   lambda: iter([10, 20]))()) == [11, 22]
        assert list(rd.compose(lambda: iter([(1, 2)]),
                               lambda: iter([3]))()) == [(1, 2, 3)]
        with pytest.raises(rd.ComposeNotAligned
                           if hasattr(rd, "ComposeNotAligned")
                           else ValueError):
            list(rd.compose(lambda: iter([1, 2]), lambda: iter([3]))())
        assert list(rd.compose(lambda: iter([1, 2]), lambda: iter([3]),
                               check_alignment=False)()) == [(1, 3)]
