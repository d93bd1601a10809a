"""paddle.io for the port (counterpart of `paddle_tpu/io/__init__.py`):
Dataset, samplers, DataLoader.

`DataLoader` has three engines, as the reference's:
  * serial (num_workers=0);
  * worker processes (num_workers>0, `use_shared_memory`, a map-style
    dataset, the ring's library built): forked workers return numpy
    batches through the shared-memory ring (`paddle_tpu_torch/native`),
    at most `num_workers * prefetch_factor` batches outstanding, batches
    yielded in sampler order;
  * a prefetch thread (an `IterableDataset`, `use_shared_memory=False`,
    or no ring library).
Tensors are made only in the trainer (`_finalize_batch`), on the current
place (the GPU unless `set_device("cpu")`); workers stay numpy-only and
never touch CUDA (`io/worker.py`).

Sampling draws from numpy's global state as the reference does
(`RandomSampler`, `random_split`), and `DistributedBatchSampler` shuffles
with `RandomState(epoch)`: one `np.random.seed` gives both packages the
same batch order. `DistributedBatchSampler`'s `num_replicas` and `rank`
default to `distributed.get_world_size()` and `get_rank()`, as the
reference's do (the port counts ranks where the reference counts
devices: ROADMAP C.21).

Every batch the loop takes is a `DataLoader.next` span (Dataloader type;
recorded for the flight recorder alone when only a ring is attached),
observes `dataloader_wait_seconds` and fires the `dataloader.next` fault
site. `engine_stats()` counts the batches each engine handed over, and
the ring's by worker.
"""
import itertools
import os
import pickle
import queue
import threading
import time

import numpy as np

from ..core.tensor import to_tensor
from ..observability import faults as _faults
from ..observability import metrics as _metrics
from ..profiler import _tracer as _TRACER
from .worker import (CUDA_IN_WORKER, WorkerInfo, collate,  # noqa: F401
                     get_worker_info, numpy_collate, worker_loop)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
           "DataLoader", "get_worker_info", "WorkerInfo", "engine_stats",
           "reset_engine_stats"]

# how long the training loop blocks waiting for each batch (the
# dataloader-bound phase of the step)
_DL_WAIT = _metrics.histogram(
    "dataloader_wait_seconds",
    "Time the training loop blocks waiting for the next batch")

_ENGINE_STATS = {"serial": 0, "thread": 0, "ring": 0, "ring_by_worker": {}}


def engine_stats():
    """Batches handed to the trainer by each engine since the last reset:
    {"serial", "thread", "ring": n, "ring_by_worker": {worker id: n}}."""
    return {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in _ENGINE_STATS.items()}


def reset_engine_stats():
    for k in ("serial", "thread", "ring"):
        _ENGINE_STATS[k] = 0
    _ENGINE_STATS["ring_by_worker"] = {}


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset length")
    perm = np.random.permutation(total)
    out, off = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[off:off + ln].tolist()))
        off += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices over data-parallel ranks: every rank pads the
    index list to `num_samples * nranks` and takes every nranks-th."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        from ..distributed import env
        self.nranks = num_replicas if num_replicas is not None else \
            env.get_world_size()
        self.local_rank = rank if rank is not None else env.get_rank()
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate([indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    return collate(batch, to_tensor)


class DataLoader:
    """Batches of a dataset (module docstring: the engines)."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self._user_collate_fn = collate_fn is not None
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self._use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        """Batch iterator, one Dataloader span per batch. With background
        workers the span measures the time the training loop waits on
        data, not the workers' compute."""
        it = self._base_iter()
        while True:
            # per-batch (not per-op) cost: also feed the flight-recorder
            # ring when one is attached, so a postmortem shows whether the
            # loop was waiting on data when the process wedged
            rec = _TRACER.begin("DataLoader.next", "Dataloader") \
                if (_TRACER.enabled or _TRACER.ring is not None) else None
            t0 = time.perf_counter()
            try:
                _faults.fire("dataloader.next")
                batch = next(it)
            except StopIteration:
                _TRACER.cancel(rec)
                return
            except BaseException:
                _TRACER.cancel(rec)
                raise
            _DL_WAIT.observe(time.perf_counter() - t0)
            _TRACER.end(rec)
            yield batch

    def _base_iter(self):
        if self.num_workers <= 0:
            for batch in self._iter_batches():
                _ENGINE_STATS["serial"] += 1
                yield batch
            return
        if self._use_shared_memory and not self._iterable_mode:
            from .. import native
            if native.available():
                yield from self._iter_multiprocess()
                return
        yield from self._iter_threaded()

    # -- threaded fallback -------------------------------------------------
    def _iter_threaded(self):
        maxsize = max(2, self.num_workers * self.prefetch_factor)
        q = queue.Queue(maxsize=maxsize)
        sentinel = object()

        def producer():
            try:
                for batch in self._iter_batches():
                    q.put(batch)
            except BaseException as e:      # noqa: BLE001 - re-raised
                q.put(_Failure(e))          # in the trainer
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, _Failure):
                raise item.error
            _ENGINE_STATS["thread"] += 1
            yield item
        t.join()

    # -- multi-process over the native shm ring ----------------------------
    def _iter_multiprocess(self):
        import multiprocessing as mp

        from .. import native

        ctx = mp.get_context("fork")
        ring_name = f"/ptt_dl_{os.getpid()}_{next(_RING_SEQ)}"
        ring_cap = max(8 << 20,
                       self.num_workers * self.prefetch_factor * (4 << 20))
        ring = native.ShmRing(ring_name, ring_cap)
        procs = []
        # everything past ring creation runs under the finally so a sampler
        # exception or fork failure can't leak the shm segment / workers
        try:
            index_queue = ctx.Queue()
            batches = list(self.batch_sampler)

            # incremental dispatch: at most num_workers * prefetch_factor
            # batch indices outstanding, so worker-side ring pressure AND
            # parent-side reorder buffering both stay bounded (reference:
            # dataloader_iter.py _try_put_indices / _outstanding_capacity)
            dispatch_iter = iter(enumerate(batches))
            max_outstanding = max(2, self.num_workers * self.prefetch_factor)
            exhausted = [False]

            def dispatch_one():
                if exhausted[0]:
                    return
                item = next(dispatch_iter, None)
                if item is None:
                    exhausted[0] = True
                    for _ in range(self.num_workers):
                        index_queue.put(None)
                    return
                index_queue.put(item)

            for _ in range(max_outstanding):
                dispatch_one()

            worker_collate = (self.collate_fn if self._user_collate_fn
                              else numpy_collate)
            base_seed = int(np.random.randint(0, 2 ** 31))
            procs = [
                ctx.Process(
                    target=worker_loop,
                    args=(self.dataset, worker_collate, ring_name, index_queue,
                          self.worker_init_fn, wid, self.num_workers,
                          base_seed),
                    daemon=True)
                for wid in range(self.num_workers)
            ]
            # fork is deliberate (copy-on-write handoff of the dataset
            # and the named ring) and safe because workers run a numpy
            # loop and never touch CUDA; only the fork-vs-threads
            # warnings at this boundary are silenced
            import warnings
            with warnings.catch_warnings():
                warnings.filterwarnings(
                    "ignore", message=".*fork.*", category=RuntimeWarning)
                warnings.filterwarnings(
                    "ignore", message=".*fork.*", category=DeprecationWarning)
                for p in procs:
                    p.start()

            # timeout=0 (default) means "no deadline" — poll in 10 s slices
            # so a dead worker is still detected promptly (the watchdog role
            # of launch_utils.watch_local_trainers)
            user_deadline_ms = int(self.timeout * 1000) if self.timeout else None
            poll_ms = min(user_deadline_ms, 10000) if user_deadline_ms else 10000
            buffered = {}
            next_idx = 0
            while next_idx < len(batches):
                if next_idx in buffered:
                    batch = self._finalize_batch(buffered.pop(next_idx))
                    _ENGINE_STATS["ring"] += 1
                    yield batch
                    next_idx += 1
                    continue
                waited_ms = 0
                while True:
                    try:
                        data = ring.get(timeout_ms=poll_ms)
                        break
                    except TimeoutError:
                        dead = [p.pid for p in procs if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f"DataLoader worker(s) {dead} died "
                                f"unexpectedly") from None
                        waited_ms += poll_ms
                        if user_deadline_ms and waited_ms >= user_deadline_ms:
                            raise
                if data is None:
                    raise RuntimeError("DataLoader ring closed early")
                i, status, payload, wid = pickle.loads(data)
                dispatch_one()
                if status == "err":
                    raise RuntimeError(
                        f"DataLoader worker {wid} failed on batch {i}:\n"
                        f"{payload}")
                buffered[i] = payload
                by_worker = _ENGINE_STATS["ring_by_worker"]
                by_worker[wid] = by_worker.get(wid, 0) + 1
        finally:
            ring.close()
            for p in procs:
                p.join(timeout=1)
                if p.is_alive():
                    p.terminate()
            ring.release()

    def _finalize_batch(self, batch):
        """numpy structure -> tensors on the current place (in the
        trainer)."""
        if self._user_collate_fn:
            return batch
        if isinstance(batch, list):
            return [self._finalize_batch(b) for b in batch]
        if isinstance(batch, dict):
            return {k: self._finalize_batch(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            return to_tensor(batch)
        return batch


class _Failure:
    """An exception the prefetch thread hands to the trainer."""

    def __init__(self, error):
        self.error = error


_RING_SEQ = itertools.count(1)  # itertools.count is atomic under the GIL
