"""The parameter server: sparse tables for recommender-model training
(counterpart of `paddle_tpu/distributed/ps/__init__.py`).

Reference: the brpc client / server around sharded hash embedding tables
(ps/table/memory_sparse_table.cc) with sparse optimizer rules
(sparse_sgd_rule.cc), the async gradient-merging Communicator
(ps/service/communicator/communicator.cc), and the worker-side lookup and
push ops (distributed_lookup_table_op, distributed_push_sparse_op).

  * The table is the native C++ of `native/src/ps_table.cc`
    (`SparseTable`): a striped hash map, the sgd / adagrad / adam rules
    applied on push, rows created on first pull from a seeded uniform
    draw, binary save / load. Tables are made by class name
    (`make_table`, `register_table_type`): "MemorySparseTable" (the
    native table) and "SSDSparseTable" (`disk_table.DiskSparseTable`, a
    hot tier over an append-only log).
  * Keys route to shard servers by `shard_for` (key % shards); `rpc.py`
    carries PULL / PUSH and the graph verbs (`PSServer`, `PSClient`,
    `DistributedSparseTable`, `DistGraphClient`; `graph_table.GraphTable`).
  * `AsyncCommunicator` is a thread that merges gradients by key
    (`merge_by_key`) and pushes every `merge_batches` batches.
  * `SparseEmbedding` is the lookup: a pull on the forward, the rows on
    the caller's device; its gradient is a `torch.autograd.Function`
    whose backward pushes the output's gradient rows, one per looked-up
    id in lookup order, to the table (whose rule applies a repeated id
    once per occurrence, as the reference's op pushes them) or to the
    communicator (which merges them by key).
  * `device_cache.DeviceEmbeddingCache` / `CachedEmbedding` keep a pass's
    rows and optimizer state on the device.

Every entry point that makes tensors takes `device=` ("cuda" by default;
it raises without CUDA unless the caller passes "cpu"). The tables
themselves live on the host, as the reference's.
"""
import os
import queue
import threading

import numpy as np
import torch

from ... import native
from ...core.device import resolve_device
from ...core.tensor import Tensor, _wrap

__all__ = ["SparseTable", "AsyncCommunicator", "SparseEmbedding",
           "sparse_embedding", "PSContext", "shard_for", "merge_by_key",
           "PSServer", "PSClient", "DistributedSparseTable",
           "DeviceEmbeddingCache", "CachedEmbedding",
           "GraphTable", "DistGraphClient", "DiskSparseTable",
           "TABLE_TYPES", "register_table_type", "make_table",
           "PSServerError", "PSUnavailableError", "RetryPolicy"]

SparseTable = native.SparseTable

# the table registry (the table_class of the reference's TableParameter,
# resolved by name); DistributedStrategy.sparse_table_configs
# ["table_class"] selects from it
TABLE_TYPES = {}


def register_table_type(name, cls):
    TABLE_TYPES[name] = cls
    return cls


def make_table(dim, table_class="MemorySparseTable", rule="adagrad", lr=0.05,
               init_range=0.01, seed=0, **table_kwargs):
    """A table of a registered type; extra keywords go to its class (a
    DiskSparseTable's `path` / `hot_capacity`)."""
    try:
        cls = TABLE_TYPES[table_class]
    except KeyError:
        raise ValueError(f"unknown table_class {table_class!r}; registered: "
                         f"{sorted(TABLE_TYPES)}") from None
    return cls(dim, rule=rule, lr=lr, init_range=init_range, seed=seed,
               **table_kwargs)


def shard_for(keys, num_shards):
    """The shard that owns each key (key % shards, the reference's
    feasign % shard_num)."""
    return np.asarray(keys, dtype=np.int64) % int(num_shards)


def merge_by_key(keys, grads, dim):
    """One summed gradient a unique id, ids ascending: the communicator's
    merge before a push, and the device cache's before an update."""
    keys = np.asarray(keys, np.int64).reshape(-1)
    grads = np.asarray(grads, np.float32).reshape(-1, dim)
    uniq, inv = np.unique(keys, return_inverse=True)
    merged = np.zeros((uniq.size, dim), np.float32)
    np.add.at(merged, inv, grads)
    return uniq, merged


class AsyncCommunicator:
    """Background gradient pusher (communicator.cc's AsyncCommunicator: a
    send queue, merge by key, batched pushes)."""

    def __init__(self, table, merge_batches=4, queue_size=64):
        self._table = table
        self._merge = max(int(merge_batches), 1)
        self._q = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._running = False
        self._inflight = 0                  # queued, not yet in the table
        self._cv = threading.Condition()
        self._push_error = None             # the first failed push
        self._lost = 0                      # gradient batches it dropped

    def start(self):
        self._running = True
        self._thread.start()

    def push_sparse(self, keys, grads):
        if not self._running:
            self._table.push(keys, grads)   # not started: synchronous
            return
        with self._cv:
            self._inflight += 1
        self._q.put((np.asarray(keys, np.int64).copy(),
                     np.asarray(grads, np.float32).copy()))

    def _loop(self):
        pending = []
        while not self._stop.is_set() or not self._q.empty() or pending:
            try:
                pending.append(self._q.get(timeout=0.05))
            except queue.Empty:
                pass
            # push at the merge threshold, or when the queue runs dry (a
            # flush never waits on a partial window)
            if pending and (len(pending) >= self._merge or self._q.empty()):
                try:
                    self._flush(pending)
                except Exception as e:              # noqa: BLE001
                    # a failed push must not end the thread (every later
                    # flush would time out): it is kept, and the next
                    # flush raises it
                    with self._cv:
                        if self._push_error is None:
                            self._push_error = e
                        self._lost += len(pending)
                finally:
                    with self._cv:
                        self._inflight -= len(pending)
                        self._cv.notify_all()
                pending = []

    def _flush(self, items):
        keys = np.concatenate([k for k, _ in items])
        grads = np.concatenate([g for _, g in items])
        uniq, merged = merge_by_key(keys, grads, grads.shape[1])
        self._table.push(uniq, merged)

    def flush(self, timeout=30.0):
        """Block until every queued gradient is in the table. A timeout
        raises TimeoutError (`e.unflushed`: the batches still queued); a
        failed background push is raised here with the batches it
        dropped."""
        with self._cv:
            done = self._cv.wait_for(lambda: self._inflight == 0,
                                     timeout=timeout)
            err, lost = self._push_error, self._lost
            self._push_error, self._lost = None, 0
            unflushed = self._inflight
        if err is not None:
            raise RuntimeError(
                f"AsyncCommunicator background push failed; {lost} queued "
                f"gradient batch(es) were dropped") from err
        if not done:
            e = TimeoutError(
                f"AsyncCommunicator flush timed out with {unflushed} "
                f"gradient batch(es) still queued")
            e.unflushed = unflushed
            raise e

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10)
        self._running = False


class _PushRows(torch.autograd.Function):
    """The looked-up rows as a differentiable value; the backward pushes
    their gradient to the table or the communicator (the reference's
    distributed_push_sparse) and hands nothing further back."""

    @staticmethod
    def forward(ctx, anchor, rows, flat, sink, dim):
        ctx.flat, ctx.sink, ctx.dim = flat, sink, dim
        return rows.view_as(rows)

    @staticmethod
    def backward(ctx, g):
        g_np = g.detach().to("cpu", torch.float32).numpy().reshape(
            -1, ctx.dim)
        ctx.sink(ctx.flat, g_np)
        return None, None, None, None, None


def _ids_numpy(ids):
    if isinstance(ids, Tensor):
        ids = ids._data
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, dtype=np.int64)


class SparseEmbedding:
    """A host table's rows looked up onto `device`, with the table updated
    from their gradient.

    forward: ids -> pull the rows -> a Tensor on `device`;
    backward: the rows' gradient -> a push into the table (or the
    communicator). An eager op: the pull and the push cross the host, as
    the reference's distributed_lookup_table does its RPC."""

    def __init__(self, dim, rule="adagrad", lr=0.05, init_range=0.01,
                 seed=0, communicator=None, table=None, device="cuda"):
        self.device = resolve_device(device)
        self.table = table if table is not None else \
            SparseTable(dim, rule=rule, lr=lr, init_range=init_range,
                        seed=seed)
        self.dim = self.table.dim
        self.comm = communicator

    def __call__(self, ids):
        ids_np = _ids_numpy(ids)
        flat = ids_np.reshape(-1)
        rows = torch.from_numpy(self.table.pull(flat)).to(self.device)
        rows = rows.reshape(*ids_np.shape, self.dim)
        if not torch.is_grad_enabled():
            return Tensor(rows)
        sink = self.comm.push_sparse if self.comm is not None \
            else self.table.push
        anchor = torch.zeros((), requires_grad=True)
        return _wrap(_PushRows.apply(anchor, rows, flat, sink, self.dim))


def sparse_embedding(ids, table, communicator=None, device="cuda"):
    """SparseEmbedding over an existing table, as a function."""
    return SparseEmbedding(table.dim, table=table, communicator=communicator,
                           device=device)(ids)


class PSContext:
    """fleet's PS-mode runtime (the_one_ps.py TheOnePS): tables by name,
    their communicators, save and load. `init_server` / `run_server` are
    there for the API (the tables serve in this process)."""

    def __init__(self):
        self._tables = {}
        self._comms = {}

    def create_table(self, name, dim, rule="adagrad", lr=0.05,
                     init_range=0.01, seed=0, async_push=True,
                     table_class="MemorySparseTable", **table_kwargs):
        t = make_table(dim, table_class=table_class, rule=rule, lr=lr,
                       init_range=init_range, seed=seed, **table_kwargs)
        self._tables[name] = t
        if async_push:
            c = AsyncCommunicator(t)
            c.start()
            self._comms[name] = c
        return t

    def create_table_from_strategy(self, name, dim, strategy, **overrides):
        """A table of the type and tier settings of
        DistributedStrategy.sparse_table_configs."""
        cfg = dict(getattr(strategy, "sparse_table_configs", None) or {})
        cfg.update(overrides)
        cfg.pop("shard_num", None)   # sharding is the transport's concern
        table_class = cfg.pop("table_class", "MemorySparseTable")
        ssd_path = cfg.pop("ssd_path", None)
        if table_class == "SSDSparseTable":
            if ssd_path:
                cfg["path"] = ssd_path
            if not cfg.get("path"):
                raise ValueError(
                    "sparse_table_configs['ssd_path'] must point at the "
                    "value-log file when table_class='SSDSparseTable'")
        else:
            cfg.pop("path", None)
            cfg.pop("hot_capacity", None)
            cfg.pop("compact_ratio", None)
        return self.create_table(name, dim, table_class=table_class, **cfg)

    def table(self, name):
        return self._tables[name]

    def communicator(self, name):
        return self._comms.get(name)

    def embedding(self, name, device="cuda"):
        return SparseEmbedding(self._tables[name].dim,
                               table=self._tables[name],
                               communicator=self._comms.get(name),
                               device=device)

    def init_server(self, *a, **k):
        pass

    def run_server(self):
        pass

    def init_worker(self):
        pass

    def stop_worker(self):
        self.barrier()

    def barrier(self):
        for c in self._comms.values():
            c.flush()

    def save(self, dirname):
        os.makedirs(dirname, exist_ok=True)
        self.barrier()
        for name, t in self._tables.items():
            t.save(os.path.join(dirname, f"{name}.pstable"))

    def load(self, dirname):
        for name, t in self._tables.items():
            path = os.path.join(dirname, f"{name}.pstable")
            if os.path.exists(path):
                t.load(path)

    def shutdown(self):
        for c in self._comms.values():
            c.stop()
        self._comms.clear()
        for t in self._tables.values():
            t.destroy()
        self._tables.clear()


from .rpc import (DistGraphClient, DistributedSparseTable,  # noqa: E402,F401
                  PSClient, PSServer, PSServerError, PSUnavailableError,
                  RetryPolicy)
from .graph_table import GraphTable  # noqa: E402,F401
from .disk_table import DiskSparseTable  # noqa: E402,F401
from .device_cache import (CachedEmbedding,  # noqa: E402,F401
                           DeviceEmbeddingCache)

register_table_type("MemorySparseTable", SparseTable)
register_table_type("SSDSparseTable", DiskSparseTable)
