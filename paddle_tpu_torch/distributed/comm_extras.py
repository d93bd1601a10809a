"""distributed namespace completion (counterpart of
`paddle_tpu/distributed/comm_extras.py`): async send/recv facades, object
collectives, ParallelMode, gloo shims, the PS entry-attr config classes
and the PS datasets.

`split` builds fleet's tensor-parallel layers (`fleet.layers.mp_layers`)
and applies them.
"""
import pickle

import numpy as np
import torch
import torch.distributed as dist

from ..core.tensor import Tensor, _wrap
from . import collective as C
from . import env

__all__ = [
    "isend", "irecv", "all_gather_object", "split", "ParallelMode",
    "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
    "ProbabilityEntry", "CountFilterEntry", "ShowClickEntry",
    "InMemoryDataset", "QueueDataset",
]


class ParallelMode:
    """reference: fleet/base/topology.py:29 ParallelMode constants."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class _Task:
    """Completed-communication handle (reference ProcessGroup::Task). The
    port's send and recv return when they are done, so the task is born
    done; wait() waits for the tensor's device."""

    def __init__(self, tensor):
        self._tensor = tensor

    def wait(self):
        if isinstance(self._tensor, Tensor):
            C.wait(self._tensor)
        return True

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None):
    """Async send (reference: distributed/communication isend). Returns a
    Task; the send itself rides the same path as send()."""
    C.send(tensor, dst, group)
    return _Task(tensor)


def irecv(tensor, src=0, group=None):
    C.recv(tensor, src, group)
    return _Task(tensor)


def all_gather_object(object_list, obj, group=None):
    """Gather picklable objects (reference: collective.py:1052). Across
    processes: `torch.distributed.all_gather_object`, one object a
    process; otherwise every rank's object is this process's."""
    del object_list[:]
    if C._cross_process(group):
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        object_list.extend(out)
        return object_list
    n = env.get_world_size()
    payload = pickle.dumps(obj)
    arr = _wrap(torch.from_numpy(np.frombuffer(payload, np.uint8).copy()))
    gathered = []
    C.all_gather(gathered, arr, group=group)
    for g in gathered[:n] or [arr] * n:
        object_list.append(pickle.loads(bytes(g.numpy().astype(np.uint8))))
    return object_list


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Tensor-parallel op splitter (reference:
    fleet/layers/mpu/mp_ops.py:582): builds fleet's parallel embedding /
    column / row layer and applies it. axis=0 of a linear splits the
    input features (row-parallel), axis=1 the output features
    (column-parallel). The layer takes the mp context it is called in
    (`mp_layers.py`); when fleet's mp axis spans the processes, one rank
    a process, it keeps this process's rows of its weight."""
    from .fleet import get_hybrid_communicate_group
    from .fleet.layers.mp_layers import (ColumnParallelLinear,
                                         RowParallelLinear,
                                         VocabParallelEmbedding,
                                         shard_mp_params)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1],
                                       weight_attr=weight_attr)
    elif operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1],
                                      weight_attr=weight_attr,
                                      has_bias=bias_attr is not False,
                                      input_is_parallel=not gather_out)
        else:
            layer = ColumnParallelLinear(size[0], size[1],
                                         weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
    else:
        raise ValueError(f"split: unsupported operation {operation!r} "
                         f"(embedding|linear)")
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_model_parallel_world_size() > 1:
        group = hcg.get_model_parallel_group()
        if group.spans_processes():
            shard_mp_params(layer, hcg.get_model_parallel_rank(),
                            hcg.get_model_parallel_world_size(),
                            group.process_group)
    return layer(x)


# ------------------------------------------------------------- gloo shims
def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """reference: parallel.py gloo_init_parallel_env — CPU rendezvous.
    The process group covers it here: `init_parallel_env(backend="gloo")`
    over the launcher's variables."""
    env.init_parallel_env(backend="gloo")


def gloo_barrier():
    C.barrier()


def gloo_release():
    return None


# ----------------------------------------------------- PS entry attrs
class EntryAttr:
    def _to_attr(self):
        raise NotImplementedError


class ProbabilityEntry(EntryAttr):
    """reference: distributed/entry_attr.py:59 — probabilistic admission of
    new sparse features into the PS table."""

    def __init__(self, probability):
        if not 0.0 < probability <= 1.0:
            raise ValueError("probability must be in (0, 1]")
        self._probability = float(probability)

    def _to_attr(self):
        return f"probability_entry:{self._probability}"


class CountFilterEntry(EntryAttr):
    """reference: entry_attr.py:100 — admit a feature only after it has
    been seen `count_filter` times."""

    def __init__(self, count_filter):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self._count_filter = int(count_filter)

    def _to_attr(self):
        return f"count_filter_entry:{self._count_filter}"


class ShowClickEntry(EntryAttr):
    """reference: entry_attr.py:142 — show/click-weighted embedding
    updates (CTR models)."""

    def __init__(self, show_name, click_name):
        self._show = str(show_name)
        self._click = str(click_name)

    def _to_attr(self):
        return f"show_click_entry:{self._show}:{self._click}"


# ----------------------------------------------------- PS datasets
class InMemoryDataset:
    """reference: distributed/fleet/dataset InMemoryDataset (C++
    data_set.cc): loads slot files into memory, supports local/global
    shuffle, then feeds training. Condensed host implementation over
    numpy batches — the native shm-ring DataLoader (io/) is the
    high-throughput path; this class keeps PS-style training scripts
    runnable."""

    def __init__(self):
        self._filelist = []
        self._records = []
        self._parse_fn = None
        self._batch_size = 1
        self._thread = 1
        self._use_var = None

    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command=None,
             input_type=0, fs_name="", fs_ugi="", **kwargs):
        self._batch_size = batch_size
        self._thread = thread_num
        self._use_var = use_var

    set_batch_size = lambda self, b: setattr(self, "_batch_size", b)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_parse_fn(self, fn):
        self._parse_fn = fn

    def load_into_memory(self):
        self._records = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    rec = self._parse_fn(line) if self._parse_fn else \
                        line.split()
                    self._records.append(rec)

    def local_shuffle(self):
        np.random.shuffle(self._records)

    def global_shuffle(self, fleet=None, thread_num=12):
        # single-controller: global == local
        self.local_shuffle()

    def get_memory_data_size(self, fleet=None):
        return len(self._records)

    def release_memory(self):
        self._records = []

    def __iter__(self):
        for i in range(0, len(self._records), self._batch_size):
            yield self._records[i:i + self._batch_size]


class QueueDataset(InMemoryDataset):
    """reference: QueueDataset — streaming variant; here iteration reads
    files lazily instead of preloading."""

    def load_into_memory(self):
        raise RuntimeError("QueueDataset streams from files; iterate "
                           "directly (reference raises the same)")

    def __iter__(self):
        batch = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    rec = self._parse_fn(line.rstrip("\n")) \
                        if self._parse_fn else line.split()
                    batch.append(rec)
                    if len(batch) == self._batch_size:
                        yield batch
                        batch = []
        if batch:
            yield batch
