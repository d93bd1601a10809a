"""The multi-process `DataLoader`'s worker loop over the shared-memory
ring (counterpart of `paddle_tpu/io/worker.py`).

Workers are forked from the trainer and stay numpy-only: they pickle
numpy batches straight into the ring (`paddle_tpu_torch/native`), and the
trainer drains, reorders and turns them into tensors on its device. A
forked child must not touch CUDA once the trainer has initialised it
("Cannot re-initialize CUDA in forked subprocess"); a dataset that makes
or returns CUDA tensors in a worker therefore fails its batch with a
RuntimeError that names the cause, and the trainer raises it.
"""
import pickle
import traceback

import numpy as np
import torch

__all__ = ["WorkerInfo", "get_worker_info", "collate", "numpy_collate",
           "worker_loop", "CUDA_IN_WORKER"]

CUDA_IN_WORKER = (
    "DataLoader workers are forked processes and stay numpy-only: a worker "
    "cannot use CUDA after the trainer initialised it. Return numpy arrays "
    "(or CPU tensors) from the dataset and let the DataLoader move batches "
    "to the device, or use num_workers=0")


class WorkerInfo:
    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The running worker's `WorkerInfo` (id, num_workers, dataset); None
    in the trainer."""
    return _worker_info


def _host_array(t):
    """A CPU tensor (or port Tensor) as numpy; a CUDA one inside a worker
    is the error `CUDA_IN_WORKER` names."""
    from ..core.tensor import Tensor
    d = t._data if isinstance(t, Tensor) else t
    if _worker_info is not None and d.device.type != "cpu":
        raise RuntimeError(f"{CUDA_IN_WORKER} (a sample holds a tensor on "
                           f"{d.device})")
    return np.asarray(t.numpy() if isinstance(t, Tensor)
                      else d.detach().cpu().numpy())


def collate(batch, leaf):
    """The collate recursion; `leaf` decides what a stacked ndarray becomes
    (numpy in workers, a tensor in the trainer). Floats narrow to float32,
    integers keep int64."""
    from ..core.tensor import Tensor

    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return [collate([b[i] for b in batch], leaf)
                for i in range(len(sample))]
    if isinstance(sample, dict):
        return {k: collate([b[k] for b in batch], leaf) for k in sample}
    if isinstance(sample, (Tensor, torch.Tensor)):
        return leaf(np.stack([_host_array(b) for b in batch]))
    if isinstance(sample, np.ndarray):
        return leaf(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        # let numpy promote mixed int/float batches; floats narrow to f32
        # (the default dtype) instead of numpy's f64
        arr = np.asarray(batch)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        return leaf(arr)
    return batch


def numpy_collate(batch):
    """The workers' default collate: stacks to numpy, never to tensors."""
    return collate(batch, lambda arr: arr)


def _failure_text():
    text = traceback.format_exc()
    if "CUDA" in text and "fork" in text and CUDA_IN_WORKER not in text:
        text = f"{text}\nRuntimeError: {CUDA_IN_WORKER}"
    return text


def worker_loop(dataset, collate_fn, ring_name, index_queue, worker_init_fn,
                wid, num_workers, base_seed):
    """One worker: take (batch index, sample indices) from `index_queue`
    until None, put (index, "ok" | "err", batch | traceback, worker id)
    records into the ring."""
    from ..native import ShmRing

    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, dataset)
    np.random.seed((base_seed + wid) % (2 ** 31))
    ring = ShmRing(ring_name, create=False)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
        while True:
            item = index_queue.get()
            if item is None:
                break
            i, indices = item
            try:
                batch = collate_fn([dataset[j] for j in indices])
                payload = pickle.dumps((i, "ok", batch, wid),
                                       protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                payload = pickle.dumps((i, "err", _failure_text(), wid))
            try:
                ring.put(payload)
            except ValueError:
                # batch bigger than the whole ring: report instead of dying
                ring.put(pickle.dumps((
                    i, "err",
                    f"batch {i} pickled to {len(payload)} bytes, larger than "
                    f"the shm ring; reduce the batch size", wid)))
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        ring.release()
