"""A pass's embedding rows on the device (counterpart of
`paddle_tpu/distributed/ps/device_cache.py`).

Reference: paddle/fluid/framework/fleet/ps_gpu_wrapper.cc and heter_ps/'s
CUDA hash tables: before a training pass the hot rows are pulled from the
host table into device memory (BuildPull), lookups and optimizer updates
run on the device for the whole pass, and EndPass writes the rows and
their optimizer slots back.

  * The cache is two tensors on the caller's device: the values (C, dim)
    and the optimizer state (C, slot; adagrad's sum of squares). The id ->
    slot map stays on the host (the pass's sorted keys and
    `searchsorted`), since the lookups are issued from the host.
  * `lookup` is a gather; `update` merges duplicate ids on the host
    (`merge_by_key`, as the communicator does) and applies the table's own
    rule (`native/src/ps_table.cc`: sgd, adagrad) to the merged rows with
    one scatter of each tensor, in the table's order of f32 operations,
    so a flush is a copy of state: a pass through the cache leaves the
    table as pushing the same merged rows to it directly does.
  * Adam stays on the host (its per-row step counter); `DeviceEmbeddingCache`
    refuses an adam table, as the reference does.

The JAX cache is `jnp` code, not a Pallas kernel, so this is plain
PyTorch.
"""
import numpy as np
import torch

from ...core.device import resolve_device

__all__ = ["DeviceEmbeddingCache", "CachedEmbedding"]

_EPS = 1e-8  # ps_table.cc Table::eps


def _sqrt_f32(x):
    """The correctly rounded f32 square root, as the C++ rule takes it:
    torch's f32 sqrt on the CPU is an approximation; the f64 root rounded
    to f32 is exact (f64 carries more than twice f32's bits)."""
    return torch.sqrt(x.double()).float()


class DeviceEmbeddingCache:
    """A host `SparseTable`'s rows of one training pass, on `device`.

    build_pass(keys) pulls the pass's rows (values and optimizer state)
    onto the device; lookup() / update() run there; flush() assigns the
    updated rows back into the table."""

    def __init__(self, table, device="cuda"):
        if table.rule not in ("sgd", "adagrad"):
            raise ValueError(
                f"DeviceEmbeddingCache supports sgd/adagrad, not "
                f"{table.rule!r} (adam's per-row step counter must stay "
                "host-side)")
        self.device = resolve_device(device)
        self.table = table
        self.dim = table.dim
        self._keys = None          # sorted unique int64 keys of this pass
        self._values = None        # (C, dim) f32 on the device
        self._state = None         # (C, slot or 1) f32 on the device

    # ------------------------------------------------------------ the pass
    def build_pass(self, keys):
        """Pull the pass's keys onto the device (ps_gpu_wrapper
        BuildPull)."""
        self._keys = np.unique(np.asarray(keys, np.int64).reshape(-1))
        vals, state = self.table.pull_with_state(self._keys)
        if not state.size:
            state = np.zeros((self._keys.size, 1), np.float32)
        self._values = torch.from_numpy(vals).to(self.device)
        self._state = torch.from_numpy(
            np.ascontiguousarray(state)).to(self.device)
        return self

    @property
    def keys(self):
        """The pass's sorted unique keys (row i of the cache is keys[i])."""
        return self._keys

    @property
    def capacity(self):
        return 0 if self._keys is None else int(self._keys.size)

    def slots(self, ids):
        """The cache rows of `ids` (flattened), on the device."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        slots = np.searchsorted(self._keys, ids)
        if (slots >= self._keys.size).any() or \
                (self._keys[np.minimum(slots, self._keys.size - 1)]
                 != ids).any():
            missing = np.setdiff1d(np.unique(ids), self._keys)
            raise KeyError(
                f"{missing.size} ids not in this pass's cache (e.g. "
                f"{missing[:5].tolist()}); call build_pass with the full "
                "pass key set")
        return torch.from_numpy(slots).to(self.device)

    # ------------------------------------------------------ on the device
    def lookup(self, ids):
        """ids (any shape) -> (..., dim) f32 rows on the device."""
        if self._keys is None:
            raise RuntimeError("build_pass() first")
        ids = np.asarray(ids, np.int64)
        return self.gather(self.slots(ids)).reshape(ids.shape + (self.dim,))

    def gather(self, slots):
        """The rows at `slots` (the lookup's device work)."""
        return self._values.index_select(0, slots)

    def update(self, ids, grads):
        """Apply the table's rule on the device to these ids' rows:
        duplicate ids are merged first (`merge_by_key`)."""
        return self.apply_merged(*self.merge(ids, grads))

    def merge(self, ids, grads):
        """(slots, merged gradient rows) on the device: one summed row a
        unique id, merged on the host as the communicator merges."""
        from . import merge_by_key
        if self._keys is None:
            raise RuntimeError("build_pass() first")
        if isinstance(grads, torch.Tensor):
            grads = grads.detach().to("cpu", torch.float32).numpy()
        uniq, merged = merge_by_key(ids, grads, self.dim)
        return self.slots(uniq), torch.from_numpy(merged).to(self.device)

    def apply_merged(self, slots, g):
        """The table's rule on the rows at `slots` (unique) with gradient
        rows `g`: the update's device work."""
        lr = self.table.lr
        if self.table.rule == "sgd":
            # ps_table.cc: r -= lr * g
            rows = self._values.index_select(0, slots) - lr * g
        else:
            # ps_table.cc: g2 += g * g; r -= lr * g / (sqrt(g2) + eps)
            g2 = self._state.index_select(0, slots) + g * g
            self._state.index_copy_(0, slots, g2)
            rows = self._values.index_select(0, slots) - \
                lr * g / (_sqrt_f32(g2) + _EPS)
        self._values.index_copy_(0, slots, rows)
        return self

    # --------------------------------------------------------------- flush
    def flush(self):
        """Write the device rows (and optimizer state) back into the host
        table (ps_gpu_wrapper EndPass)."""
        if self._keys is None:
            return self
        vals = self._values.cpu().numpy()
        state = self._state.cpu().numpy()[:, :self.table.slot] \
            if self.table.slot else None
        self.table.assign(self._keys, vals, state)
        return self


class _CachedRows(torch.autograd.Function):
    """Gathered rows as a differentiable value; the backward applies the
    table's rule in the cache."""

    @staticmethod
    def forward(ctx, anchor, rows, cache, flat):
        ctx.cache, ctx.flat = cache, flat
        return rows.view_as(rows)

    @staticmethod
    def backward(ctx, g):
        ctx.cache.update(ctx.flat, g.reshape(-1, ctx.cache.dim))
        return None, None, None, None


class CachedEmbedding:
    """SparseEmbedding over a pass's device cache (the GPU-PS lookup of
    distributed_lookup_table): the forward gathers on the device, the
    backward applies the sparse rule there. Call flush() at the pass's
    end."""

    def __init__(self, table, pass_keys=None, device="cuda"):
        self.cache = DeviceEmbeddingCache(table, device=device)
        if pass_keys is not None:
            self.cache.build_pass(pass_keys)
        self.dim = table.dim

    def build_pass(self, keys):
        self.cache.build_pass(keys)
        return self

    def __call__(self, ids):
        from ...core.tensor import Tensor, _wrap
        from . import _ids_numpy
        ids_np = _ids_numpy(ids)
        rows = self.cache.lookup(ids_np)
        if not torch.is_grad_enabled():
            return Tensor(rows)
        anchor = torch.zeros((), requires_grad=True)
        return _wrap(_CachedRows.apply(anchor, rows, self.cache,
                                       ids_np.reshape(-1)))

    def flush(self):
        self.cache.flush()
        return self
