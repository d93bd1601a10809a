"""Per-tenant LoRA adapters for the serving engines.

Counterpart of `paddle_tpu/serving/tenancy/adapters.py`. Tenant T's
requests decode through the base weights plus T's low-rank delta, while a
batch mixing tenants still runs the one decode forward (on the card, the
one captured decode graph):

  - every adapted matmul (`qkv`, `out_proj`, `fc1`, `fc2` of each layer)
    holds its deltas stacked over adapter rows,
        A: [n_adapters, d_in, r]     B: [n_adapters, r, d_out]
    in the JAX orientation (the port's `nn.Linear` keeps the JAX output
    column order, `text/models/convert.py`, so no transpose). Row 0 is
    zero for good: the base model. Loading, replacing or dropping a
    tenant's adapter changes values, never shapes;
  - each engine slot carries an int32 adapter row id, and the forward
    gathers its delta by slot:
        delta = (x @ A[ids]) @ B[ids]      (index_select, then two bmm)
    so the tenants of a batch are data, not program structure;
  - alpha / r is folded into B at load time.

Ranks may differ per tenant: the bank is allocated at its largest rank
and lower ranks are zero-padded (the padding adds exactly zero).

Adapters ride decode and verify forwards only; prefill runs the base
weights, as in the reference (prefill runs once a request, decode every
token).

The bank keeps host masters; the engine that attaches it owns the device
copy (`device_tree`) and writes a loaded or dropped row into it in place,
the storage its captured decode graph reads.
"""
import numpy as np
import torch

__all__ = ["TARGETS", "target_dims", "lora_delta", "lora_apply",
           "AdapterState", "init_adapter_state", "AdapterBank"]

# the decode matmuls that take a delta, in model order
TARGETS = ("qkv", "out_proj", "fc1", "fc2")


def target_dims(cfg):
    """{target: (d_in, d_out)} for a GPTConfig-shaped config."""
    h = int(cfg.hidden_size)
    m = int(cfg.intermediate_size)
    return {"qkv": (h, 3 * h), "out_proj": (h, h),
            "fc1": (h, m), "fc2": (m, h)}


def lora_delta(x, a, b, ids):
    """The gather-by-slot low-rank delta. x [S, T, d_in] (S engine slots,
    T tokens a slot: 1 for decode, gamma+1 for a verify window),
    a [n, d_in, r], b [n, r, d_out] (alpha/r folded in), ids int [S].
    Returns [S, T, d_out]."""
    asel = a.index_select(0, ids)              # [S, d_in, r]
    bsel = b.index_select(0, ids)              # [S, r, d_out]
    return torch.bmm(torch.bmm(x.to(asel.dtype), asel), bsel)


def lora_apply(y, x, view, name):
    """`y` (a target's base output) plus `name`'s delta over its input
    `x`, given a layer's adapter view {"slot": ids, name: (a, b), ...};
    no view, or no entry for `name`, returns `y` as it is."""
    pair = None if view is None else view.get(name)
    if pair is None:
        return y
    a, b = pair
    return y + lora_delta(x, a, b, view["slot"]).to(y.dtype)


class AdapterState:
    """One tenant's adapter: {f"layers.{i}.{target}.{a|b}": np.ndarray}
    plus rank and alpha. The flat dict is what `distributed.checkpoint.
    save_state_dict` commits (the registry's path), alpha and rank riding
    as 0-d arrays."""

    def __init__(self, tensors, rank, alpha=None):
        self.tensors = dict(tensors)
        self.rank = int(rank)
        self.alpha = float(alpha) if alpha is not None else float(rank)

    def to_state_dict(self):
        d = {k: np.asarray(v) for k, v in self.tensors.items()}
        d["alpha"] = np.asarray(self.alpha, np.float64)
        d["rank"] = np.asarray(self.rank, np.int64)
        return d

    @classmethod
    def from_state_dict(cls, d):
        tensors = {k: np.asarray(v) for k, v in d.items()
                   if k not in ("alpha", "rank")}
        if "rank" in d:
            rank = int(np.asarray(d["rank"]))
        else:
            ranks = {v.shape[-1] for k, v in tensors.items()
                     if k.endswith(".a")}
            if len(ranks) != 1:
                raise ValueError(f"adapter state has ambiguous rank {ranks}")
            rank = ranks.pop()
        alpha = float(np.asarray(d["alpha"])) if "alpha" in d else None
        return cls(tensors, rank, alpha)


def init_adapter_state(cfg, rank, seed=0, targets=TARGETS, scale=0.01,
                       alpha=None):
    """A random adapter (tests, benchmarks): A and B ~ N(0, scale) from
    `np.random.default_rng(seed)`, drawn in the JAX package's order, so a
    seed gives the same adapter in both packages. B is not zero (training
    would start it at zero) so the delta shows in the logits."""
    rng = np.random.default_rng(seed)
    dims = target_dims(cfg)
    tensors = {}
    for i in range(int(cfg.num_layers)):
        for t in targets:
            din, dout = dims[t]
            tensors[f"layers.{i}.{t}.a"] = \
                rng.normal(0.0, scale, (din, rank)).astype(np.float32)
            tensors[f"layers.{i}.{t}.b"] = \
                rng.normal(0.0, scale, (rank, dout)).astype(np.float32)
    return AdapterState(tensors, rank, alpha)


class AdapterBank:
    """Host masters of the stacked per-row adapter arrays and the tenant
    -> adapter row assignment. Mutations validate everything, then write:
    a failed load leaves every row (the loading tenant's old adapter
    included) as it was."""

    def __init__(self, cfg, n_adapters, rank, targets=TARGETS,
                 dtype=np.float32):
        if n_adapters < 2:
            raise ValueError("n_adapters must be >= 2 (slot 0 is base)")
        self.num_layers = int(cfg.num_layers)
        self.n_adapters = int(n_adapters)
        self.rank = int(rank)
        self.targets = tuple(targets)
        self.dims = {t: target_dims(cfg)[t] for t in self.targets}
        self._a = {}
        self._b = {}
        for i in range(self.num_layers):
            for t in self.targets:
                din, dout = self.dims[t]
                self._a[(i, t)] = np.zeros(
                    (self.n_adapters, din, self.rank), dtype)
                self._b[(i, t)] = np.zeros(
                    (self.n_adapters, self.rank, dout), dtype)
        self._tenants = {}            # tenant -> adapter row (>= 1)
        self.version = 0

    def slot_of(self, tenant):
        """The tenant's adapter row; 0 (base) when none is loaded."""
        return self._tenants.get(tenant, 0)

    def tenants(self):
        return dict(self._tenants)

    def geometry(self):
        """What fixes the device tensors' shapes."""
        return (self.num_layers, self.n_adapters, self.rank, self.targets,
                tuple(self.dims[t] for t in self.targets),
                next(iter(self._a.values())).dtype.str)

    def rows(self, layer, target):
        """The host masters (A [n, d_in, r], B [n, r, d_out]) of one
        layer's target."""
        return self._a[(layer, target)], self._b[(layer, target)]

    def _stage(self, state):
        """Validate `state` against the bank and return its padded,
        alpha-folded rows, with no bank mutation."""
        if state.rank > self.rank:
            raise ValueError(f"adapter rank {state.rank} exceeds bank "
                             f"rank {self.rank}")
        scale = state.alpha / float(state.rank)
        staged = {}
        for i in range(self.num_layers):
            for t in self.targets:
                din, dout = self.dims[t]
                ka, kb = f"layers.{i}.{t}.a", f"layers.{i}.{t}.b"
                if ka not in state.tensors or kb not in state.tensors:
                    raise ValueError(f"adapter state missing {ka}/{kb}")
                a = np.asarray(state.tensors[ka])
                b = np.asarray(state.tensors[kb])
                if a.shape != (din, state.rank) or \
                        b.shape != (state.rank, dout):
                    raise ValueError(
                        f"adapter {ka}/{kb} shapes {a.shape}/{b.shape} "
                        f"!= ({din},{state.rank})/({state.rank},{dout})")
                pa = np.zeros((din, self.rank), self._a[(i, t)].dtype)
                pb = np.zeros((self.rank, dout), self._b[(i, t)].dtype)
                pa[:, :state.rank] = a
                pb[:state.rank, :] = b * scale
                staged[(i, t)] = (pa, pb)
        return staged

    def load(self, tenant, state):
        """Load or replace `tenant`'s adapter; everything is validated
        before a row is written. Returns the tenant's adapter row."""
        staged = self._stage(state)
        idx = self._tenants.get(tenant)
        if idx is None:
            used = set(self._tenants.values())
            idx = next((k for k in range(1, self.n_adapters)
                        if k not in used), None)
            if idx is None:
                raise ValueError(
                    f"adapter bank full ({self.n_adapters - 1} slots)")
        for (i, t), (pa, pb) in staged.items():
            self._a[(i, t)][idx] = pa
            self._b[(i, t)][idx] = pb
        self._tenants[tenant] = idx
        self.version += 1
        return idx

    def drop(self, tenant):
        """Forget `tenant`'s adapter (row zeroed; the row is reusable)."""
        idx = self._tenants.pop(tenant, None)
        if idx is not None:
            for i in range(self.num_layers):
                for t in self.targets:
                    self._a[(i, t)][idx] = 0.0
                    self._b[(i, t)][idx] = 0.0
            self.version += 1
        return idx

    def device_tree(self, device):
        """{"layers": (per-layer {target: (A, B)}, ...)}: new tensors on
        `device` holding the masters. The engine calls it once when it
        attaches the bank and owns the result."""
        return {"layers": tuple(
            {t: (torch.from_numpy(self._a[(i, t)].copy()).to(device),
                 torch.from_numpy(self._b[(i, t)].copy()).to(device))
             for t in self.targets}
            for i in range(self.num_layers))}
