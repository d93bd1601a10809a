"""paddle.distributed.fleet of the port (counterpart of
`paddle_tpu/distributed/fleet/__init__.py`; reference:
python/paddle/distributed/fleet/fleet.py).

`fleet.init(strategy)` installs the hybrid mesh of `strategy.
hybrid_configs` (`HybridCommunicateGroup`: one controller over every rank
in one process, one block of ranks a process under a process group);
`distributed_model` dispatches on the topology (`PipelineParallel` for a
`PipelineLayer` over pp, else the transparent `DataParallel`, with this
process's rows of the mp layers' parameters when mp spans processes);
`distributed_optimizer` applies the meta-optimizers the strategy's flags
select (LARS / LAMB substitution, DGC, LocalSGD, gradient merge) around
`HybridParallelOptimizer`. `fleet.elastic` is the launcher's relaunch
policy.

`UtilBase.all_reduce` stays local, as the reference's does: it returns
its input (ROADMAP C.22).
"""
from . import meta_parallel  # noqa: F401
from . import utils  # noqa: F401
from .. import env as _env
from .base.distributed_strategy import DistributedStrategy
from .base.topology import CommunicateTopology, HybridCommunicateGroup
from .utils import recompute  # noqa: F401

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "init", "is_first_worker",
           "worker_index", "worker_num", "get_hybrid_communicate_group",
           "get_strategy", "distributed_model", "distributed_optimizer",
           "GradientMergeOptimizer", "barrier_worker", "UserDefinedRoleMaker",
           "PaddleCloudRoleMaker", "Role", "UtilBase", "util", "Fleet",
           "MultiSlotDataGenerator", "MultiSlotStringDataGenerator",
           "recompute", "meta_parallel", "utils"]

_fleet_state = {"initialized": False, "strategy": None, "hcg": None}


def init(role_maker=None, is_collective=True, strategy=None, log_level="INFO"):
    if strategy is None:
        strategy = DistributedStrategy()
    hc = strategy.hybrid_configs
    topo = CommunicateTopology(
        hybrid_group_names=("data", "pipe", "sharding", "model"),
        dims=(hc.get("dp_degree", 1), hc.get("pp_degree", 1),
              hc.get("sharding_degree", 1), hc.get("mp_degree", 1)))
    hcg = HybridCommunicateGroup(topo)
    _fleet_state.update(initialized=True, strategy=strategy, hcg=hcg)


def is_first_worker():
    return _env.get_rank() == 0


def worker_index():
    return _env.get_rank()


def worker_num():
    return _env.get_world_size()


def get_hybrid_communicate_group():
    return _fleet_state["hcg"]


def get_strategy():
    return _fleet_state["strategy"]


def distributed_model(model):
    """Reference: fleet/model.py:29 — dispatch by topology."""
    from ..parallel_layers import wrap_distributed_model
    if _fleet_state["hcg"] is None:
        init()
    return wrap_distributed_model(model, _fleet_state["hcg"],
                                  _fleet_state["strategy"])


def distributed_optimizer(optimizer, strategy=None):
    """Reference: fleet/fleet.py distributed_optimizer: the
    meta-optimizers the strategy's flags select, then
    `HybridParallelOptimizer` (DGC and LocalSGD replace it: each does its
    own dp sync), then gradient merge around the result."""
    from ...optimizer import Lamb, LarsMomentum, Momentum, SGD
    from ..parallel_layers import HybridParallelOptimizer
    hcg = _fleet_state["hcg"]
    strategy = strategy or _fleet_state["strategy"] or DistributedStrategy()
    if strategy.lars and isinstance(optimizer, (SGD, Momentum)):
        cfg = getattr(strategy, "lars_configs", {}) or {}
        optimizer = LarsMomentum(
            learning_rate=optimizer._lr,
            momentum=getattr(optimizer, "_momentum", 0.9),
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            parameters=optimizer._parameters,
            grad_clip=optimizer._grad_clip,
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay", []))
    if strategy.lamb and not isinstance(optimizer, Lamb):
        cfg = getattr(strategy, "lamb_configs", {}) or {}
        optimizer = Lamb(
            learning_rate=optimizer._lr,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            parameters=optimizer._parameters,
            grad_clip=optimizer._grad_clip)
    if strategy.dgc:
        # the reference restricts DGC to Momentum: its update rule is
        # momentum SGD
        if not isinstance(optimizer, (SGD, Momentum, LarsMomentum)):
            raise TypeError(
                f"strategy.dgc requires a Momentum/SGD optimizer "
                f"(reference dgc_optimizer.py restriction); got "
                f"{type(optimizer).__name__}")
        from .meta_optimizers import DGCMomentumOptimizer
        cfg = getattr(strategy, "dgc_configs", {}) or {}
        opt = DGCMomentumOptimizer(
            optimizer,
            rampup_begin_step=cfg.get("rampup_begin_step", 0),
            rampup_step=cfg.get("rampup_step", 1),
            sparsity=cfg.get("sparsity", [0.999]),
            momentum=getattr(optimizer, "_momentum", 0.9))
    elif strategy.localsgd:
        # no per-step gradient all-reduce: a k-step parameter average
        # replaces it
        from .meta_optimizers import LocalSGDOptimizer
        cfg = getattr(strategy, "localsgd_configs", {}) or {}
        opt = LocalSGDOptimizer(optimizer, k_steps=cfg.get("k_steps", 1),
                                begin_step=cfg.get("begin_step", 1))
    else:
        opt = HybridParallelOptimizer(optimizer, hcg, strategy)
    if strategy.gradient_merge:
        k = int(strategy.gradient_merge_configs.get("k_steps", 1))
        avg = bool(strategy.gradient_merge_configs.get("avg", True))
        opt = GradientMergeOptimizer(opt, k_steps=k, avg=avg)
    return opt


class GradientMergeOptimizer:
    """Gradient merge (reference: meta_optimizers/
    gradient_merge_optimizer.py): gradients accumulate over `k_steps`
    calls of `step()`, then one update (divided by k with `avg`)."""

    def __init__(self, inner, k_steps=1, avg=True):
        self._inner = inner
        self._k = max(int(k_steps), 1)
        self._avg = avg
        self._count = 0

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def step(self):
        self._count += 1
        if self._count < self._k:
            return
        if self._avg and self._k > 1:
            for p in self._inner._parameters:
                if p._data.grad is not None:
                    p._data.grad = p._data.grad / float(self._k)
        self._inner.step()
        self._inner.clear_grad()
        self._count = 0

    def clear_grad(self, *a, **k):
        # mid-window the accumulated gradients must survive the user's
        # step() / clear_grad() pair
        if self._count == 0:
            self._inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        # not the inner minimize, which would skip the merge window
        loss.backward()
        self.step()


def barrier_worker():
    from ..collective import barrier
    barrier()


class UserDefinedRoleMaker:
    def __init__(self, *args, **kwargs):
        pass


class PaddleCloudRoleMaker:
    """Reference: fleet/base/role_maker.py:526."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective

    def worker_index(self):
        return _env.get_rank()

    def worker_num(self):
        return _env.get_world_size()

    def is_first_worker(self):
        return _env.get_rank() == 0


class Role:
    """Reference: fleet/base/role_maker.py Role constants."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class UtilBase:
    """Reference: fleet/utils/fleet_util.py UtilBase, as the JAX package
    keeps it: its reductions are local (ROADMAP C.22)."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        arr = np.asarray(input)
        return {"sum": arr, "max": arr, "min": arr}[mode]

    def barrier(self, comm_world="worker"):
        barrier_worker()

    def all_gather(self, input, comm_world="worker"):
        return [input]

    def get_file_shard(self, files):
        return list(files)[worker_index()::worker_num()]

    def print_on_rank(self, message, rank_id=0):
        if worker_index() == rank_id:
            print(message)


util = UtilBase()


class Fleet:
    """Reference: fleet/fleet.py Fleet, the class behind the module's
    functions."""

    def __init__(self):
        self.util = UtilBase()

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        return init(role_maker, is_collective, strategy, log_level)

    def is_first_worker(self):
        return is_first_worker()

    def worker_index(self):
        return worker_index()

    def worker_num(self):
        return worker_num()

    def distributed_model(self, model):
        return distributed_model(model)

    def distributed_optimizer(self, optimizer, strategy=None):
        return distributed_optimizer(optimizer, strategy)


class MultiSlotDataGenerator:
    """Reference: distributed/fleet/data_generator: subclass and implement
    generate_sample(line) yielding [(slot_name, [ids...]), ...]; the run
    methods write each record in the slot wire format."""

    def generate_sample(self, line):
        raise NotImplementedError

    def _format(self, record):
        parts = []
        for _slot, ids in record:
            parts.append(str(len(ids)))
            parts.extend(str(i) for i in ids)
        return " ".join(parts)

    def run_from_memory(self, lines):
        out = []
        for line in lines:
            gen = self.generate_sample(line)
            for rec in (gen() if callable(gen) else gen):
                out.append(self._format(rec))
        return out

    def run_from_stdin(self):
        import sys
        for line in sys.stdin:
            gen = self.generate_sample(line.rstrip("\n"))
            for rec in (gen() if callable(gen) else gen):
                sys.stdout.write(self._format(rec) + "\n")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """The string-slot variant (ids stay strings)."""
