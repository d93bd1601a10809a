"""paddle.distributed of the port (counterpart of `paddle_tpu.distributed`).

  env.py         — the process group (`init_parallel_env` over the
                   launcher's PADDLE_* variables), the mesh of ranks
                   (`build_mesh`: a `parallel.collectives.RankGrid`,
                   one block of ranks a process) and the live-axis
                   contexts
  collective.py  — the collectives across processes (`torch.distributed`),
                   in a one-controller manual region (the list
                   collectives of `parallel/collectives.py`) and eagerly
                   over a one-process mesh axis; `communication.stream`
                   and `comm_extras.py` complete the namespace
  store.py       — `TCPStore` over the port's `native/src/kvstore.cc`
  launch/        — `python -m paddle_tpu_torch.distributed.launch`;
                   `fleet/elastic` relaunches a failed job
  parallel_layers.py — `DataParallel`, `HybridParallelOptimizer`,
                   `param_partition_spec`, `wrap_distributed_model`
  fleet/         — `fleet.init` and the hybrid topology, the mp layers
                   behind `split`, `meta_parallel` (PipelineLayer and
                   the pipeline runner), the meta optimizers, `utils`
                   (recompute); `fleet/elastic` relaunches a failed job
  sharding/      — ZeRO's `group_sharded_parallel`
  auto_parallel/ — `ProcessMesh`, `shard_tensor` / `shard_op`, `Engine`
  checkpoint.py  — state-dict checkpoints in the JAX package's layout,
                   committed through `framework.ckpt_commit`
  ps/            — the parameter server: the sparse tables
                   (`make_table`, the native `SparseTable`, the disk
                   tier), `SparseEmbedding` and the `AsyncCommunicator`,
                   the device embedding cache, the graph table, and
                   `rpc.py`, the transport of their verbs and of the
                   serving fleet's
  passes.py      — `new_pass` / `PassManager` / `PassContext` over the
                   program rewrites of `static.ir_pass`
"""
from . import checkpoint  # noqa: F401
from . import env  # noqa: F401
from . import fleet  # noqa: F401
from . import auto_parallel  # noqa: F401
from . import sharding  # noqa: F401
from . import passes  # noqa: F401
from . import communication  # noqa: F401
from .checkpoint import (CheckpointCorruptError,  # noqa: F401
                         load_state_dict, save_state_dict)
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_concat, all_reduce, alltoall,
    alltoall_single, barrier, broadcast, destroy_process_group, get_backend,
    get_group, is_initialized, new_group, p2p_shift, recv, reduce,
    reduce_scatter, scatter, send, wait,
)
from .env import (  # noqa: F401
    ParallelEnv, build_mesh, get_mesh, get_rank, get_world_size,
    init_parallel_env, set_mesh,
)
from .parallel_layers import DataParallel  # noqa: F401
from .store import TCPStore  # noqa: F401
from .comm_extras import (  # noqa: F401
    CountFilterEntry, InMemoryDataset, ParallelMode, ProbabilityEntry,
    QueueDataset, ShowClickEntry, all_gather_object, gloo_barrier,
    gloo_init_parallel_env, gloo_release, irecv, isend, split)

__all__ = [
    "checkpoint", "env", "fleet", "auto_parallel", "sharding", "passes",
    "communication", "load_state_dict",
    "save_state_dict", "CheckpointCorruptError", "Group", "ReduceOp",
    "all_gather", "all_gather_concat", "all_reduce", "alltoall",
    "alltoall_single", "barrier", "broadcast", "destroy_process_group",
    "get_backend", "get_group", "is_initialized", "new_group", "p2p_shift",
    "recv", "reduce", "reduce_scatter", "scatter", "send", "wait",
    "ParallelEnv", "build_mesh", "get_mesh", "get_rank", "get_world_size",
    "init_parallel_env", "set_mesh", "DataParallel", "TCPStore",
    "CountFilterEntry", "InMemoryDataset", "ParallelMode",
    "ProbabilityEntry", "QueueDataset", "ShowClickEntry",
    "all_gather_object", "gloo_barrier", "gloo_init_parallel_env",
    "gloo_release", "irecv", "isend", "split", "spawn", "launch"]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """paddle.distributed.spawn (reference: distributed/__init__.py:27-38):
    `init_parallel_env()` and then `func(*args)` once in this process, as
    the reference does. Start one process a rank with `launch`."""
    init_parallel_env()
    func(*args)


def launch():
    from .launch.main import main
    main()
