"""Serving beyond one engine (counterpart of `paddle_tpu.serving.distributed`).

  kv_handoff.py  — the KV-bundle wire format a prefill engine hands a
                   request's K/V to another engine with, byte-compatible
                   with the JAX package's
  worker.py      — one serving host: engine + scheduler behind the fleet
                   verbs (PREFILL, KVPUT, SUBMIT, POLL, SWAP, STAT,
                   METRICS, DUMP, PREFIXLOOKUP, KVEXPORT, HEALTH, DRAIN)
                   on the RPC fabric (`distributed/ps/rpc.py`), a decode
                   step loop, and weight hot-swap from committed
                   checkpoints
  router.py      — `DistFrontend`: placement over prefill and decode
                   pools, remote prefill with the KV handoff, streaming,
                   failover, the health plane, hedging, migration,
                   rolling drain and fleet swaps
  worker_main.py — `python -m paddle_tpu_torch.serving.distributed.
                   worker_main`, one worker process
  tp.py          — the tensor-parallel paged engine: weights and KV pools
                   split over explicit shards driven by one controller
  pp.py          — the pipeline-parallel paged engine (stages of tp
                   shards, the decode microbatch ring, chunked prefill
                   through the stages) and speculative decode on the ring

Not imported by `paddle_tpu_torch.serving`: single-engine serving does
not pay for the fabric.
"""
from .kv_handoff import (KVWireError, pack_kv_bundle,  # noqa: F401
                         pack_payload, unpack_kv_bundle, unpack_payload)
from .pp import (PipelineParallelEngineConfig,  # noqa: F401
                 PipelineParallelPagedEngine, PipelineParallelSpecConfig,
                 PipelineParallelSpeculativeEngine,
                 free_eager_device_copies)
from .router import (DistFrontend, DistRequest,  # noqa: F401
                     NoWorkersError, ServingShardClient)
from .tp import (TensorParallelEngineConfig,  # noqa: F401
                 TensorParallelPagedEngine)
from .worker import (ServingWorker, load_checkpoint_params,  # noqa: F401
                     save_swap_checkpoint)

__all__ = ["TensorParallelEngineConfig", "TensorParallelPagedEngine",
           "PipelineParallelEngineConfig", "PipelineParallelPagedEngine",
           "PipelineParallelSpecConfig", "PipelineParallelSpeculativeEngine",
           "free_eager_device_copies", "KVWireError", "pack_kv_bundle", "unpack_kv_bundle",
           "pack_payload", "unpack_payload",
           "ServingWorker", "load_checkpoint_params", "save_swap_checkpoint",
           "DistFrontend", "DistRequest", "NoWorkersError",
           "ServingShardClient"]
