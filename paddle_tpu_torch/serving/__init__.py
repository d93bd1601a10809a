"""Serving for the PyTorch port: paged KV, prefix cache, engines and the
continuous-batching scheduler (counterpart of `paddle_tpu.serving`).

  kv_cache.py     — dense preallocated KV cache and the masked `attend`
  blocks.py       — paged KV pool, block tables, int8 pools, BlockPool
  prefix_cache.py — shared prompt blocks keyed on a prefix hash
  sampling.py     — greedy / temperature / top-k / top-p selection
  graphs.py       — the serving executables as CUDA graphs, captured once
  engine.py       — dense and paged prefill/decode engines, int8 decode
                    weights, logit capture, weight hot-swap, KV handoff
                    (extract, adopt, prefix restore), KV tiers under the
                    prefix cache, LoRA adapters, `make_engine`, and the
                    servable artifact: `save_for_generation`,
                    `load_generation_model`, `default_compile_cache_dir`
  spec_decode.py  — speculative decode: draft proposals, one verify window
  scheduler.py    — priority queue, continuous batching, preemption,
                    speculative rounds, scheduled weight swaps, staged
                    placement from handed-off KV, deadlines, load
                    shedding, failure quarantine, cancellation, token
                    buckets, namespace quotas, adapter swaps, and the
                    serving metrics, decision and timeline records
  distributed/    — the serving fleet: the KV-bundle wire format, the
                    worker verbs, the router and the worker process
                    (imported on demand, not by this package)
  kv_tiers/       — the host and disk tiers under the prefix cache
  tenancy/        — LoRA adapters, the adapter bank and registry, token
                    buckets and tenant declarations
"""
from . import blocks, kv_cache, prefix_cache, sampling  # noqa: F401
from .blocks import (  # noqa: F401
    BlockAllocError, BlockPool, PagedLayerKV, QuantPagedLayerKV,
)
from .engine import (  # noqa: F401
    EngineConfig, GenerationEngine, PagedEngineConfig, PagedGenerationEngine,
    default_compile_cache_dir, load_generation_model, make_engine,
    save_for_generation,
)
from .prefix_cache import PrefixCache, prefix_key  # noqa: F401
from .scheduler import (  # noqa: F401
    PRIORITIES, LoadShedError, QueueFullError, RateLimitedError, Request,
    RequestHandle, Scheduler, ServingConfig,
)
from .spec_decode import (  # noqa: F401
    SpecDecodeConfig, SpeculativeEngine, truncated_draft,
)

__all__ = [
    "kv_cache", "blocks", "prefix_cache", "sampling",
    "BlockAllocError", "BlockPool", "PagedLayerKV", "QuantPagedLayerKV",
    "PrefixCache", "prefix_key",
    "EngineConfig", "GenerationEngine", "PagedEngineConfig",
    "PagedGenerationEngine", "make_engine", "save_for_generation",
    "default_compile_cache_dir", "load_generation_model",
    "PRIORITIES", "LoadShedError", "QueueFullError", "RateLimitedError",
    "Request",
    "RequestHandle", "Scheduler",
    "ServingConfig", "SpecDecodeConfig", "SpeculativeEngine",
    "truncated_draft",
]
