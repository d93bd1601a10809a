"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package imports
neither it nor JAX. Its slices so far:
  * serving: the paged-KV GPT engines and scheduler, whose attention runs
    on a hand-written CUDA kernel (`csrc/paged_attention.cu`, bound in
    `ops/paged_attention.py`);
  * training: the single-device GPT step of `parallel/gpt_spmd.py`, whose
    attention runs on hand-written flash-attention forward, dQ and dK/dV
    kernels (`csrc/flash_attention.cu`, bound in
    `ops/flash_attention.py`);
  * observability: the metrics registry, trace context, fault sites,
    flight recorder, decision and timeline records, fleet federation
    (`observability/`) and the host span tracer (`profiler/`), which the
    serving scheduler's SLO machinery reports through;
  * the device profile and the cost model: `observability/deviceprof.py`
    (torch.profiler captures parsed into deviceprof.v1 records),
    `cost_model/` (an analytical roofline over aten ops on fake tensors)
    and the `Profiler` windows and summary views of `profiler/`;
  * the serving fleet: the RPC fabric (`distributed/ps/rpc.py`),
    committed checkpoints (`framework/ckpt_commit.py`,
    `distributed/checkpoint.py`), and the worker verbs, router and
    worker process of `serving/distributed/`, which run prefill and
    decode workers as separate processes on one card;
  * warm start and deploy (the counterparts of `paddle_tpu.framework`'s
    `io`, `flags` and `compile_cache` and of `paddle_tpu.inference`):
    `serving.save_for_generation` writes a servable artifact, the kernel
    libraries live in a persistent compile cache, and
    `inference.create_predictor` serves the artifact cold in a new
    process.

Every entry point takes `device=` and defaults to "cuda"; without CUDA it
raises unless the caller passes device="cpu", which runs the plain
PyTorch versions of the kernels.
"""
from . import core, cost_model, observability, ops, parallel  # noqa: F401
from . import framework, inference, profiler  # noqa: F401
from . import serving, text  # noqa: F401
from .core.device import resolve_device  # noqa: F401
from .serving import (  # noqa: F401
    EngineConfig, GenerationEngine, PagedEngineConfig, PagedGenerationEngine,
    Scheduler, ServingConfig,
)
from .text.models import GPT, GPTConfig, gpt_125m, gpt_tiny  # noqa: F401

__version__ = "0.1.0"

__all__ = ["core", "cost_model", "framework", "inference", "observability",
           "ops", "parallel", "profiler",
           "serving", "text", "resolve_device",
           "EngineConfig", "GenerationEngine", "PagedEngineConfig",
           "PagedGenerationEngine", "Scheduler", "ServingConfig", "GPT",
           "GPTConfig", "gpt_125m", "gpt_tiny"]
