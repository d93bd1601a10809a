"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` stays the reference; this package imports
neither it nor JAX. Its slices so far:
  * serving: the paged-KV GPT engines and scheduler, whose attention runs
    on hand-written CUDA kernels (`csrc/paged_attention.cuh`, bound in
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
    process;
  * the eager core (counterpart of `paddle_tpu.core`, `.tensor`,
    `.autograd`, `.device`): the `Tensor` over one torch tensor, whose
    ops go through `core.tensor.apply_op` and whose tape is torch's
    autograd, `PyLayer`, and the `paddle.tensor` op surface;
  * `nn`, `optimizer`, `amp` and `regularizer`: the eager `Layer` and
    its containers, every `nn.functional`, the initializers, the common,
    activation, norm, loss and transformer Layers (whose attention runs
    on the flash kernels on the card, `nn/functional/attention.py`),
    gradient clipping, the optimizers and LR schedules, and AMP;
  * `io`, `metric`, `hapi`, `vision`, `callbacks`, `batch`, `reader`
    and the conv and pooling Layers: `Model.fit` over the `DataLoader`,
    whose worker processes return batches through the shared-memory
    ring (`native/`), the metrics, the callbacks, `summary` / `flops`,
    and the vision datasets, transforms, ops and model zoo;
  * `fft`, `signal`, `audio`, the RNN Layers and beam search of `nn`,
    and `text` (datasets, Viterbi, BERT, ERNIE, the GPT family);
  * `jit`, `static`, `onnx` and `distributed.passes`: `to_static` and
    the dy2static transpiler over `torch.fx` graphs, `jit.save` /
    `jit.load` of `torch.export` programs (which the `inference`
    Predictor serves), `static.Program` / `Executor` / the IR passes,
    and `static.nn`;
  * `distributed`: the process group and the mesh of ranks (`env`), the
    collectives, `TCPStore` over the port's `kvstore.cc`, the launcher
    and elastic relaunch, `DataParallel`, and `Model`'s dp route;
  * the rest of the surface: `sparse` (COO / CSR and the point-cloud
    convolutions, whose rulebook is built on the input's device),
    `distribution`, `quantization`, `geometric`, `incubate` (the fused
    transformer, ASP, autograd, optimizers, operators, checkpoint),
    `linalg`, `hub`, `sysconfig`, `version` and `utils`, whose
    `cpp_extension.load` builds `.cu` sources with nvcc; the custom-op
    recipe's kernel (`utils/cpp_extension/recipe/scale_shift.cu`) is
    built by it.

Exports of the eager core at this level: `Tensor`, `Parameter`,
`to_tensor`, every op of `tensor` (`add`, `matmul`, `reshape`, `topk`,
`randn`, ... and the `op_` in-place variants), the dtypes (`float32`,
`bfloat16`, `int64`, ...), `seed`, `get_rng_state`, `set_rng_state`,
`set_device`, `get_device`, `CPUPlace`, `CUDAPlace`, `no_grad`,
`enable_grad`, `is_grad_enabled`, `set_grad_enabled`, `grad`, and the
modules `autograd`, `device` and `tensor`. The default place is the GPU:
without CUDA, making a tensor raises unless `set_device("cpu")` or
`place="cpu"` was given.

Every entry point takes `device=` and defaults to "cuda"; without CUDA it
raises unless the caller passes device="cpu", which runs the plain
PyTorch versions of the kernels.
"""
from . import core, cost_model, observability, ops, parallel  # noqa: F401
from . import framework, inference, profiler  # noqa: F401
from . import serving, text  # noqa: F401
from . import autograd, device, tensor  # noqa: F401
from . import amp, nn, optimizer, regularizer  # noqa: F401
from . import callbacks, io, metric, native, reader, vision  # noqa: F401
from . import audio, fft, signal  # noqa: F401
from . import jit, onnx, static  # noqa: F401
from . import distributed  # noqa: F401
from . import incubate  # noqa: F401
from . import geometric, linalg, quantization, sparse  # noqa: F401
from . import distribution, hub, sysconfig, utils, version  # noqa: F401
from .distributed import DataParallel  # noqa: F401
from .jit import to_static  # noqa: F401
from .batch import batch  # noqa: F401
from .hapi import Model, flops, summary  # noqa: F401
from .autograd import grad  # noqa: F401
from .core import (  # noqa: F401
    CPUPlace, CUDAPlace, Parameter, Tensor, bfloat16, bool_, complex64,
    complex128, enable_grad, float16, float32, float64, get_default_dtype,
    get_device, get_rng_state, int8, int16, int32, int64, is_grad_enabled,
    no_grad, seed, set_default_dtype, set_device, set_grad_enabled,
    set_rng_state, to_tensor, uint8,
)
from .core.device import resolve_device  # noqa: F401
from .tensor import *  # noqa: F401,F403
from .tensor import __all__ as _tensor_ops
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
           "GPTConfig", "gpt_125m", "gpt_tiny", "autograd", "device",
           "tensor", "nn", "optimizer", "amp", "regularizer", "io",
           "metric", "vision", "callbacks", "native", "reader", "batch",
           "fft", "signal", "audio", "jit", "static", "onnx", "to_static",
           "distributed", "DataParallel", "incubate", "sparse", "linalg",
           "distribution", "version", "utils", "hub", "sysconfig",
           "quantization", "geometric",
           "Model", "summary", "flops", "grad", "CPUPlace", "CUDAPlace", "Parameter", "Tensor",
           "bfloat16", "bool_", "complex64", "complex128", "enable_grad",
           "float16", "float32", "float64", "get_default_dtype",
           "get_device", "get_rng_state", "int8", "int16", "int32", "int64",
           "is_grad_enabled", "no_grad", "seed", "set_default_dtype",
           "set_device", "set_grad_enabled", "set_rng_state", "to_tensor",
           "uint8"] + [n for n in _tensor_ops if n != "Tensor"]
