"""The deploy entry point: a Predictor over a saved artifact.

Counterpart of `paddle_tpu/inference/__init__.py` (the reference's
`AnalysisPredictor` and `AnalysisConfig` surface): `Config`, the IO
handles (`Tensor`), `Predictor`, `create_predictor`, `PredictorPool` and
the enums and helpers beside them.

Artifacts, two kinds:

  * a generation artifact: `serving.save_for_generation` writes
    `prefix.pdiparams` (the weights in the JAX layout, `framework.io`)
    and `prefix.gencfg` (the GPT config and the serving record), and no
    `.pdmodel` (the port ignores the StableHLO one a JAX artifact
    carries). A JAX artifact of `save_for_generation` loads here
    unchanged. `run()` runs the GPT forward rebuilt from the record:
    `input_ids [B, S]` in, logits `[B, S, vocab]` out;
  * a program: `jit.save` (or `static.save_inference_model`) writes
    `prefix.pdmodel` (a `torch.export` program) and `prefix.pdiparams`.
    The input handles come from the program's inputs and the saved
    `feed_names`; `run()` calls the program, at any size of its dynamic
    dims. A program runs only on the device type it was traced on, and a
    JAX `.pdmodel` (StableHLO) raises and says what it is (`jit.load`).

A `.gencfg` wins: `Config(model_dir)` finds an artifact by its
`.gencfg` first, then by its `.pdmodel`; `Config(prefix)` /
`Config(prefix.pdmodel)` name one by its prefix.

Device. A Predictor runs on the card ("cuda", `enable_use_gpu`'s device
id) unless the config asked for the CPU (`disable_gpu()`); without CUDA
and without that request, building one raises.

Warm start. With the compile cache and the AOT warm-up on (both by
default) and a serving record in the artifact, the constructor rebuilds
the recorded engine with the artifact's compile cache
(`serving.default_compile_cache_dir`, or `enable_compile_cache(path)`)
and `precompile()`s it: the kernel libraries come from that cache (built
and committed on a miss) and the CUDA graphs are captured, so the first
`generate()` compiles and captures nothing. `ready_stages` holds the
seconds of each stage (weights read, model build, engine build, library
build or load, captures) and `precompile_report` the engine's report;
the `predictor_executable_ready_seconds` gauge is set to the total.

Nothing falls back: every recorded kind is built, the tensor- and
pipeline-parallel ones ("tp", "pp", "spec_pp") included, and every error
building the record (a bad field, a failed nvcc build, library load or
capture) raises from the constructor; nothing falls back to a dense
engine, the gather path or the CPU.
"""
import os
import time

import numpy as np

from ..serving.engine import GENCFG_SUFFIX, artifact_prefix

__all__ = ["Config", "Predictor", "PredictorPool", "PrecisionType",
           "PlaceType", "DataType", "Tensor", "create_predictor",
           "get_version", "get_num_bytes_of_data_type",
           "convert_to_mixed_precision", "get_trt_compile_version",
           "get_trt_runtime_version"]



class PrecisionType:
    Float32 = "float32"
    Bfloat16 = "bfloat16"
    Half = "float16"
    Int8 = "int8"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"


class Config:
    """AnalysisConfig's surface. Knobs that PyTorch owns are recorded and
    have no effect (noted per method)."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file is not None and params_file is None:
            if os.path.isdir(prog_file):
                names = sorted(os.listdir(prog_file))
                found = [f for f in names if f.endswith(GENCFG_SUFFIX)] or \
                    [f for f in names if f.endswith(".pdmodel")]
                if not found:
                    raise FileNotFoundError(
                        f"no {GENCFG_SUFFIX} or .pdmodel in {prog_file}")
                prog_file = os.path.join(prog_file, found[0])
            params_file = artifact_prefix(prog_file) + ".pdiparams"
        self._prog_file = prog_file
        self._params_file = params_file
        self._device = PlaceType.GPU
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._memory_optim = True
        self._ir_optim = True
        self._profile = False
        self._glog_info = True
        self._cpu_math_threads = 1
        # the artifact's compile cache (None: the `_compile_cache/` beside
        # it) and the load-time engine build and precompile
        self._compile_cache_dir = None
        self._compile_cache = True
        self._aot_warmup = True

    def enable_compile_cache(self, path=None):
        self._compile_cache = True
        self._compile_cache_dir = path

    def disable_compile_cache(self):
        """No private cache for the recorded engine (the libraries go
        through the global or default cache) and no load-time warm-up."""
        self._compile_cache = False

    def enable_aot_warmup(self):
        self._aot_warmup = True

    def disable_aot_warmup(self):
        """Skip the load-time engine build: the engine is built, its
        libraries resolved and its graphs captured on the first
        `generate()`."""
        self._aot_warmup = False

    # -- model location ----------------------------------------------------
    def set_prog_file(self, path):
        self._prog_file = path

    def set_params_file(self, path):
        self._params_file = path

    def prog_file(self):
        return self._prog_file

    def params_file(self):
        return self._params_file

    def set_model(self, prog_file, params_file):
        self._prog_file = prog_file
        self._params_file = params_file

    def artifact_prefix(self):
        """The artifact's path without a suffix."""
        return artifact_prefix(self._prog_file or self._params_file)

    # -- device ------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        """Run on CUDA device `device_id` (the PyTorch caching allocator
        owns the memory pool; the size hint is ignored)."""
        self._device = PlaceType.GPU
        self._device_id = int(device_id)

    def disable_gpu(self):
        """Run on the CPU: the kernels' plain PyTorch versions."""
        self._device = PlaceType.CPU

    def use_gpu(self):
        return self._device == PlaceType.GPU

    def torch_device(self):
        """"cuda:<id>" or "cpu"."""
        return f"cuda:{self._device_id}" if self.use_gpu() else "cpu"

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = n

    # -- optimization knobs (recorded) ---------------------------------------
    def switch_ir_optim(self, x=True):
        """Graph passes have no counterpart: the serving executables are
        CUDA graphs of a fixed forward. Recorded."""
        self._ir_optim = x

    def enable_memory_optim(self, x=True):
        """Buffer reuse is the caching allocator's and the graph pool's.
        Recorded."""
        self._memory_optim = x

    def enable_tensorrt_engine(self, *a, **k):
        """Accepted as a no-op so deploy scripts run unchanged: the port
        links no TensorRT; its kernels are its own."""

    def enable_profile(self):
        self._profile = True

    def disable_glog_info(self):
        self._glog_info = False

    def switch_use_feed_fetch_ops(self, x=False):
        pass

    def switch_specify_input_names(self, x=True):
        pass

    def summary(self):
        return (f"Config(prog={self._prog_file}, params={self._params_file}, "
                f"device={self.torch_device()}, "
                f"precision={self._precision})")


class _Handle:
    """Zero-copy-style IO handle (the reference's ZeroCopyTensor): an
    input stages a host array, uploaded at `run()`; an output holds the
    result and `copy_to_cpu` reads it."""

    def __init__(self, name, shape=None, dtype=None):
        self.name = name
        self._shape = shape
        self._dtype = dtype
        self._value = None

    def reshape(self, shape):
        self._shape = tuple(shape)

    def copy_from_cpu(self, arr):
        self._value = np.ascontiguousarray(arr)

    def share_external_data(self, arr):
        self._value = arr  # no copy; the caller keeps it alive

    def copy_to_cpu(self):
        v = self._value
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def shape(self):
        v = self._value
        return list(v.shape) if v is not None else list(self._shape or [])

    def type(self):
        return self._dtype


class Predictor:
    """AnalysisPredictor's counterpart over a generation artifact or a
    saved program."""

    def __init__(self, config):
        import torch

        from ..core.device import resolve_device
        from ..framework.io import load as _load
        from ..serving.engine import load_generation_model, read_gencfg

        self._config = config
        self._device = resolve_device(config.torch_device())
        prefix = config.artifact_prefix()
        meta = read_gencfg(prefix)
        self._program = None
        self._gen_sched = None
        if meta is None:
            self._init_program(prefix)
            return
        self.ready_stages = {}
        self.precompile_report = None
        t0 = time.perf_counter()
        payload = _load(config.params_file(), device="cpu")
        t1 = time.perf_counter()
        self.ready_stages["weights_read_s"] = t1 - t0
        self._model = load_generation_model(prefix, payload["params"],
                                            device=self._device)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.ready_stages["model_build_s"] = time.perf_counter() - t1
        self._max_pos = int(meta["config"]["max_position_embeddings"])
        saved = payload.get("feed_names")
        self._input_names = list(saved) if saved else ["input_ids"]
        self._inputs = {n: _Handle(n, (-1, self._max_pos), "int64")
                        for n in self._input_names}
        self._output_names = []
        self._outputs = {}
        self.last_ttft_s = []

        self._gen_sched = None
        self._gen_sched_from_record = False
        self._serving_meta = meta.get("serving")
        if self._serving_meta and config._aot_warmup \
                and config._compile_cache:
            from ..observability import metrics as _obs_metrics
            from ..serving import Scheduler
            t0 = time.perf_counter()
            self._gen_sched = Scheduler(self._record_engine(),
                                        device=self._device)
            self._gen_sched_from_record = True
            _obs_metrics.gauge(
                "predictor_executable_ready_seconds",
                "Predictor load-to-serving-ready wall time (AOT "
                "warmup included)").set(time.perf_counter() - t0)

    def _init_program(self, prefix):
        """A `jit.save` program: load it (refused unless traced for this
        device type), read the weights, and run it once on zeros with
        every dynamic dim at 1. `ready_stages` times the three."""
        import torch

        from ..framework.io import load as _load
        from ..jit import load_program
        self.ready_stages = {}
        self.precompile_report = None
        self._serving_meta = None
        self.last_ttft_s = []
        t0 = time.perf_counter()
        prog_file = self._config.prog_file()
        if prog_file is None or not prog_file.endswith(".pdmodel"):
            prog_file = prefix + ".pdmodel"
        if not os.path.exists(prog_file):
            raise FileNotFoundError(
                f"{prefix} has neither a {GENCFG_SUFFIX} record nor a "
                f"program ({prog_file})")
        ep = load_program(prog_file, self._device)
        t1 = time.perf_counter()
        self.ready_stages["program_load_s"] = t1 - t0
        payload = _load(self._config.params_file(), device=self._device)
        self._params = payload["params"]
        self._buffers = payload["buffers"]
        self._program = ep.module()
        t2 = time.perf_counter()
        self.ready_stages["weights_read_s"] = t2 - t1
        n_state = len(self._params) + len(self._buffers)
        vals = [n.meta["val"] for n in ep.graph.nodes
                if n.op == "placeholder"
                and n.name in set(ep.graph_signature.user_inputs)]
        vals = vals[n_state:]
        saved = payload.get("feed_names")
        self._input_names = list(saved) if saved and \
            len(saved) == len(vals) else [f"input_{i}"
                                          for i in range(len(vals))]
        self._specs = {}
        self._inputs = {}
        for n, v in zip(self._input_names, vals):
            shape = tuple(d if isinstance(d, int) else -1 for d in v.shape)
            self._specs[n] = (shape, v.dtype)
            self._inputs[n] = _Handle(n, shape, str(v.dtype).split(".")[-1])
        self._output_names = []
        self._outputs = {}
        warm = [torch.zeros(tuple(max(d, 1) for d in shape), dtype=dt,
                            device=self._device)
                for shape, dt in self._specs.values()]
        self._call_program(warm)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.ready_stages["first_run_s"] = time.perf_counter() - t2

    def _call_program(self, args):
        import torch
        with torch.no_grad():
            out = self._program(self._params, self._buffers, tuple(args))
        return list(out) if isinstance(out, (tuple, list)) else [out]

    def _run_program(self, inputs):
        import torch
        args = [torch.as_tensor(np.asarray(self._inputs[n]._value),
                                dtype=self._specs[n][1], device=self._device)
                for n in self._input_names]
        outs = self._call_program(args)
        self._output_names = [f"output_{i}" for i in range(len(outs))]
        self._outputs = {}
        for n, o in zip(self._output_names, outs):
            h = _Handle(n, tuple(o.shape), str(o.dtype).split(".")[-1])
            h._value = o
            self._outputs[n] = h
        if inputs is not None:
            return [h.copy_to_cpu() for h in self._outputs.values()]
        return True

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def run(self, inputs=None):
        """Run the program, or the GPT forward of a generation artifact.
        Either feed the handles and call run(), or pass a list of arrays
        (returns the list of numpy outputs)."""
        import torch
        if inputs is not None:
            for n, arr in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(np.asarray(arr))
        if self._program is not None:
            return self._run_program(inputs)
        ids = torch.as_tensor(
            np.asarray(self._inputs[self._input_names[0]]._value),
            dtype=torch.int64, device=self._device)
        with torch.no_grad():
            out = self._model(ids).float()
        self._output_names = ["output_0"]
        h = _Handle("output_0", tuple(out.shape), "float32")
        h._value = out
        self._outputs = {"output_0": h}
        if inputs is not None:
            return [h.copy_to_cpu()]
        return True

    def get_output_names(self):
        return list(self._output_names)

    def get_output_handle(self, name):
        return self._outputs[name]

    # -- generation entry point (serving/) ----------------------------------
    def _record_engine(self):
        """The recorded engine, rebuilt with the artifact's compile cache
        and, with the warm-up on, `precompile()`d (its stages timed into
        `ready_stages`). Any error building the record raises."""
        from ..serving.engine import default_compile_cache_dir, make_engine
        meta, cfg = self._serving_meta, self._config
        cache_dir = None
        if cfg._compile_cache:
            cache_dir = cfg._compile_cache_dir or \
                default_compile_cache_dir(cfg.artifact_prefix())
        t0 = time.perf_counter()
        engine = make_engine(self._model, meta["engine"], meta["config"],
                             device=self._device, compile_cache_dir=cache_dir)
        self.ready_stages["engine_build_s"] = time.perf_counter() - t0
        if cfg._aot_warmup:
            self.precompile_report = engine.precompile()
            st = engine.last_precompile_stats
            self.ready_stages["libraries_s"] = st["libraries_s"]
            self.ready_stages["captures_s"] = st["captures_s"]
        return engine

    def _generation_scheduler(self, **engine_kwargs):
        """Build (or return) the engine and scheduler of `generate()`.

        With a serving record and no engine kwargs, the recorded engine
        (dense, paged or spec, its exact config) is rebuilt with the
        artifact's compile cache and, with the warm-up on,
        `precompile()`d. Explicit engine kwargs win: a scheduler built
        from the record is replaced by a dense `GenerationEngine(model,
        **engine_kwargs)` on the first call that passes any; once a
        kwargs-built scheduler exists, later calls reuse it."""
        if self._gen_sched is not None:
            if not engine_kwargs or not self._gen_sched_from_record:
                return self._gen_sched
            self._gen_sched = None     # record-built, the caller overrides
        from ..serving import GenerationEngine, Scheduler
        sched_keys = ("max_queue", "default_max_new_tokens",
                      "default_timeout_s", "metrics_path")
        sched_kwargs = {k: engine_kwargs.pop(k) for k in sched_keys
                        if k in engine_kwargs}
        engine = None
        if self._serving_meta and not engine_kwargs:
            engine = self._record_engine()
        from_record = engine is not None
        if engine is None:
            engine = GenerationEngine(self._model, device=self._device,
                                      **engine_kwargs)
        self._gen_sched = Scheduler(engine, device=self._device,
                                    **sched_kwargs)
        self._gen_sched_from_record = from_record
        return self._gen_sched

    def generate(self, input_ids, max_new_tokens=32, **engine_kwargs):
        """Continuations of a batch of prompts (a list of token-id lists,
        or a [B, S] int array) through the continuous-batching scheduler;
        returns a list of generated-id lists. Engine and scheduler knobs
        (slots, max_len, decode_strategy, temperature, top_k, top_p,
        eos_token_id, max_queue, ...) apply on the first call; later
        calls reuse the built engine. A failed decode raises.
        `last_ttft_s` holds each request's seconds from submit to its
        first token."""
        from ..serving import QueueFullError
        if self._program is not None:
            raise TypeError("a jit.save program has no generation engine: "
                            "generate() serves save_for_generation "
                            "artifacts; call run()")
        prompts = [list(map(int, np.asarray(p).reshape(-1)))
                   for p in input_ids]
        sched = self._generation_scheduler(**engine_kwargs)
        handles = []
        for p in prompts:
            while True:
                try:
                    handles.append(sched.submit(
                        p, max_new_tokens=max_new_tokens))
                    break
                except QueueFullError:
                    sched.step()   # drain a slot's worth, then retry
        sched.run_until_idle()
        # a batch API has no consumer watching handle.status: a decode
        # failure must be loud, not a silently truncated generation
        failed = [h for h in handles if h.status == "ERROR"]
        if failed:
            raise RuntimeError(
                f"decode failed for {len(failed)}/{len(handles)} "
                f"request(s): {failed[0].error}")
        self.last_ttft_s = [h.ttft_s for h in handles]
        return [h.tokens for h in handles]

    @property
    def engine(self):
        """The serving engine `generate()` runs on (None before it is
        built)."""
        return self._gen_sched.engine if self._gen_sched is not None \
            else None

    def clear_intermediate_tensor(self):
        pass

    def try_shrink_memory(self):
        pass


def create_predictor(config):
    return Predictor(config)


def get_version():
    from .. import __version__
    return __version__


class DataType:
    """The reference's paddle_infer.DataType enum."""
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


def get_num_bytes_of_data_type(dtype):
    return {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
            DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
            DataType.BFLOAT16: 2}[dtype]


# paddle_infer.Tensor is the zero-copy handle type
Tensor = _Handle


class PredictorPool:
    """The reference's paddle_infer.PredictorPool: N predictors sharing
    one config."""

    def __init__(self, config, size=1):
        self._predictors = [Predictor(config) for _ in range(max(size, 1))]

    def retrive(self, idx):
        return self._predictors[idx]

    retrieve = retrive


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision=None,
                               backend=None, keep_io_types=True,
                               black_list=None, **kwargs):
    """Raises, as the reference's does: convert the model before saving."""
    raise NotImplementedError(
        "convert the MODEL before saving: build the GPT in bfloat16 "
        "(GPT(cfg, dtype=torch.bfloat16)) and save_for_generation it; the "
        "artifact then serves in bfloat16")


def get_trt_compile_version():
    """The port links no TensorRT: (0, 0, 0)."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name):
    """The reference maps fluid op names to phi kernel names; one
    generation here: identity."""
    return op_name

