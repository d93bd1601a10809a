"""Runtime flags: the registry of `FLAGS_*` values, loaded from the
environment like the reference's gflags.

Counterpart of `paddle_tpu/framework/flags.py`, with the same names,
defaults and environment loading (`FLAGS_x=...` in the environment sets
flag x when this module is imported; booleans read "1"/"true"/"yes").
What each flag does in the port:

  FLAGS_compile_cache_dir        attaches the process-global compile cache
                                 (`compile_cache.attach`): the nvcc kernel
                                 libraries of `_kernels/build.py` are
                                 committed there (in its `paddle_tpu_torch/`
                                 subdirectory, apart from the JAX
                                 package's entries) and loaded from there
                                 by later processes
  FLAGS_compile_cache_max_entries
                                 caps the committed entries of every
                                 `CompileCache` built without an explicit
                                 `max_entries` (least recently used go
                                 first; 0 = unlimited)
  FLAGS_compilation_cache_dir    the JAX persistent XLA cache in the
                                 reference; the port has one kind of
                                 compiled artifact, so it attaches the same
                                 global compile cache (its entries in the
                                 same subdirectory, apart from XLA's files)
  FLAGS_cudnn_deterministic      recorded; the port's kernels are
                                 deterministic (the paged and flash kernels
                                 merge their splits in a fixed order)
  FLAGS_flash_attention          recorded; the training step's attention is
                                 chosen by `make_train_step(attention=)`
  FLAGS_check_nan_inf            read by `core.tensor.apply_op`: an eager op
                                 whose float output holds NaN or Inf raises
                                 naming the op (one host sync an op)
  FLAGS_benchmark, FLAGS_profile recorded only: the reference defines
                                 them and no module of it reads them
  FLAGS_int64_numpy_boundary     recorded; torch keeps int64 as int64, so
                                 there is no boundary to widen at
  FLAGS_allocator_strategy,      XLA allocator and executor knobs in the
  FLAGS_fraction_of_gpu_memory_to_use,
  FLAGS_eager_delete_tensor_gb,  reference: recorded, mapped to nothing (the
  FLAGS_use_standalone_executor, PyTorch caching allocator and stream order
  FLAGS_sync_nccl_allreduce,     own these)
  FLAGS_max_inplace_grad_add,
  FLAGS_embedding_deterministic,
  FLAGS_cudnn_exhaustive_search,
  FLAGS_conv_workspace_size_limit
"""
import os

__all__ = ["get_flags", "set_flags", "enable_compilation_cache"]

_FLAGS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_benchmark": False,
    "FLAGS_allocator_strategy": "xla_bfc",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_cudnn_deterministic": True,
    "FLAGS_use_standalone_executor": True,
    "FLAGS_sync_nccl_allreduce": False,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_embedding_deterministic": 1,
    "FLAGS_cudnn_exhaustive_search": False,
    "FLAGS_conv_workspace_size_limit": 512,
    "FLAGS_flash_attention": True,
    "FLAGS_profile": False,
    "FLAGS_compilation_cache_dir": "",
    "FLAGS_compile_cache_dir": "",
    "FLAGS_compile_cache_max_entries": 0,
    "FLAGS_int64_numpy_boundary": False,
}


def enable_compilation_cache(path=None):
    """Attach the process-global compile cache at `path` (default
    `FLAGS_compilation_cache_dir`); False when neither names a directory.
    The reference turns on JAX's persistent XLA cache here; the port's
    only compiled artifacts are the kernel libraries, so this is
    `compile_cache.attach`."""
    path = path or _FLAGS.get("FLAGS_compilation_cache_dir")
    if not path:
        return False
    _FLAGS["FLAGS_compilation_cache_dir"] = path
    from . import compile_cache
    compile_cache.attach(path)
    return True


def _load_env():
    for k in list(_FLAGS):
        if k in os.environ:
            v = os.environ[k]
            cur = _FLAGS[k]
            if isinstance(cur, bool):
                _FLAGS[k] = v.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                _FLAGS[k] = int(v)
            elif isinstance(cur, float):
                _FLAGS[k] = float(v)
            else:
                _FLAGS[k] = v


_load_env()

if _FLAGS["FLAGS_compilation_cache_dir"]:
    enable_compilation_cache()

if _FLAGS["FLAGS_compile_cache_dir"]:
    from . import compile_cache as _compile_cache
    _compile_cache.attach(_FLAGS["FLAGS_compile_cache_dir"])


def get_flags(flags=None):
    """{name: value} of every flag, of one name, or of a list of names."""
    if flags is None:
        return dict(_FLAGS)
    if isinstance(flags, str):
        return {flags: _FLAGS[flags]}
    return {f: _FLAGS[f] for f in flags}


def set_flags(flags):
    """Set flags from a {name: value} dict. Setting a cache directory
    here records it only; `compile_cache.attach` (or
    `enable_compilation_cache`) attaches it."""
    for k, v in flags.items():
        _FLAGS[k] = v
