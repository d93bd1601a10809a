"""Distributed pieces of the port (counterpart of `paddle_tpu.distributed`).

  checkpoint.py — state-dict checkpoints in the JAX package's layout,
                  committed through `framework.ckpt_commit`
  ps/rpc.py     — the RPC fabric: framing, extension verbs, retries,
                  circuit breakers, in-band error frames; the serving
                  fleet's verbs ride it
  passes.py     — `new_pass` / `PassManager` / `PassContext` over the
                  program rewrites of `static.ir_pass` (imported on
                  first use: it needs `static`)

The parameter-server tables and the graph verbs wait for ROADMAP A.13.
The collectives are `parallel/collectives.py`; re-slicing a checkpoint
across plans is `checkpoint.load_state_dict(plan=)`.
"""
from . import checkpoint  # noqa: F401
from .checkpoint import (CheckpointCorruptError,  # noqa: F401
                         load_state_dict, save_state_dict)

__all__ = ["checkpoint", "load_state_dict", "save_state_dict",
           "CheckpointCorruptError"]
