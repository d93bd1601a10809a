"""paddle.static.sparsity (reference: static/sparsity, the static facade
of incubate/asp): the 2:4 structured-sparsity workflow.

Counterpart of `paddle_tpu/static/sparsity.py`: re-exports the port's
`incubate.asp`.
"""
from ..incubate.asp import (  # noqa: F401
    add_supported_layer, calculate_density, decorate, prune_model,
    reset_excluded_layers, set_excluded_layers)

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "add_supported_layer"]
