"""paddle.static.sparsity (reference: static/sparsity = incubate/asp
static facade): the 2:4 structured-sparsity workflow.

Counterpart of `paddle_tpu/static/sparsity.py`, which re-exports
`paddle_tpu.incubate.asp`. The port's `incubate/` comes with ROADMAP
A.13h; until then every name here raises and says so.
"""

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "add_supported_layer"]


def _needs_asp(name):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"static.sparsity.{name} re-exports incubate.asp, which the "
            f"port has not yet (ROADMAP A.13h)")
    fn.__name__ = name
    return fn


calculate_density = _needs_asp("calculate_density")
decorate = _needs_asp("decorate")
prune_model = _needs_asp("prune_model")
set_excluded_layers = _needs_asp("set_excluded_layers")
reset_excluded_layers = _needs_asp("reset_excluded_layers")
add_supported_layer = _needs_asp("add_supported_layer")
