"""The GPT training step (`gpt_spmd`) on one device or over a mesh of
ranks driven by one controller (`collectives`, `ring_attention`), and the
carrying of the JAX package's parameters and optimizer state into it
(`convert`)."""
from .gpt_spmd import (  # noqa: F401
    AXES, GPTSpmdConfig, MeshPlan, gather_opt_state, gather_params,
    init_gpt_params, init_opt_state_leaf, interleave_permutation,
    make_forward_fn, make_train_step, param_specs, state_specs,
)
from .convert import opt_state_from_jax, params_from_jax  # noqa: F401

__all__ = ["AXES", "GPTSpmdConfig", "MeshPlan", "gather_opt_state",
           "gather_params", "init_gpt_params", "init_opt_state_leaf",
           "interleave_permutation", "make_forward_fn", "make_train_step",
           "opt_state_from_jax", "param_specs", "params_from_jax",
           "state_specs"]
