"""The GPT training step (`gpt_spmd`) on one device, and the carrying of
the JAX package's parameters and optimizer state into it (`convert`)."""
from .gpt_spmd import (  # noqa: F401
    GPTSpmdConfig, MeshPlan, init_gpt_params, init_opt_state_leaf,
    make_forward_fn, make_train_step,
)
from .convert import opt_state_from_jax, params_from_jax  # noqa: F401

__all__ = ["GPTSpmdConfig", "MeshPlan", "init_gpt_params",
           "init_opt_state_leaf", "make_forward_fn", "make_train_step",
           "opt_state_from_jax", "params_from_jax"]
