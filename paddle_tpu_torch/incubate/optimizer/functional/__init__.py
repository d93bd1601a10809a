"""Functional optimizers: `minimize_lbfgs`, `minimize_bfgs`."""
from .lbfgs import minimize_bfgs, minimize_lbfgs  # noqa: F401
