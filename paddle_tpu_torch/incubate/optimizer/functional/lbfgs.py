"""L-BFGS and BFGS minimizers of the port (counterpart of
`paddle_tpu/incubate/optimizer/functional/lbfgs.py`): the two-loop
recursion (and the dense inverse-Hessian update) in Python over torch
tensors, a backtracking Armijo line search, and the objective's gradient
by torch.autograd."""
from collections import deque, namedtuple

import numpy as np
import torch

from ....core.tensor import Tensor, _wrap

LbfgsResult = namedtuple("LbfgsResult",
                         ["is_converge", "num_func_calls", "x", "fx", "g"])


def _wrap_objective(objective_func):
    def f(x):
        out = objective_func(_wrap(x))
        return out._data if isinstance(out, Tensor) else out

    def value_and_grad(x):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            fx = f(xx)
            g, = torch.autograd.grad(fx, xx)
        return fx.detach(), g

    return f, value_and_grad


def _vdot(a, b):
    return (a.reshape(-1) * b.reshape(-1)).sum()


def _line_search(f, x, fx, g, p, max_steps=20, c1=1e-4, tau=0.5):
    """Backtracking Armijo: returns (alpha, n_evals)."""
    alpha = 1.0
    gtp = _vdot(g, p)
    n = 0
    with torch.no_grad():
        for _ in range(max_steps):
            n += 1
            if f(x + alpha * p) <= fx + c1 * alpha * gtp:
                break
            alpha *= tau
    return alpha, n


def _start(initial_position):
    x = initial_position._data if isinstance(initial_position, Tensor) \
        else torch.as_tensor(np.asarray(initial_position))
    return x.detach().to(torch.float32)


def _result(converged, calls, x, fx, g):
    dev = x.device
    return LbfgsResult(_wrap(torch.tensor(converged, device=dev)),
                       _wrap(torch.tensor(calls, device=dev)),
                       _wrap(x), _wrap(fx), _wrap(g))


def minimize_lbfgs(objective_func, initial_position, history_size=10,
                   max_iters=50, tolerance_grad=1e-8, tolerance_change=1e-9,
                   initial_inverse_hessian_estimate=None,
                   line_search_fn="strong_wolfe", dtype="float32",
                   name=None):
    """Returns (is_converge, num_func_calls, position, objective,
    gradient), the reference's result tuple."""
    f, vg = _wrap_objective(objective_func)
    x = _start(initial_position)
    fx, g = vg(x)
    calls = 1
    s_hist, y_hist, rho_hist = deque(maxlen=history_size), \
        deque(maxlen=history_size), deque(maxlen=history_size)
    converged = False

    for _ in range(max_iters):
        if g.abs().max() < tolerance_grad:
            converged = True
            break
        q = g
        alphas = []
        for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                             reversed(rho_hist)):
            a = rho * _vdot(s, q)
            alphas.append(a)
            q = q - a * y
        if y_hist:
            gamma = _vdot(s_hist[-1], y_hist[-1]) / \
                torch.clamp(_vdot(y_hist[-1], y_hist[-1]), min=1e-12)
        else:
            gamma = 1.0
        r = gamma * q
        for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                  reversed(alphas)):
            b = rho * _vdot(y, r)
            r = r + (a - b) * s
        p = -r

        alpha, n = _line_search(f, x, fx, g, p)
        calls += n
        x_new = x + alpha * p
        fx_new, g_new = vg(x_new)
        calls += 1
        s = x_new - x
        y = g_new - g
        sy = _vdot(s, y)
        if sy > 1e-10:          # curvature condition
            s_hist.append(s)
            y_hist.append(y)
            rho_hist.append(1.0 / sy)
        if s.abs().max() < tolerance_change:
            x, fx, g = x_new, fx_new, g_new
            converged = True
            break
        x, fx, g = x_new, fx_new, g_new

    return _result(converged, calls, x, fx, g)


def minimize_bfgs(objective_func, initial_position, max_iters=50,
                  tolerance_grad=1e-8, tolerance_change=1e-9,
                  initial_inverse_hessian_estimate=None,
                  line_search_fn="strong_wolfe", dtype="float32", name=None):
    """BFGS with the dense inverse Hessian; the same surface as
    minimize_lbfgs."""
    f, vg = _wrap_objective(objective_func)
    x = _start(initial_position)
    n_dim = x.numel()
    eye = torch.eye(n_dim, dtype=x.dtype, device=x.device)
    est = initial_inverse_hessian_estimate
    H = eye if est is None else (
        est._data if isinstance(est, Tensor)
        else torch.as_tensor(np.asarray(est))).to(x)
    fx, g = vg(x)
    calls = 1
    converged = False
    for _ in range(max_iters):
        if g.abs().max() < tolerance_grad:
            converged = True
            break
        p = -(H @ g.reshape(-1)).reshape(x.shape)
        alpha, n = _line_search(f, x, fx, g, p)
        calls += n
        x_new = x + alpha * p
        fx, g_new = vg(x_new)
        calls += 1
        s = (x_new - x).reshape(-1)
        y = (g_new - g).reshape(-1)
        sy = _vdot(s, y)
        if sy > 1e-10:
            rho = 1.0 / sy
            V = eye - rho * torch.outer(s, y)
            H = V @ H @ V.T + rho * torch.outer(s, s)
        if (x_new - x).abs().max() < tolerance_change:
            x, g = x_new, g_new
            converged = True
            break
        x, g = x_new, g_new
    return _result(converged, calls, x, fx, g)
