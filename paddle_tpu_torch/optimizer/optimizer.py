"""Optimizers (counterpart of `paddle_tpu/optimizer/optimizer.py`): SGD,
Momentum, Adam, AdamW, Adamax, RMSProp, Adagrad, Lamb, LarsMomentum,
Adadelta, NAdam and RAdam over one base class.

Each optimizer defines one update rule, `_update(param, grad, state,
lr_t) -> (new_param, new_state)`, in plain torch ops on raw tensors: the
arithmetic in float32, cast back to the parameter's dtype, the bias
corrections as float32 powers of a float32 step count (the state's
`step` is an int32 tensor on the parameter's device, so a step makes no
host sync). The eager `step()` applies it to each parameter; the
functional `apply_gradients_functional` applies the same rule to dicts of
raw tensors. There is no per-parameter compiled program (the reference's
`_jitted_updates` exist because XLA compiles each update).

`step()` writes each new value through `Tensor._rebind(...,
tracked=False)` under no_grad: a parameter keeps its identity, stays a
trainable leaf, and keeps its `.grad` until `clear_grad()`.

Kept from the reference as they are:
  * decay: the eager path reads `p.regularizer` before the optimizer's
    `weight_decay` (`_apply_decay`), the functional path reads only the
    optimizer's; AdamW's `apply_decay_param_fun` applies to both; a
    parameter's `optimize_attr["learning_rate"]` is carried and, as in
    the reference's optimizers, not read;
  * an `Optimization` span around `step()` while the port's profiler
    records;
  * the numerics taps `train.grad_norm` / `train.param_norm`: eager
    through `observe_tree` when a monitor is set (one host copy of the
    gradients and parameters), functional through `tap_tree` inside an
    open sink scope;
  * `FLAGS_check_nan_inf`'s post-step scan, which names the parameter.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, _wrap
from ..framework.flags import _FLAGS
from ..observability import numerics as _numerics
from ..profiler import _tracer as _TRACER
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "RMSProp", "Adagrad", "Lamb", "LarsMomentum", "Adadelta", "NAdam",
           "RAdam"]

_F32 = torch.float32


def _zeros32(p):
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _step0(p):
    return torch.zeros((), dtype=torch.int32, device=p.device)


def _host(t):
    return t.detach().float().cpu().numpy()


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr = learning_rate
        self._parameters = list(parameters) if parameters is not None else []
        self._grad_clip = grad_clip
        if isinstance(weight_decay, (float, int)):
            from ..regularizer import L2Decay
            self._weight_decay = L2Decay(float(weight_decay))
        else:
            self._weight_decay = weight_decay
        self._accumulators = {}   # id(param) -> {state name: tensor}
        self._step_count = 0
        # the name of the parameter being updated (read by the decay
        # exclusion rules of AdamW, Lamb and LarsMomentum)
        self._current_param_name = None

    # ------------------------------------------------------------------ lr
    def get_lr(self):
        if isinstance(self._lr, LRScheduler):
            return float(self._lr.get_lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    def _lr_tensors(self, lr=None):
        """device -> the learning rate as a 0-d float32 tensor there."""
        value = self.get_lr() if lr is None else lr
        cache = {}

        def on(device):
            t = cache.get(device)
            if t is None:
                t = cache[device] = torch.full((), value, dtype=_F32,
                                               device=device)
            return t
        return on

    # --------------------------------------------------------------- state
    def _state_for(self, p):
        sid = id(p)
        if sid not in self._accumulators:
            self._accumulators[sid] = self._init_state(p._data)
        return self._accumulators[sid]

    def _init_state(self, param_data):
        return {}

    def _update(self, param, grad, state, lr_t):
        raise NotImplementedError

    # ---------------------------------------------------------------- step
    @property
    def _param_groups(self):
        return self._parameters

    def step(self):
        """Eager update of every parameter with a gradient, stamped as an
        Optimization span while the profiler records."""
        if not _TRACER.enabled:
            return self._step_impl()
        rec = _TRACER.begin(f"Optimizer.step.{type(self).__name__}",
                            "Optimization",
                            {"n_params": len(self._parameters)})
        try:
            return self._step_impl()
        finally:
            _TRACER.end(rec)

    def _step_impl(self):
        params_grads = [(p, _wrap(p._data.grad)) for p in self._parameters
                        if not p.stop_gradient and p._data.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr_on = self._lr_tensors()
        self._step_count += 1
        with torch.no_grad():
            for i, (p, g) in enumerate(params_grads):
                if g is None:
                    continue
                gd = g._data if isinstance(g, Tensor) else g
                state = self._state_for(p)
                self._current_param_name = p.name or f"param_{i}"
                pd = p._data
                new_p, new_state = self._update(
                    pd, self._apply_decay(p, gd, pd), state, lr_on(pd.device))
                p._rebind(lambda d, v=new_p: v, tracked=False)
                self._accumulators[id(p)] = new_state
        if _numerics.get_monitor() is not None:
            # host-side sentinel of the eager path: one stats vector across
            # all gradients and one across the updated parameters
            gs = [_host(g._data if isinstance(g, Tensor) else g)
                  for _, g in params_grads if g is not None]
            ps = [_host(p._data) for p, _ in params_grads]
            if gs:
                _numerics.observe_tree("train.grad_norm", gs)
            if ps:
                _numerics.observe_tree("train.param_norm", ps)
        if _FLAGS.get("FLAGS_check_nan_inf", False):
            self._check_finite(params_grads)

    def _check_finite(self, params_grads):
        """Post-step scan: raise naming the first parameter whose gradient
        or new value holds NaN or Inf (one host sync a tensor)."""
        for i, (p, g) in enumerate(params_grads):
            for what, t in (("grad", g), ("param", p)):
                d = t._data if isinstance(t, Tensor) else t
                if d is None or not d.is_floating_point():
                    continue
                if not bool(torch.isfinite(d).all()):
                    raise RuntimeError(
                        f"FLAGS_check_nan_inf: NaN/Inf in {what} of "
                        f"'{p.name or f'param_{i}'}' after optimizer "
                        f"step {self._step_count}")

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameters]

    def clear_grad(self, set_to_zero=True):
        for p in self._parameters:
            p.clear_grad()

    clear_gradients = clear_grad

    def _apply_decay(self, p, gd, pd):
        """The L2 term folded into the gradient (not decoupled; AdamW
        decays in its update): the parameter's regularizer, else the
        optimizer's weight_decay."""
        reg = p.regularizer if getattr(p, "regularizer", None) is not None \
            else self._weight_decay
        if reg is None or self._decoupled_decay():
            return gd
        return gd + reg.coeff * pd if hasattr(reg, "coeff") else gd

    def _decoupled_decay(self):
        return False

    # ------------------------------------------------------ functional path
    def functional_state(self, params_dict):
        """{name: state} for a {name: raw tensor} params dict."""
        return {n: self._init_state(v) for n, v in params_dict.items()}

    def apply_gradients_functional(self, params, grads, opt_state, lr=None,
                                   step_count=None):
        """Pure update over {name: raw tensor} dicts: returns (new_params,
        new_opt_state). Clip (`clip_tree`) and the optimizer's own
        weight_decay are applied; a parameter's regularizer is not."""
        lr_on = self._lr_tensors(lr)
        if self._grad_clip is not None:
            grads = self._grad_clip.clip_tree(grads)
        new_params, new_state = {}, {}
        for n, p in params.items():
            g = grads[n]
            if g is None:
                new_params[n] = p
                new_state[n] = opt_state[n]
                continue
            if self._weight_decay is not None \
                    and not self._decoupled_decay() \
                    and hasattr(self._weight_decay, "coeff"):
                g = g + self._weight_decay.coeff * p
            st = dict(opt_state[n])
            if step_count is not None and "step" in st:
                st["step"] = torch.as_tensor(step_count).to(
                    device=p.device, dtype=torch.int32)
            self._current_param_name = n
            new_params[n], new_state[n] = self._update(p, g, st,
                                                       lr_on(p.device))
        # in-graph sentinels: no-ops unless the caller opened a numerics
        # sink_scope
        _numerics.tap_tree("train.grad_norm", grads)
        _numerics.tap_tree("train.param_norm", new_params)
        return new_params, new_state

    def state_dict(self):
        out = {"step_count": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        for i, p in enumerate(self._parameters):
            st = self._accumulators.get(id(p))
            if st:
                out[p.name or f"param_{i}"] = {k: _wrap(v)
                                               for k, v in st.items()}
        return out

    def set_state_dict(self, state_dict):
        self._step_count = state_dict.get("step_count", 0)
        if isinstance(self._lr, LRScheduler) and "LR_Scheduler" in state_dict:
            self._lr.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameters):
            key = p.name or f"param_{i}"
            if key in state_dict:
                dev = p._data.device
                self._accumulators[id(p)] = {
                    k: (v._data.to(dev) if isinstance(v, Tensor)
                        else torch.as_tensor(np.asarray(v)).to(dev))
                    for k, v in state_dict[key].items()}


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, param, grad, state, lr_t):
        return param - lr_t.to(param.dtype) * grad.to(param.dtype), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, param_data):
        return {"velocity": torch.zeros_like(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(param.dtype)
        v = state["velocity"] * self._momentum + g
        update = g + self._momentum * v if self._nesterov else v
        return param - lr_t.to(param.dtype) * update, {"velocity": v}


def _adam_moments(b1, b2, state, g, k1="moment1", k2="moment2"):
    t = state["step"] + 1
    m = b1 * state[k1] + (1 - b1) * g
    v = b2 * state[k2] + (1 - b2) * (g * g)
    tf = t.to(_F32)
    return t, m, v, m / (1 - b1 ** tf), v / (1 - b2 ** tf)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _init_state(self, param_data):
        return {"moment1": _zeros32(param_data),
                "moment2": _zeros32(param_data), "step": _step0(param_data)}

    def _update(self, param, grad, state, lr_t):
        t, m, v, mhat, vhat = _adam_moments(self._beta1, self._beta2, state,
                                            grad.to(_F32))
        upd = lr_t * mhat / (torch.sqrt(vhat) + self._eps)
        new_p = (param.to(_F32) - upd).to(param.dtype)
        return new_p, {"moment1": m, "moment2": v, "step": t}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._coeff = float(weight_decay) \
            if isinstance(weight_decay, (int, float)) \
            else getattr(weight_decay, "coeff", 0.01)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_decay(self):
        return True

    def _update(self, param, grad, state, lr_t):
        # decoupled weight decay (Loshchilov & Hutter), as the reference's
        # adamw kernel
        decay = self._coeff
        name = self._current_param_name
        if self._apply_decay_param_fun is not None and name is not None \
                and not self._apply_decay_param_fun(name):
            decay = 0.0
        p32 = param.to(_F32) * (1 - lr_t * decay)
        t, m, v, mhat, vhat = _adam_moments(self._beta1, self._beta2, state,
                                            grad.to(_F32))
        new_p = (p32 - lr_t * mhat / (torch.sqrt(vhat) + self._eps)) \
            .to(param.dtype)
        return new_p, {"moment1": m, "moment2": v, "step": t}


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, param_data):
        return {"moment": _zeros32(param_data),
                "inf_norm": _zeros32(param_data), "step": _step0(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        t = state["step"] + 1
        m = self._beta1 * state["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * state["inf_norm"], g.abs())
        lr_eff = lr_t / (1 - self._beta1 ** t.to(_F32))
        new_p = (param.to(_F32) - lr_eff * m / (u + self._eps)) \
            .to(param.dtype)
        return new_p, {"moment": m, "inf_norm": u, "step": t}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, param_data):
        st = {"mean_square": _zeros32(param_data),
              "momentum": _zeros32(param_data)}
        if self._centered:
            st["mean_grad"] = _zeros32(param_data)
        return st

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        ms = self._rho * state["mean_square"] + (1 - self._rho) * g * g
        st = {"mean_square": ms}
        if self._centered:
            mg = self._rho * state["mean_grad"] + (1 - self._rho) * g
            denom = torch.sqrt(ms - mg * mg + self._eps)
        else:
            mg = None
            denom = torch.sqrt(ms + self._eps)
        mom = self._momentum * state["momentum"] + lr_t * g / denom
        st["momentum"] = mom
        if mg is not None:
            st["mean_grad"] = mg
        return (param.to(_F32) - mom).to(param.dtype), st


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, param_data):
        return {"moment": torch.full(param_data.shape, self._init_val,
                                     dtype=_F32, device=param_data.device)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        mom = state["moment"] + g * g
        new_p = (param.to(_F32) - lr_t * g / (torch.sqrt(mom) + self._eps)) \
            .to(param.dtype)
        return new_p, {"moment": mom}


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, param_data):
        return {"moment1": _zeros32(param_data),
                "moment2": _zeros32(param_data), "step": _step0(param_data)}

    def _update(self, param, grad, state, lr_t):
        t, m, v, mhat, vhat = _adam_moments(self._beta1, self._beta2, state,
                                            grad.to(_F32))
        p32 = param.to(_F32)
        decay = self._lamb_decay
        if self._exclude_fn is not None \
                and self._current_param_name is not None \
                and self._exclude_fn(self._current_param_name):
            decay = 0.0
        r = mhat / (torch.sqrt(vhat) + self._eps) + decay * p32
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        r_norm = torch.sqrt(torch.sum(r * r))
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        new_p = (p32 - lr_t * trust * r).to(param.dtype)
        return new_p, {"moment1": m, "moment2": v, "step": t}


class LarsMomentum(Optimizer):
    """LARS: layer-wise trust-ratio-scaled momentum SGD for large-batch
    training."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._decay = lars_weight_decay
        self._eps = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_state(self, param_data):
        return {"velocity": _zeros32(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        p32 = param.to(_F32)
        decay = self._decay
        name = self._current_param_name or ""
        if any(tag in name for tag in self._exclude):
            decay = 0.0
        w_norm = torch.sqrt(torch.sum(p32 * p32))
        g_norm = torch.sqrt(torch.sum(g * g))
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._coeff * w_norm / (g_norm + decay * w_norm + self._eps),
            1.0)
        v = self._momentum * state["velocity"] + \
            lr_t * local_lr * (g + decay * p32)
        return (p32 - v).to(param.dtype), {"velocity": v}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_state(self, param_data):
        return {"avg_squared_grad": _zeros32(param_data),
                "avg_squared_update": _zeros32(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        asg = self._rho * state["avg_squared_grad"] + (1 - self._rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + self._eps) / \
            torch.sqrt(asg + self._eps)
        asu = self._rho * state["avg_squared_update"] + \
            (1 - self._rho) * upd * upd
        new_p = (param.to(_F32) - lr_t * upd).to(param.dtype)
        return new_p, {"avg_squared_grad": asg, "avg_squared_update": asu}


class NAdam(Optimizer):
    """Nesterov-momentum Adam (Dozat 2016): the lookahead momentum term
    replaces the plain m-hat."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._psi = momentum_decay

    def _init_state(self, param_data):
        return {"m": _zeros32(param_data), "v": _zeros32(param_data),
                "mu_prod": torch.ones((), dtype=_F32,
                                      device=param_data.device),
                "step": _step0(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        t = (state["step"] + 1).to(_F32)
        b1, b2 = self._beta1, self._beta2
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * self._psi))
        mu_next = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * self._psi))
        mu_prod = state["mu_prod"] * mu_t
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g * g
        m_hat = (mu_next * m / (1 - mu_prod * mu_next)
                 + (1 - mu_t) * g / (1 - mu_prod))
        v_hat = v / (1 - b2 ** t)
        new_p = (param.to(_F32)
                 - lr_t * m_hat / (torch.sqrt(v_hat) + self._eps)) \
            .to(param.dtype)
        return new_p, {"m": m, "v": v, "mu_prod": mu_prod,
                       "step": state["step"] + 1}


class RAdam(Optimizer):
    """Rectified Adam (Liu et al. 2020): variance rectification switches
    between Adam and SGD with momentum while the second moment is
    unreliable."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, param_data):
        return {"m": _zeros32(param_data), "v": _zeros32(param_data),
                "step": _step0(param_data)}

    def _update(self, param, grad, state, lr_t):
        g = grad.to(_F32)
        t = (state["step"] + 1).to(_F32)
        b1, b2 = self._beta1, self._beta2
        m = b1 * state["m"] + (1 - b1) * g
        v = b2 * state["v"] + (1 - b2) * g * g
        m_hat = m / (1 - b1 ** t)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        r = torch.sqrt(torch.clamp(
            (rho_t - 4) * (rho_t - 2) * rho_inf
            / torch.clamp((rho_inf - 4) * (rho_inf - 2) * rho_t, min=1e-12),
            min=0.0))
        v_hat = torch.sqrt(v / (1 - b2 ** t)) + self._eps
        step_val = torch.where(rho_t > 5.0, r * m_hat / v_hat, m_hat)
        new_p = (param.to(_F32) - lr_t * step_val).to(param.dtype)
        return new_p, {"m": m, "v": v, "step": state["step"] + 1}
