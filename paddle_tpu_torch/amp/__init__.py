"""paddle.amp for the port (counterpart of `paddle_tpu/amp/__init__.py`).

`auto_cast` writes the AMP state and casts nothing (ROADMAP C.15): in the
reference no module reads `_amp_state`, so an O1 region computes what the
same code computes outside it. The port keeps that: no `torch.autocast`.
`decorate(level="O2")` casts the float parameters to the AMP dtype,
rebinding each (it stays the same trainable leaf); the optimizers compute
in float32 and cast back. `GradScaler` keeps the dynamic loss-scale
algorithm, skips a step whose gradients hold NaN or Inf, and clamps a
decayed scale at 1, as the reference's kernel does.
"""
import contextlib

import torch

from ..core import dtype as _dt

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_decorate",
           "GradScaler", "amp_state", "WHITE_LIST", "BLACK_LIST"]

# the reference's op lists (recorded, as there; nothing casts by them)
WHITE_LIST = {"matmul", "conv2d", "conv1d", "conv3d", "einsum", "linear",
              "bmm", "mm"}
BLACK_LIST = {"exp", "log", "mean", "sum", "softmax", "cross_entropy",
              "layer_norm", "batch_norm", "reduce"}

_amp_state = {"enable": False, "dtype": _dt.bfloat16, "level": "O1"}


def amp_state():
    return dict(_amp_state)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = dict(_amp_state)
    _amp_state.update(enable=enable, dtype=_dt.convert_dtype(dtype),
                      level=level)
    try:
        yield
    finally:
        _amp_state.update(prev)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every float parameter of the models to `dtype`."""
    d = _dt.convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            for p in m.parameters():
                if _dt.is_floating(p.dtype):
                    p._rebind(lambda x: x.to(d), tracked=False)
    if optimizers is None:
        return models
    return models, optimizers


amp_decorate = decorate


class GradScaler:
    """Dynamic loss scaling: scale the loss, unscale the gradients before
    the step, skip the step when one holds NaN or Inf, and grow or shrink
    the scale."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient by the scale (in float32, back to its
        dtype) and note whether any holds NaN or Inf (one host read)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        bad = []
        for p in optimizer._parameters:
            g = p._data.grad
            if g is not None:
                u = g.to(torch.float32) * inv
                bad.append(~torch.isfinite(u).all())
                p._data.grad = u.to(g.dtype)
        self._found_inf = bool(torch.stack(bad).any()) if bad else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                # the decayed scale is clamped at 1, as the reference's
                # update_loss_scaling kernel clamps it
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
