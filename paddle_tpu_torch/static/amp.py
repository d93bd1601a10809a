"""paddle.static.amp (reference: python/paddle/static/amp =
fluid/contrib/mixed_precision: decorate, CustomOpLists, amp_guard).

Counterpart of `paddle_tpu/static/amp.py`: the static-graph AMP rewrite
collapses to the same bf16 autocast the dygraph amp module performs —
decoration wraps the optimizer with loss scaling. (The graph-level cast
insertion is the `amp` pass of `static/ir_pass.py`.)
"""
from ..amp import GradScaler, auto_cast  # noqa: F401

__all__ = ["decorate", "CustomOpLists", "fp16_guard", "bf16", "amp_guard"]


class CustomOpLists:
    """reference: fp16_lists.py AutoMixedPrecisionLists — custom white/
    black op lists carried into auto_cast."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(custom_white_list or [])
        self.black_list = set(custom_black_list or [])


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8, use_dynamic_loss_scaling=True,
             use_pure_fp16=False, use_fp16_guard=None, use_bf16=True):
    """reference: mixed_precision/decorator.py decorate — returns an
    optimizer whose minimize() scales the loss and unscales grads."""
    # static loss scaling = dynamic machinery with frozen ratios: the
    # scale stays at init_loss_scaling but the loss IS still scaled
    # (enable=False would silently force scale=1.0)
    scaler = GradScaler(
        init_loss_scaling=init_loss_scaling,
        incr_ratio=incr_ratio if use_dynamic_loss_scaling else 1.0,
        decr_ratio=decr_ratio if use_dynamic_loss_scaling else 1.0,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        enable=True)

    class _Decorated:
        def __init__(self, inner):
            self._inner = inner
            self._scaler = scaler

        def __getattr__(self, item):
            return getattr(self._inner, item)

        def minimize(self, loss, **kw):
            scaled = self._scaler.scale(loss)
            scaled.backward()
            self._scaler.step(self._inner)
            self._scaler.update()
            return None, []

        def amp_init(self, place=None, scope=None, test_program=None,
                     use_fp16_test=False):
            return None

    return _Decorated(optimizer)


def fp16_guard():
    import contextlib
    return contextlib.nullcontext()


def amp_guard(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    return auto_cast(enable=enable, custom_white_list=custom_white_list,
                     custom_black_list=custom_black_list, level=level,
                     dtype=dtype)


bf16 = amp_guard
