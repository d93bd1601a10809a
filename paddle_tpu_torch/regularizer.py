"""Regularizers (counterpart of `paddle_tpu/regularizer.py`).

The optimizers read `coeff`: an `L2Decay` on a parameter (or passed as an
optimizer's `weight_decay`) adds `coeff * param` to its gradient before
the update; `L1Decay` is carried and read the same way, as in the
reference."""

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = coeff
