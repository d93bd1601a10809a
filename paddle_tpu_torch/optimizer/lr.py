"""LR schedulers (counterpart of `paddle_tpu/optimizer/lr.py`).

They run on the host in Python floats and follow the reference exactly:
the update rules are the API contract, and the attribute names are
`state_dict` keys, so a schedule's state moves between the two packages
unchanged.
"""
import bisect
import math

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "InverseTimeDecay", "PolynomialDecay", "LinearWarmup",
           "ExponentialDecay", "MultiStepDecay", "StepDecay", "LambdaDecay",
           "ReduceOnPlateau", "CosineAnnealingDecay", "OneCycleLR", "CyclicLR"]


def _lerp(a, b, frac):
    """Linear blend from a (frac=0) to b (frac=1)."""
    return a + (b - a) * frac


def _cos_ramp(frac):
    """Cosine half-wave from 0 (frac=0) to 1 (frac=1)."""
    return (1 - math.cos(math.pi * frac)) / 2


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = learning_rate
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_")
                and isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        ramp_up = step * self.warmup_steps ** -1.5
        decay = step ** -0.5
        return self.base_lr * self.d_model ** -0.5 * min(decay, ramp_up)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        # value i applies while last_epoch < boundaries[i]
        return self.values[bisect.bisect_right(self.boundaries,
                                               self.last_epoch)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step, horizon = self.last_epoch, self.decay_steps
        if self.cycle:
            # horizon stretches to the next multiple of decay_steps
            horizon *= math.ceil(step / self.decay_steps) if step > 0 else 1
        else:
            step = min(step, horizon)
        remaining = (1 - step / horizon) ** self.power
        return (self.base_lr - self.end_lr) * remaining + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        wraps = isinstance(learning_rate, LRScheduler)
        self.lr_sched = learning_rate if wraps else None
        self.final_lr = None if wraps else learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if self.lr_sched is None:
            return self.final_lr
        # the wrapped schedule runs on warmup-relative epochs
        self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
        return self.lr_sched.get_lr()


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        passed = sum(1 for m in self.milestones if m <= self.last_epoch)
        return self.base_lr * self.gamma ** passed


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        # the reference does NOT route through the base-class ctor
        # ("Can not call Parent __init__", lr.py:1365-1372): the base
        # ctor's step() probe would demand metrics; set the base fields
        # directly, starting at last_epoch=0 so the first metrics step
        # reports epoch 1 and state_dicts interoperate
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr if hasattr(self, "last_lr") else self.base_lr

    def _is_better(self, current, best):
        """Reference lr.py _is_better: 'rel' scales the threshold by best,
        'abs' uses it directly."""
        margin = best * self.threshold if self.threshold_mode == "rel" \
            else self.threshold
        if self.mode == "min":
            return current < best - margin
        return current > best + margin

    def step(self, metrics, epoch=None):
        """Reference ReduceOnPlateau.step: metrics is a required positional
        (a bare step() that every other scheduler accepts raises TypeError,
        as in the reference); while cooling down, metrics are IGNORED
        entirely (only the counter decrements); the lr change is gated by
        epsilon so sub-epsilon reductions are skipped."""
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            return
        if self.best is None or self._is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
            return
        self.num_bad_epochs += 1
        if self.num_bad_epochs <= self.patience:
            return
        self.cooldown_counter = self.cooldown
        self.num_bad_epochs = 0
        new_lr = max(self.last_lr * self.factor, self.min_lr)
        if self.last_lr - new_lr > self.epsilon:
            self.last_lr = new_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        frac = self.last_epoch / self.T_max
        return _lerp(self.base_lr, self.eta_min, _cos_ramp(frac))


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        up_steps = int(self.total_steps * self.phase_pct)
        if step <= up_steps:
            frac = step / max(up_steps, 1)
            return _lerp(self.initial_lr, self.max_lr, _cos_ramp(frac))
        frac = (step - up_steps) / max(self.total_steps - up_steps, 1)
        return _lerp(self.max_lr, self.end_lr, _cos_ramp(frac))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def _amplitude_scale(self, cycle):
        if self.mode == "triangular2":
            return 1 / (2 ** cycle)
        if self.mode == "exp_range":
            return self.exp_gamma ** self.last_epoch
        return 1.0

    def get_lr(self):
        span = self.step_up + self.step_down
        pos = self.last_epoch % span
        rising = pos < self.step_up
        pct = pos / self.step_up if rising \
            else 1 - (pos - self.step_up) / self.step_down
        scale = self._amplitude_scale(self.last_epoch // span)
        return self.base_lr + (self.max_lr - self.base_lr) * pct * scale
