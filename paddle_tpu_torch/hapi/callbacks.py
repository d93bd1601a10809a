"""hapi callbacks for the port (counterpart of `paddle_tpu/hapi/callbacks.py`):
the same classes, events and event order."""
import time

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        getattr(self, f"on_{mode}_begin", lambda l=None: None)(logs)

    def on_end(self, mode, logs=None):
        getattr(self, f"on_{mode}_end", lambda l=None: None)(logs)

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda s, l=None: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda s, l=None: None)(step, logs)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None, model=None, **params):
        self.callbacks = list(callbacks or [])
        if params.get("verbose", 2) and not any(
                isinstance(c, ProgBarLogger) for c in self.callbacks):
            self.callbacks.insert(0, ProgBarLogger(
                log_freq=params.get("log_freq", 10),
                verbose=params.get("verbose", 2)))
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            dt = time.time() - self._t0
            ips = (step + 1) / max(dt, 1e-9)
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                               if isinstance(v, (int, float)) and k != "step")
            total = self.steps if self.steps is not None else "?"
            print(f"Epoch {self.epoch}: step {step}/{total} - {items} "
                  f"- {ips:.2f} step/s", flush=True)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.model and self.save_dir:
            self.model.save(f"{self.save_dir}/final")


def _resolve_mode(mode, monitor, cls_name):
    """'auto'/'min'/'max' -> 'min'|'max' (EarlyStopping and
    ReduceLROnPlateau)."""
    if mode not in ("auto", "min", "max"):
        import warnings
        warnings.warn(f"{cls_name}: unknown mode {mode!r}, falling back "
                      f"to 'auto'")
        mode = "auto"
    if mode == "auto":
        mode = "max" if "acc" in monitor else "min"
    return mode


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.best = None
        self.mode = _resolve_mode(mode, monitor, "EarlyStopping")

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        if isinstance(val, (list, tuple)):
            val = val[0]
        improved = (self.best is None or
                    (self.mode == "min" and val < self.best - self.min_delta) or
                    (self.mode == "max" and val > self.best + self.min_delta))
        if improved:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and self.model and self.model._optimizer is not None:
            sched = self.model._optimizer._lr
            if hasattr(sched, "step"):
                sched.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch and self.model and self.model._optimizer is not None:
            sched = self.model._optimizer._lr
            if hasattr(sched, "step"):
                sched.step()


class VisualDL(Callback):
    """Scalars of every train batch as newline-delimited JSON
    (`<log_dir>/scalars.jsonl`), in place of VisualDL's format."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None

    def on_train_begin(self, logs=None):
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        self._fh = open(f"{self.log_dir}/scalars.jsonl", "a")

    def on_train_batch_end(self, step, logs=None):
        import json
        if self._fh and logs:
            rec = {k: v for k, v in logs.items() if isinstance(v, (int, float))}
            rec["step"] = step
            self._fh.write(json.dumps(rec) + "\n")

    def on_train_end(self, logs=None):
        if self._fh:
            self._fh.close()


class ReduceLROnPlateau(Callback):
    """Shrink the optimizer LR when the monitored metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = _resolve_mode(mode, monitor, "ReduceLROnPlateau")
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.cooldown_counter = 0
        self.best = None

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        if isinstance(val, (list, tuple)):
            val = val[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        improved = (self.best is None or
                    (self.mode == "min" and val < self.best - self.min_delta)
                    or (self.mode == "max"
                        and val > self.best + self.min_delta))
        if improved:
            self.best = val
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                from ..optimizer.lr import LRScheduler as _Sched
                opt = self.model._optimizer
                if isinstance(opt._lr, _Sched):
                    # an LRScheduler owns the LR: warn and skip
                    import warnings
                    warnings.warn("ReduceLROnPlateau: optimizer uses an "
                                  "LRScheduler; skipping LR reduction")
                else:
                    old = opt.get_lr()
                    new = max(old * self.factor, self.min_lr)
                    if new < old:
                        opt.set_lr(new)
                        if self.verbose:
                            print(f"ReduceLROnPlateau: lr {old:.2e} -> "
                                  f"{new:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
