"""paddle.distributed.passes (reference: distributed/passes/__init__.py
new_pass/PassManager/PassContext over program-rewrite passes, with the
user-extensible registry of paddle/fluid/framework/ir/pass.h:236).

Counterpart of `paddle_tpu/distributed/passes.py`. A pass is a graph
rewrite rule (static/ir_pass.py) applied to a `static.Program.capture`d
program by re-tracing. Two classes of names:

- REAL passes (amp cast-insertion, fake-quant insertion, recompute
  tagging, and anything users register with
  `static.ir_pass.register_pass`) transform the IR.
- ABSORBED names map to what PyTorch or the port already does, or to a
  config knob; applying them records the intent in the PassContext,
  which keeps pass-driven launch scripts running.
"""
from ..static.ir_pass import (get_registered_pass, register_pass,  # noqa: F401
                              registered_pass_names)

__all__ = ["new_pass", "PassManager", "PassContext", "register_pass"]

_ABSORBED = {
    "fuse_all_reduce": "absorbed (the collectives bucket their own "
                       "gradients)",
    "fuse_elewise_add_act": "absorbed (no graph compiler behind it)",
    "fuse_bn_act": "absorbed (no graph compiler behind it)",
    "fuse_optimizer": "absorbed (one update function over all params)",
    "auto_parallel_sharding": "maps to MeshPlan.sharding",
}


class PassContext:
    def __init__(self):
        self.attrs = {}

    def set_attr(self, key, value):
        self.attrs[key] = value

    def get_attr(self, key, default=None):
        return self.attrs.get(key, default)


class _Pass:
    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs or {}
        self.rule = get_registered_pass(name)
        self.note = _ABSORBED.get(name)

    def apply(self, main_programs=None, startup_programs=None, context=None):
        if self.rule is None and self.name not in _ABSORBED:
            raise ValueError(
                f"unknown pass {self.name!r}; registered: "
                f"{registered_pass_names()}, absorbed: {sorted(_ABSORBED)}")
        if context is not None:
            context.set_attr(self.name, self.attrs or True)
        if self.rule is None:
            return main_programs
        progs = (main_programs if isinstance(main_programs, (list, tuple))
                 else [main_programs])
        for p in progs:
            if p is not None and getattr(p, "_gm", None) is not None:
                p.apply_pass(self.rule, self.attrs)
            elif p is not None:
                import warnings
                warnings.warn(
                    f"pass {self.name!r} is a real IR transform but the "
                    "program has no captured graph (build it with "
                    "static.Program.capture); program left UNCHANGED",
                    stacklevel=2)
        return main_programs


def new_pass(name, pass_attrs=None):
    return _Pass(name, pass_attrs)


class PassManager:
    def __init__(self, passes=None):
        self._passes = list(passes or [])
        self.context = PassContext()

    def append(self, p):
        self._passes.append(p)

    def apply(self, main_programs=None, startup_programs=None):
        for p in self._passes:
            main_programs = p.apply(main_programs, startup_programs,
                                    self.context)
        return main_programs

    @property
    def names(self):
        return [p.name for p in self._passes]
