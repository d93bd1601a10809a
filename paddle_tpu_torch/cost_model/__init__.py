"""Cost model: measured and analytical per-op costs.

Counterpart of `paddle_tpu/cost_model/__init__.py` (`CostModel`, after the
reference framework's profile-based per-op table and static benchmark
lookups). `profile_measure` times a whole callable on the live device;
`static_costs` / `get_static_op_time` attribute per-op FLOPs, bytes and
roofline time analytically (`analytical.estimate`, aten ops over fake
tensors), which prices H100-sized shapes without executing them.
"""
import time

from .analytical import (DEVICES, CostReport, DeviceSpec,  # noqa: F401
                         OpCost, estimate, fake_mode)

__all__ = ["CostModel", "estimate", "fake_mode", "CostReport", "DeviceSpec",
           "OpCost", "DEVICES"]


class CostModel:
    """Measure a callable's cost profile on the device (`profile_measure`,
    whole-callable) and/or price it analytically per op (`static_costs`)."""

    def __init__(self):
        self._table = {}
        self._static = {}    # op name -> {"time", "flops", "bytes"}

    def profile_measure(self, fn_or_program, *args, device="cuda",
                        fetch_cost_list=("time",), repeat=5):
        """Mean host ms of `fn(*args)` over `repeat` calls after one
        warm-up call; on CUDA the card is synchronized before the clock
        starts and before it stops, so the time covers the device work.
        `device` (default "cuda") names where `fn` runs: without CUDA it
        raises unless "cpu" is passed."""
        import torch
        from ..core.device import resolve_device
        dev = resolve_device(device)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        fn = fn_or_program
        fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(repeat):
            fn(*args)
        sync()
        dt = (time.perf_counter() - t0) / repeat
        cost = {"time": dt * 1000.0}
        self._table[getattr(fn, "__name__", "program")] = cost
        return cost

    def static_costs(self, fn, *args, device="h100-sxm", **kwargs):
        """Analytically price `fn(*args)` per op (no execution); fills the
        static table consulted by `get_static_op_time` and returns the
        CostReport."""
        report = estimate(fn, *args, device=device, **kwargs)
        for name, c in report.by_op.items():
            t = 1e3 * report.device.roofline_s(c.flops, c.bytes)
            self._static[name] = {
                "time": t,                       # aggregate over all calls
                "time_per_call": t / max(c.count, 1),
                "flops": c.flops, "bytes": c.bytes, "count": c.count}
        return report

    def get_static_op_time(self, op_name, forward=True, dtype="float32"):
        """`forward`/`dtype` are accepted for reference-signature parity
        but not keyed on: the analytic table prices the ops of whatever
        function was walked (a walked train step already contains its
        backward ops at their dtypes). "time" is the aggregate over every
        call of the op in the walked function; planners comparing op
        kinds should use "time_per_call"."""
        if op_name in self._static:
            return dict(self._static[op_name])
        rec = dict(self._table.get(op_name, {"time": 0.0}))
        rec.setdefault("time_per_call", rec["time"])
        return rec
