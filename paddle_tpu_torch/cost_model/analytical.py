"""Analytical per-op cost model: aten-op walk + roofline.

Counterpart of `paddle_tpu/cost_model/analytical.py`. Where the reference
traces the function once (`jax.make_jaxpr`) and prices every equation, the
port runs `fn(*args)` under a `TorchDispatchMode` inside a
`FakeTensorMode`: every aten op it dispatches is seen once, with shapes
and dtypes and no data, so full H100 shapes are priced on a CPU host
without executing anything. Each op's FLOPs and HBM bytes are lowered to
a time with a roofline (time = max(flops / peak, bytes / bandwidth)) for
a device spec.

Keys are aten op names in the profiler's spelling (`aten::mm`,
`aten::add_`), the names `observability/deviceprof.py` attributes kernel
time to, so the device profile joins the model by exact match.

  FLOPs  — the matmul family (`mm`, `addmm`, `bmm`, `baddbmm`, which is
           what `linear` and `matmul` reach the dispatcher as): 2·M·N·K
           (a bias add is not counted, as the reference's `dot_general`
           does not count it); `convolution`: 2 · output elements ·
           kernel window · input channels a group, and its backward once
           per gradient it computes; elementwise ops by the reference's
           per-op table (in-place forms alike); reductions: their input
           elements; everything else 0 (bytes-bound).
  bytes  — the tensor inputs read plus the outputs written, per op.
           Eager PyTorch materializes every op's output, so the
           reference's producer-consumer fusion rule does not apply.
           Views and allocations move nothing and are not counted.

Backward ops are priced when `fn` calls `.backward()` or
`torch.autograd.grad`: the autograd engine dispatches them under the same
modes. The flash kernels' launches are custom ops
(`paddle_tpu_torch::flash_fwd` / `flash_dq` / `flash_dkv`): on fake
tensors they run their fake versions, and they are priced as the
kernels, under `deviceprof`'s names for them (`flash_attention_fwd`,
...): the products of the dense attention they compute (4, 6 and 8 x
BH·S²·D FLOPs: the plain versions' matmuls) and their inputs and
outputs as bytes. Fake tensors live on the CPU, so the paged kernel's
wrapper takes its plain path (the gather path), and no kernel library is
ever called with a fake tensor; the reference prices the XLA attention
fallback on a CPU host. Code that builds its own tensors (masks, positions, caches, a
model) must build them under the same fake mode: `fake_mode()` gives it.
"""
import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten, tree_map

__all__ = ["DeviceSpec", "OpCost", "CostReport", "estimate", "fake_mode",
           "DEVICES"]


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    peak_flops: float          # FLOP/s at the matmul dtype
    hbm_bw: float              # bytes/s

    def roofline_s(self, flops, bytes_):
        return max(flops / self.peak_flops, bytes_ / self.hbm_bw)


# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, float32
# outside them, HBM3; the CPU entry is the reference's
DEVICES = {
    "h100-sxm": DeviceSpec("h100-sxm", 989e12, 3.35e12),
    "h100-sxm-fp32": DeviceSpec("h100-sxm-fp32", 67e12, 3.35e12),
    "cpu": DeviceSpec("cpu", 1e11, 5e10),
}


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    count: int = 0


@dataclass
class CostReport:
    device: DeviceSpec
    by_op: dict = field(default_factory=dict)   # aten name -> OpCost

    @property
    def total_flops(self):
        return sum(c.flops for c in self.by_op.values())

    @property
    def total_bytes(self):
        return sum(c.bytes for c in self.by_op.values())

    @property
    def time_ms(self):
        """Roofline estimate applied per op (each op is either compute- or
        bandwidth-bound), every op's output materialized. A trace taken
        on fake CPU tensors prices the plain attention path, which
        materializes the S^2 scores the flash kernels never write; FLOP
        totals are exact, so prefer them for balancing and use time for
        relative comparisons."""
        return 1e3 * sum(
            self.device.roofline_s(c.flops, c.bytes)
            for c in self.by_op.values())

    def table(self, top=12):
        rows = sorted(self.by_op.items(),
                      key=lambda kv: -self.device.roofline_s(
                          kv[1].flops, kv[1].bytes))[:top]
        out = ["| op | calls | GFLOP | MB | est ms |", "|---|---|---|---|---|"]
        for name, c in rows:
            out.append(
                f"| {name} | {c.count} | {c.flops / 1e9:.2f} | "
                f"{c.bytes / 1e6:.1f} | "
                f"{1e3 * self.device.roofline_s(c.flops, c.bytes):.3f} |")
        return "\n".join(out)


def _numel(t):
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _nbytes(t):
    return _numel(t) * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _mm_flops(a, b):
    """2·M·N·K of a [.., M, K] @ [.., K, N] product (batch dims of a)."""
    return 2.0 * _numel(a) * int(b.shape[-1])


def _conv_flops(out, weight, transposed, inp):
    window = 1
    for s in weight.shape[2:]:
        window *= int(s)
    if transposed:
        return 2.0 * _numel(inp) * window * int(weight.shape[1])
    return 2.0 * _numel(out) * window * int(weight.shape[1])


_ELEMENTWISE_FLOPS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "maximum": 1, "minimum": 1,
    "neg": 1,
    "exp": 8, "log": 8, "tanh": 8, "sigmoid": 8, "erf": 8, "rsqrt": 4,
    "sqrt": 4, "pow": 8, "where": 1, "abs": 1, "sign": 1, "floor": 1,
    "ceil": 1, "round": 1, "cos": 8, "sin": 8,
}

_REDUCE_OPS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "argmax", "argmin", "cumsum", "logsumexp", "var", "var_mean",
               "std", "norm", "linalg_vector_norm", "_softmax",
               "_log_softmax"}

# ops that move no bytes: allocations, and views the schema does not mark
# as such (the rest are found by `is_view`)
_FREE = {"aten::empty", "aten::empty_strided", "aten::empty_like",
         "aten::lift_fresh", "aten::_unsafe_view"}


# the flash custom ops: deviceprof's op name and the BH·S²·D multiple of
# their products (fwd: Q·K^T, P·V; dq: + dO·V^T, dS·K; dkv: Q·K^T,
# dO·V^T, P^T·dO, dS^T·Q)
_FLASH_OPS = {"paddle_tpu_torch::flash_fwd": ("flash_attention_fwd", 4),
              "paddle_tpu_torch::flash_dq": ("flash_attention_dq", 6),
              "paddle_tpu_torch::flash_dkv": ("flash_attention_dkv", 8)}


def _flops(name, args, out):
    if name in _FLASH_OPS:
        q = args[0]                                       # [BH, S, D]
        return float(_FLASH_OPS[name][1] * _numel(q) * q.shape[1])
    base = name.split("::", 1)[1].rstrip("_")
    if base in ("mm", "bmm"):
        return _mm_flops(args[0], args[1])
    if base in ("addmm", "baddbmm"):
        return _mm_flops(args[1], args[2])
    if base == "convolution":
        return _conv_flops(out, args[1], bool(args[6]), args[0])
    if base == "convolution_backward":
        # (grad_out, input, weight, bias_sizes, stride, padding, dilation,
        #  transposed, output_padding, groups, output_mask)
        grads = sum(bool(m) for m in args[10][:2])
        return grads * _conv_flops(args[0], args[2], bool(args[7]), args[1])
    if base in _ELEMENTWISE_FLOPS:
        return _ELEMENTWISE_FLOPS[base] * sum(_numel(t) for t in
                                              _tensors(out))
    if base in _REDUCE_OPS:
        return float(sum(_numel(t) for t in _tensors(args)))
    return 0.0


class _Walk(TorchDispatchMode):
    """Prices every aten op dispatched under it into `report`."""

    def __init__(self, report):
        super().__init__()
        self.report = report

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        key = _FLASH_OPS[name][0] if name in _FLASH_OPS else name
        if key == name and (func.is_view or name in _FREE
                            or not name.startswith("aten::")):
            return out
        moved = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))
        agg = self.report.by_op.setdefault(key, OpCost())
        agg.flops += _flops(name, args, out)
        agg.bytes += moved
        agg.count += 1
        return out


def _active_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, FakeTensorMode):
            return mode
    return None


@contextlib.contextmanager
def fake_mode():
    """The fake-tensor mode to build a model, caches or inputs under for
    `estimate` (the active one when already inside one). Tensors made
    under it carry shapes and dtypes and no storage."""
    mode = _active_fake_mode()
    if mode is not None:
        yield mode
        return
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def estimate(fn, *args, device="h100-sxm", **kwargs):
    """Run `fn(*args, **kwargs)` on fake tensors and return a CostReport
    (no execution: shapes only, so it prices H100-sized work on a CPU
    host). Real tensor arguments are replaced by fake CPU tensors of the
    same shape, dtype and strides."""
    from torch._subclasses.fake_tensor import FakeTensor
    spec = DEVICES[device] if isinstance(device, str) else device
    report = CostReport(spec)
    with fake_mode():
        def fake(x):
            if not isinstance(x, torch.Tensor) or isinstance(x, FakeTensor):
                return x
            t = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                    dtype=x.dtype, device="cpu")
            return t.requires_grad_(x.requires_grad)
        args, kwargs = tree_map(fake, (args, kwargs))
        with _Walk(report):
            fn(*args, **kwargs)
    return report
