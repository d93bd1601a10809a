"""Summary views + roofline attribution over host tracer spans.

Counterpart of `paddle_tpu/profiler/statistic.py` (after the reference
framework's profiler_statistic.py: StatisticData, EventSummary,
_build_table), which turns a profiler window's spans into the OverView /
OperatorView / DistributedView / MemoryView tables.

`analyze()` joins each recorded Operator span against the analytical
roofline of `cost_model/analytical.py`. In the port the Operator spans
are the torch profiler's top-level aten ops of the window (the aten name,
and with `record_shapes=True` the input shapes, dtypes, strides and
scalar arguments, kept as the span's `_ref`): each (op, shape) bucket is
priced by dispatching that aten op once more on fake tensors of the
recorded shapes and dtypes (no execution) and taking max(flops/peak,
bytes/bw). The result is a per-op MFU decomposition: achieved host-span
time vs roofline time, the top-k gap contributors, and how much of the
recorded compute time the attribution covers.
"""
import numpy as np

__all__ = ["phase_durations_ms", "op_digest", "build_summary", "analyze",
           "AnalyzeReport"]

# phase-level tracer event types (string values of TracerEventType — kept
# as literals so this module never imports its own package mid-init)
_PHASES = ("Dataloader", "Forward", "Backward", "Optimization",
           "Communication")
_OPERATOR_TYPES = ("Operator", "PythonOp", "UserDefined")


# ------------------------------------------------------------ interval math

def _intervals(events, types):
    """[(start_ns, end_ns)] of completed spans of the given types."""
    out = []
    for e in events:
        if e["type"] in types and e["dur"] is not None:
            out.append((e["ts"], e["ts"] + e["dur"]))
    return out


def _merge(intervals):
    """Collapse intervals into a sorted disjoint union."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union_ns(intervals):
    """Total length of the union of intervals (double counting removed —
    nested same-phase spans collapse)."""
    return sum(e - s for s, e in _merge(intervals))


def _intersect_ns(a, b):
    """Length of intersection of two interval unions."""
    if not a or not b:
        return 0
    a = _merge(a)
    b = _merge(b)
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_durations_ms(events):
    """{phase: union-ms} for the framework phase span types present."""
    out = {}
    for ph in _PHASES:
        ns = _union_ns(_intervals(events, (ph,)))
        if ns:
            out[ph] = round(ns / 1e6, 4)
    return out


def _wall_ns(events):
    """Profiled wall time: union of ProfileStep spans when present, else
    the overall event envelope."""
    steps = _intervals(events, ("ProfileStep",))
    if steps:
        return _union_ns(steps)
    done = [e for e in events if e["dur"] is not None]
    if not done:
        return 0
    return max(e["ts"] + e["dur"] for e in done) - min(e["ts"] for e in done)


# ----------------------------------------------------------- op aggregation

def _shape_key(e):
    attrs = e.get("attrs") or {}
    shapes = attrs.get("input_shapes")
    if shapes is None:
        return ""
    return "x".join(str(tuple(s)) for s in shapes) or "()"


def _op_events(events):
    return [e for e in events
            if e["type"] in _OPERATOR_TYPES and e["dur"] is not None]


def op_digest(events, top=8):
    """Compact per-op digest for the step-timeline JSONL: top ops by total
    host time, shape-bucketed."""
    buckets = {}
    for e in _op_events(events):
        key = (e["name"], _shape_key(e))
        b = buckets.setdefault(key, {"name": e["name"], "shapes": key[1],
                                     "calls": 0, "total_ms": 0.0,
                                     "cache_hits": 0, "cache_misses": 0})
        b["calls"] += 1
        b["total_ms"] += e["dur"] / 1e6
        cache = (e.get("attrs") or {}).get("cache")
        if cache == "hit":
            b["cache_hits"] += 1
        elif cache == "miss":
            b["cache_misses"] += 1
    rows = sorted(buckets.values(), key=lambda b: -b["total_ms"])[:top]
    for r in rows:
        r["total_ms"] = round(r["total_ms"], 4)
    return rows


def _operator_rows(events):
    """OperatorView rows: (name, shapes)-bucketed host-span statistics."""
    buckets = {}
    for e in _op_events(events):
        key = (e["name"], _shape_key(e))
        buckets.setdefault(key, []).append(e)
    rows = []
    for (name, shapes), evs in buckets.items():
        durs = np.asarray([e["dur"] for e in evs], np.float64) / 1e6
        cache = [(e.get("attrs") or {}).get("cache") for e in evs]
        rows.append({
            "name": name, "shapes": shapes, "calls": len(evs),
            "total_ms": float(durs.sum()), "avg_ms": float(durs.mean()),
            "max_ms": float(durs.max()), "min_ms": float(durs.min()),
            "cache_hits": sum(c == "hit" for c in cache),
            "cache_misses": sum(c == "miss" for c in cache),
        })
    return rows


_SORT_FIELDS = {0: "total_ms", 1: "avg_ms", 2: "max_ms", 3: "min_ms",
                4: "total_ms", 5: "avg_ms", 6: "max_ms", 7: "min_ms"}


def _sort_rows(rows, sorted_by):
    field = _SORT_FIELDS.get(sorted_by, "total_ms")
    return sorted(rows, key=lambda r: r[field], reverse=field != "min_ms")


# ------------------------------------------------------------------ tables

_UNITS = {"s": 1e-3, "ms": 1.0, "us": 1e3, "ns": 1e6}


def _fmt_table(headers, rows):
    widths = [max(len(h), *(len(str(r[i])) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(f"{h:<{w}}" for h, w in zip(headers, widths))]
    for r in rows:
        lines.append("  ".join(f"{str(c):<{w}}" for c, w in zip(r, widths)))
    return "\n".join(lines)


def _overview_table(events, unit_scale, unit):
    wall = _wall_ns(events)
    if not wall:
        return None
    phases = {}
    for ph in _PHASES:
        ns = _union_ns(_intervals(events, (ph,)))
        if ns:
            phases[ph] = ns
    # top-level operator time not nested inside any phase span
    op_iv = _intervals(events, _OPERATOR_TYPES)
    phase_iv = _intervals(events, _PHASES)
    op_outside = _union_ns(op_iv) - _intersect_ns(op_iv, phase_iv)
    covered = _union_ns(phase_iv) + max(op_outside, 0)
    rows = [["ProfileStep (wall)", f"{wall / 1e6 * unit_scale:.3f}", "100.0%"]]
    for ph, ns in sorted(phases.items(), key=lambda kv: -kv[1]):
        rows.append([ph, f"{ns / 1e6 * unit_scale:.3f}",
                     f"{100.0 * ns / wall:.1f}%"])
    if op_outside > 0:
        rows.append(["Operator (outside phases)",
                     f"{op_outside / 1e6 * unit_scale:.3f}",
                     f"{100.0 * op_outside / wall:.1f}%"])
    other = max(wall - covered, 0)
    rows.append(["Other (python/untracked)",
                 f"{other / 1e6 * unit_scale:.3f}",
                 f"{100.0 * other / wall:.1f}%"])
    return ("-------------------Overview Summary-------------------\n"
            + _fmt_table(["Phase", f"Total({unit})", "Ratio"], rows))


def _operator_table(events, sorted_by, unit_scale, unit):
    rows = _operator_rows(events)
    if not rows:
        return None
    rows = _sort_rows(rows, sorted_by)
    disp = []
    for r in rows:
        cache = ""
        if r["cache_hits"] or r["cache_misses"]:
            cache = f"{r['cache_hits']}/{r['cache_hits'] + r['cache_misses']}"
        disp.append([r["name"], r["shapes"] or "-", r["calls"],
                     f"{r['total_ms'] * unit_scale:.3f}",
                     f"{r['avg_ms'] * unit_scale:.3f}",
                     f"{r['max_ms'] * unit_scale:.3f}",
                     f"{r['min_ms'] * unit_scale:.3f}", cache or "-"])
    return ("-------------------Operator Summary-------------------\n"
            + _fmt_table(["Name", "InputShapes", "Calls", f"Total({unit})",
                          f"Avg({unit})", f"Max({unit})", f"Min({unit})",
                          "CacheHit"], disp))


def _distributed_table(events, unit_scale, unit):
    comm = _intervals(events, ("Communication",))
    if not comm:
        return None
    compute = _intervals(events, ("Operator", "Forward", "Backward",
                                  "Optimization"))
    wall = _wall_ns(events) or 1
    comm_ns = _union_ns(comm)
    comp_ns = _union_ns(compute)
    overlap = _intersect_ns(comm, compute)
    rows = [
        ["Communication", f"{comm_ns / 1e6 * unit_scale:.3f}",
         f"{100.0 * comm_ns / wall:.1f}%"],
        ["Computation", f"{comp_ns / 1e6 * unit_scale:.3f}",
         f"{100.0 * comp_ns / wall:.1f}%"],
        ["Overlap", f"{overlap / 1e6 * unit_scale:.3f}",
         f"{100.0 * overlap / wall:.1f}%"],
    ]
    payload = sum((e.get("attrs") or {}).get("payload_bytes", 0)
                  for e in events if e["type"] == "Communication")
    if payload:
        rows.append(["Payload", f"{payload / 1e6:.2f} MB", "-"])
    return ("-----------------Distributed Summary------------------\n"
            + _fmt_table(["Name", f"Total({unit})", "Ratio"], rows))


def _memory_table(events):
    samples = []
    for e in events:
        for k in ("mem0", "mem1"):
            if e.get(k) is not None:
                samples.append(e[k])
    if not samples:
        return None
    rows = [["peak", f"{max(samples) / 1e6:.2f} MB"],
            ["low", f"{min(samples) / 1e6:.2f} MB"],
            ["net", f"{(samples[-1] - samples[0]) / 1e6:+.2f} MB"]]
    for ph in _PHASES + ("Operator",):
        deltas = [e["mem1"] - e["mem0"] for e in events
                  if e["type"] == ph and e.get("mem0") is not None
                  and e.get("mem1") is not None]
        if deltas:
            rows.append([f"{ph} delta", f"{sum(deltas) / 1e6:+.2f} MB"])
    return ("-------------------Memory Summary---------------------\n"
            + _fmt_table(["Metric", "LiveBytes"], rows))


def build_summary(events, sorted_by=None, views=None, time_unit="ms"):
    """Render the selected SummaryView tables as one string. Default: the
    OverView + OperatorView, plus DistributedView / MemoryView whenever
    comm spans / memory samples were recorded."""
    if not events:
        return ""
    unit_scale = _UNITS.get(time_unit, 1.0)
    if views is not None and not isinstance(views, (list, tuple, set)):
        views = [views]
    # SummaryView numeric values (kept as literals: OverView=1,
    # DistributedView=3, OperatorView=5, MemoryView=6)
    want = set(views) if views is not None else None

    def wanted(v, default_on):
        return (v in want) if want is not None else default_on

    parts = []
    if wanted(1, True):
        parts.append(_overview_table(events, unit_scale, time_unit))
    if wanted(5, True):
        parts.append(_operator_table(events, sorted_by, unit_scale,
                                     time_unit))
    if wanted(3, True):
        parts.append(_distributed_table(events, unit_scale, time_unit))
    if wanted(6, True):
        parts.append(_memory_table(events))
    return "\n\n".join(p for p in parts if p)


# -------------------------------------------------- roofline attribution

_ROOFLINE_CACHE = {}

# the profiler's names for the dtypes of recorded inputs
_DTYPES = {"float": "float32", "double": "float64",
           "c10::BFloat16": "bfloat16", "c10::Half": "float16",
           "long int": "int64", "int": "int32", "short int": "int16",
           "signed char": "int8", "unsigned char": "uint8", "bool": "bool"}


def _value(dims, kind, strides, concrete):
    """One recorded input as a call argument: a fake tensor of its shape,
    dtype and strides, a scalar or list from its concrete value, None."""
    import ast

    import torch
    if kind in _DTYPES:
        dtype = getattr(torch, _DTYPES[kind])
        if strides and len(strides) == len(dims):
            return torch.empty_strided(dims, strides, dtype=dtype)
        return torch.empty(dims, dtype=dtype)
    if kind == "TensorList":
        return [torch.empty(d) for d in dims]
    if concrete in ("", None):
        return None
    try:
        return ast.literal_eval(concrete)
    except (ValueError, SyntaxError):
        return concrete


def _call_op(name, values):
    """Call aten op `name` on `values` (every schema argument, in order):
    the first overload whose argument count matches and that accepts
    them."""
    import torch
    ns, op = name.split("::", 1)
    packet = getattr(getattr(torch.ops, ns), op)
    for ov in packet.overloads():
        fn = getattr(packet, ov)
        schema = fn._schema.arguments
        if len(schema) != len(values):
            continue
        pos = [v for a, v in zip(schema, values) if not a.kwarg_only]
        kw = {a.name: v for a, v in zip(schema, values) if a.kwarg_only}
        try:
            return fn(*pos, **kw)
        except (RuntimeError, TypeError, ValueError, IndexError):
            continue
    raise TypeError(f"no overload of {name} takes the recorded inputs")


def _estimate_ref(ref, spec, variant=""):
    """(flops, bytes, roofline_ms) of one recorded op call: ref is
    (aten name, input dims, input types, input strides, concrete inputs)
    from the torch profiler. The op is dispatched once more on fake
    tensors of those shapes and dtypes (no execution). Returns None when
    the op cannot be priced (not an aten op, or no overload takes the
    recorded inputs). `variant` is accepted for the reference's
    signature; a recorded op is identified by its inputs."""
    name, dims, kinds, strides, concrete = ref
    key = (name, repr(dims), repr(kinds), repr(strides)[:400],
           repr(concrete)[:200], spec.name)
    if key in _ROOFLINE_CACHE:
        return _ROOFLINE_CACHE[key]
    from ..cost_model.analytical import estimate, fake_mode
    out = None
    if name.startswith("aten::"):
        try:
            with fake_mode():
                values = [_value(d, k, s, c) for d, k, s, c in
                          zip(dims, kinds, strides, concrete)]
                rep = estimate(lambda: _call_op(name, values), device=spec)
            out = (rep.total_flops, rep.total_bytes, rep.time_ms)
        except Exception:                                    # noqa: BLE001
            out = None
    _ROOFLINE_CACHE[key] = out
    return out


class AnalyzeReport:
    """Per-op MFU decomposition of a profiled run.

    rows: one per (op, shape) bucket — achieved host-span ms vs analytical
    roofline ms, flops/bytes, efficiency (roofline/achieved, the op's MFU
    proxy) and gap_ms (achieved - roofline, what eliminating all dispatch/
    layout inefficiency would recover). top_gaps: the top-k gap
    contributors. coverage: attributed achieved-time / total recorded
    compute span time. phases: OverView-style union durations."""

    def __init__(self, device, rows, phases, step_ms_total, coverage,
                 top_k=3):
        self.device = device
        self.rows = rows
        self.phases = phases
        self.step_ms_total = step_ms_total
        self.coverage = coverage
        self.top_gaps = [r for r in
                         sorted(rows, key=lambda r: -(r["gap_ms"] or 0))
                         if r["roofline_ms"] is not None
                         and (r["gap_ms"] or 0) > 0][:top_k]

    def to_dict(self):
        return {"device": self.device.name, "phases": self.phases,
                "step_ms_total": self.step_ms_total,
                "coverage": self.coverage, "rows": self.rows,
                "top_gap_contributors": [r["name"] for r in self.top_gaps]}

    def table(self, top=15):
        rows = sorted(self.rows, key=lambda r: -r["achieved_ms"])[:top]
        out = ["| op | shapes | calls | achieved ms | roofline ms | "
               "efficiency | gap ms |", "|---|---|---|---|---|---|---|"]
        for r in rows:
            rf = "-" if r["roofline_ms"] is None else f"{r['roofline_ms']:.4f}"
            eff = "-" if r["efficiency"] is None else f"{r['efficiency']:.3f}"
            gap = "-" if r["gap_ms"] is None else f"{r['gap_ms']:.4f}"
            out.append(f"| {r['name']} | {r['shapes'] or '-'} | {r['calls']} "
                       f"| {r['achieved_ms']:.4f} | {rf} | {eff} | {gap} |")
        return "\n".join(out)

    def render(self):
        lines = [f"# MFU attribution ({self.device.name})", ""]
        if self.step_ms_total:
            lines.append(f"profiled wall time: {self.step_ms_total:.2f} ms")
        if self.phases:
            lines.append("phase breakdown (ms): " + ", ".join(
                f"{k}={v:.2f}" for k, v in self.phases.items()))
        lines.append(f"roofline coverage of recorded compute span time: "
                     f"{100.0 * self.coverage:.1f}%")
        if self.top_gaps:
            lines.append("top MFU gap contributors: " + ", ".join(
                f"{r['name']} (+{r['gap_ms']:.3f} ms)"
                for r in self.top_gaps))
        if any(r["efficiency"] is not None and r["efficiency"] > 1.0
               for r in self.rows):
            lines.append(
                "note: efficiency > 1 rows are device-bound — a CUDA "
                "launch is async, so the host span returned before the "
                "kernel finished; their true time lives in the device "
                "profile (observability.deviceprof).")
        lines += ["", self.table()]
        return "\n".join(lines)

    def __repr__(self):
        return (f"AnalyzeReport(device={self.device.name}, "
                f"ops={len(self.rows)}, coverage={self.coverage:.2f})")


def _resolve_device(device):
    """The roofline's DeviceSpec: `device` itself, or a `DEVICES` name;
    else `PADDLE_TPU_DEVICE_SPEC` when set; else "cpu" for a CPU window
    (`device` a torch device or "cpu") and "h100-sxm" otherwise."""
    from ..cost_model.analytical import DEVICES, DeviceSpec
    if isinstance(device, DeviceSpec):
        return device
    if isinstance(device, str) and device in DEVICES:
        return DEVICES[device]
    import os
    env = os.environ.get("PADDLE_TPU_DEVICE_SPEC")
    if env:
        return DEVICES[env]
    if device is not None and str(device).split(":")[0] == "cpu":
        return DEVICES["cpu"]
    return DEVICES["h100-sxm"]


def analyze(events, step_times=None, device=None, top_k=3):
    """Join host spans against the analytical roofline (the verdict's
    'analytical decomposition using the repo's own cost model')."""
    spec = _resolve_device(device)
    phases = phase_durations_ms(events)
    wall_ms = _wall_ns(events) / 1e6
    if not wall_ms and step_times:
        wall_ms = float(np.sum(step_times)) * 1e3

    buckets = {}
    for e in events:
        if e["type"] != "Operator" or e["dur"] is None:
            continue
        # variant keeps same-shaped ops with different closures/defaults
        # (e.g. the two lambdas of one `split`) in separate priced buckets
        key = (e["name"], _shape_key(e),
               (e.get("attrs") or {}).get("variant", ""))
        b = buckets.setdefault(key, {"events": [], "ref": None})
        b["events"].append(e)
        if b["ref"] is None and e.get("_ref") is not None:
            b["ref"] = e["_ref"]

    rows = []
    total_compute_ms = 0.0
    attributed_ms = 0.0
    for (name, shapes, variant), b in buckets.items():
        achieved_ms = sum(e["dur"] for e in b["events"]) / 1e6
        total_compute_ms += achieved_ms
        est = _estimate_ref(b["ref"], spec, variant) \
            if b["ref"] is not None else None
        row = {"name": name, "shapes": shapes, "calls": len(b["events"]),
               "achieved_ms": achieved_ms, "roofline_ms": None,
               "flops": None, "bytes": None, "efficiency": None,
               "gap_ms": None}
        if est is not None:
            flops, bytes_, per_call_ms = est
            roofline_ms = per_call_ms * len(b["events"])
            row.update({
                "roofline_ms": roofline_ms,
                "flops": flops * len(b["events"]),
                "bytes": bytes_ * len(b["events"]),
                "efficiency": (roofline_ms / achieved_ms)
                if achieved_ms > 0 else None,
                "gap_ms": achieved_ms - roofline_ms,
            })
            attributed_ms += achieved_ms
        rows.append(row)

    coverage = attributed_ms / total_compute_ms if total_compute_ms else 0.0
    rows.sort(key=lambda r: -r["achieved_ms"])
    return AnalyzeReport(spec, rows, phases, wall_ms, coverage, top_k=top_k)
