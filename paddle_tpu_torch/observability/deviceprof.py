"""Device-profile closed loop: torch.profiler capture -> typed parse -> host
join.

Counterpart of `paddle_tpu/observability/deviceprof.py`, over the chrome
trace that `torch.profiler` (Kineto over CUPTI) writes instead of an XLA
XSpace. The record keeps the reference's schema (`paddle_tpu.deviceprof.v1`)
and every field, so the JAX `deviceprof.validate_record` and
`tools/perf_report.py`'s `load_deviceprof` read the port's records as they
read the JAX package's. `xplane` holds the trace's path and `decoder` is
`"kineto-json"` (`observability/kineto.py`).

  capture     — `DeviceProfiler` context / one-shot `capture()` around one
                `torch.profiler` session: on CUDA the CUPTI activity of
                the card, on an explicit `device="cpu"` the host's
                operator events. The window synchronizes the card before
                the profiler stops, so it holds every kernel it launched;
                `host_window_ms` is the host clock around it. Kineto runs
                one session at a time: a second capture (or a `Profiler`
                window, or any other torch profiler) started while one
                records fails with `CaptureError` and the reason.
  parse       — per-op device time over the lanes that may be summed:
                on a CUDA capture the `kernel`, `gpu_memcpy` and
                `gpu_memset` events, one line per stream (never the
                device ranges of `record_function` spans,
                `gpu_user_annotation`, nor the host's runtime, operator or
                python events); on a CPU capture the `cpu_op` lane of the
                calling thread, with containers (`aten::matmul` around
                `aten::mm`) unnested to self time. A CUDA capture without
                kernel events raises; it never falls back to the host.
  attribution — each kernel's `prim`, the op the cost model prices: the
                port's own kernels by name (`paged_attention`,
                `flash_attention_fwd`/`_dq`/`_dkv`), an eager kernel by
                its `correlation` id to the runtime launch and from there
                to the innermost `cpu_op` around the launch (`aten::mm`,
                the cost model's own keys), a kernel replayed from a CUDA
                graph (no aten op: the launch is `cudaGraphLaunch`) by a
                name table: cuBLAS/CUTLASS gemm and gemv kernels serve
                `aten::mm`, every other kernel stays unattributed.
                `hlo_module` is the graph's executable name where
                `serving/graphs.py` labels the replay (`graph::decode`),
                else the enclosing `serving::...` / `train::...` span.
                Rows are kept per (kernel, op): one elementwise kernel
                serving `aten::add` and `aten::mul` gives two rows. An op
                whose work spans several kernels (a gemm and its split-K
                reduction) is held against each of its rows, so such a
                row's efficiency overstates it.
  join        — device time per step against the host window
                (`reconciles`: the summed device time a step is at most
                the wall time a step; on one stream that is the card's
                busy time, and where streams overlap the sum can exceed
                the wall clock) and per-op efficiency against the
                analytical roofline (`cost_model.estimate`), exported as
                the reference's `deviceprof_*` registry gauges.
  orchestrate — `OneShotCapture`: an armed capture that fires once in a
                healthy window (the serving scheduler's
                `capture_decode_steps`), its states annotated into the
                flight recorder as `deviceprof.<label>`.

CLI: `python -m paddle_tpu_torch.observability.deviceprof
TRACE_DIR_OR_FILE [top] [--jsonl OUT]` prints the per-op table; an absent
or empty capture exits 1 with `FAILED` and the reason on stderr.

Parse, validate, join and render are stdlib-only, and the module loads by
file path without torch; only the capture imports it.
"""
import json
import os
import re
import sys
import time

__all__ = ["SCHEMA", "DECODER", "CaptureError", "DeviceProfiler",
           "OneShotCapture", "capture", "find_trace", "parse",
           "join_cost_model", "validate_record", "write_record",
           "load_records", "render_record", "export_gauges",
           "device_planes", "pick_lines", "kernel_base_name",
           "kernel_prim", "start_session"]

SCHEMA = "paddle_tpu.deviceprof.v1"
DECODER = "kineto-json"
TRACE_SUFFIX = ".pt.trace.json"


class CaptureError(RuntimeError):
    """The capture produced no parseable device profile (and why)."""


# --------------------------------------------------------------- decoding

def _kineto_mod():
    """The trace reader, whether this module lives in the package or was
    loaded by file path."""
    mod = sys.modules.get("paddle_tpu_torch.observability.kineto")
    if mod is not None:
        return mod
    try:
        from . import kineto as mod
        return mod
    except ImportError:
        import importlib.util
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "kineto.py")
        spec = importlib.util.spec_from_file_location(
            "_deviceprof_kineto", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _load_trace(path):
    kineto = _kineto_mod()
    try:
        return kineto.Trace.from_file(path)
    except (OSError, kineto.DecodeError) as e:
        raise CaptureError(f"{path}: not a parseable torch.profiler "
                           f"trace: {e}") from None


def find_trace(root):
    """Newest `*.pt.trace.json` under a trace directory."""
    import glob
    cands = glob.glob(os.path.join(root, "**", "*" + TRACE_SUFFIX),
                      recursive=True)
    if not cands:
        raise CaptureError(f"no {TRACE_SUFFIX} under {root} (capture never "
                           "ran, or trace dir is wrong)")
    return max(cands, key=os.path.getmtime)


# --------------------------------------------- plane/line normalization

_RULE_CATS = {"device_kernels": ("kernel", "gpu_memcpy", "gpu_memset"),
              "cpu_ops": ("cpu_op",)}
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _rule(plane):
    return "cpu_ops" if plane.device is None else "device_kernels"


def _line_total_ns(line, cats):
    return sum(ev.dur_ns for ev in line.events if ev.cat in cats)


def pick_lines(plane, thread=None):
    """The lines of a plane whose events may be summed, largest first:
    [(line, rule), ...].

    A GPU plane keeps every stream line that carries kernel, memcpy or
    memset time (rule `device_kernels`): streams are disjoint lanes of
    work, and the device ranges of `record_function` spans on the same
    lines (`gpu_user_annotation`) are views of the kernels they enclose,
    so they are never counted. The host plane keeps the lines that carry
    `cpu_op` time (rule `cpu_ops`), or only thread `thread`'s; runtime
    calls and python events never count."""
    rule = _rule(plane)
    cats = _RULE_CATS[rule]
    lines = [ln for ln in plane.lines if _line_total_ns(ln, cats) > 0]
    if thread is not None and rule == "cpu_ops":
        lines = [ln for ln in lines if ln.name == f"thread {thread}"]
    lines.sort(key=lambda ln: _line_total_ns(ln, cats), reverse=True)
    return [(ln, rule) for ln in lines]


def device_planes(planes):
    """The GPU planes that carry kernel, memcpy or memset time."""
    return [p for p in planes if p.device is not None and pick_lines(p)]


# ---------------------------------------------- kernel -> op attribution

# The port's own kernels (paddle_tpu_torch/csrc/), by name: the op each
# one computes.
_PORT_KERNELS = {
    "paged_decode_kernel": "paged_attention",
    "paged_window_kernel": "paged_attention",
    "paged_tile_kernel": "paged_attention",
    "flash_fwd_wgmma_kernel": "flash_attention_fwd",
    "flash_fwd_kernel": "flash_attention_fwd",
    "flash_dq_wgmma_kernel": "flash_attention_dq",
    "flash_dq_kernel": "flash_attention_dq",
    "flash_dkv_wgmma_kernel": "flash_attention_dkv",
    "flash_dkv_kernel": "flash_attention_dkv",
}
# cuBLAS / cuBLASLt / CUTLASS product kernels, for launches without an
# aten op (CUDA graph replays)
_GEMM = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|splitKreduce", re.I)
# generic launchers whose first template argument names the kernel
_WRAPPERS = ("Kernel", "Kernel2", "device_kernel")


def _split_name(name):
    """(qualified name without template arguments or parameters, first
    template argument or None)."""
    s = (name or "").strip().replace("(anonymous namespace)", "anon")
    if s.startswith("void "):
        s = s[5:]
    out, depth, first, arg = [], 0, None, []
    for ch in s:
        if ch == "<":
            depth += 1
            continue
        if ch == ">" and depth:
            depth -= 1
            if depth == 0 and first is None:
                first = "".join(arg)
            continue
        if depth:
            if depth == 1 and ch == "," and first is None:
                first = "".join(arg)
            elif first is None:
                arg.append(ch)
            continue
        if ch == "(":
            break
        out.append(ch)
    return "".join(out).strip(), first


def kernel_base_name(name):
    """'void at::native::vectorized_elementwise_kernel<4, ...>(...)' ->
    'vectorized_elementwise_kernel'; 'paged_decode_kernel<...>' ->
    'paged_decode_kernel'; 'Memcpy HtoD (Pageable -> Device)' ->
    'Memcpy HtoD'. A generic launcher (`cutlass::Kernel2<Op>`) takes the
    name of its first template argument."""
    qual, first = _split_name(name)
    base = qual.split("::")[-1].strip() or "?"
    if base in _WRAPPERS and first:
        inner = kernel_base_name(first.strip())
        if inner != "?":
            return inner
    return base


def kernel_prim(base, name, op=None):
    """The op a kernel serves: the port's kernels by name, else the aten
    op around its launch (`op`), else `aten::mm` for a product kernel,
    else None (outside the join's coverage)."""
    if base in _PORT_KERNELS:
        return _PORT_KERNELS[base]
    if op is not None:
        return op
    if _GEMM.search(name or ""):
        return "aten::mm"
    return None


def _innermost(containers, points):
    """{id(point): the latest-started container still open at the point's
    start, or None}. Containers and points are events; a point at the
    same instant as a container's start lies inside it."""
    items = [(c.ts_ns, 0, -c.dur_ns, i, c) for i, c in enumerate(containers)]
    items += [(p.ts_ns, 1, 0, i, p) for i, p in enumerate(points)]
    items.sort(key=lambda t: t[:4])
    stack, out = [], {}
    for ts, kind, _, _, ev in items:
        while stack and stack[-1].ts_ns + stack[-1].dur_ns <= ts:
            stack.pop()
        if kind == 0:
            stack.append(ev)
        else:
            out[id(ev)] = stack[-1] if stack else None
    return out


_SPAN_PREFIXES = ("graph::", "serving::", "train::")


def _module_name(span):
    if span is None:
        return None
    if span.name.startswith("graph::"):
        return span.name[len("graph::"):]
    return span.name


class _Attribution:
    """The host side of a trace, indexed for the kernels' attribution:
    each launch's innermost `cpu_op` (same thread) and innermost labelled
    span (`graph::`, `serving::`, `train::`; by time, any thread, since
    the backward's kernels launch from the autograd thread inside the
    caller's span)."""

    def __init__(self, trace):
        host = [ev for ev in trace.events if ev.cat not in
                _kineto_mod().DEVICE_CATS]
        spans = [ev for ev in host if ev.cat == "user_annotation"
                 and ev.name.startswith(_SPAN_PREFIXES)]
        launches = {}
        by_thread = {}
        for ev in host:
            if ev.cat in _LAUNCH_CATS and ev.correlation is not None:
                launches[ev.correlation] = ev
                by_thread.setdefault(ev.tid, ([], []))[1].append(ev)
            elif ev.cat == "cpu_op":
                by_thread.setdefault(ev.tid, ([], []))[0].append(ev)
        self._launches = launches
        self._op = {}
        for ops, pts in by_thread.values():
            if pts:
                self._op.update(_innermost(ops, pts))
        self._spans = spans
        self._span = _innermost(spans, list(launches.values()))

    def kernel(self, ev, base):
        """(prim, module) of one device event."""
        launch = self._launches.get(ev.correlation)
        op = self._op.get(id(launch)) if launch is not None else None
        prim = kernel_prim(base, ev.name,
                           None if op is None else op.name)
        span = self._span.get(id(launch)) if launch is not None else None
        return prim, _module_name(span)

    def host_modules(self, events):
        """{id(event): module} for host operator events."""
        return {k: _module_name(v) for k, v in
                _innermost(self._spans, events).items()}


def _self_times(events):
    """[(event, self_ns)]: each event's duration minus its DIRECT
    children's — an operator lane nests (`aten::matmul` encloses
    `aten::mm`, which encloses `aten::resolve_conj`), so summing raw
    durations multi-counts the same nanoseconds. Self time is the
    chrome-trace/pprof model: a container keeps only its own overhead.
    Falls back to raw durations when the events carry no usable starts.
    The reference's rule, over kineto events."""
    timed = [(ev.ts_ns, ev.dur_ns, ev) for ev in events]
    if len({t[0] for t in timed}) <= 1 and len(timed) > 1:
        return [(ev, dur) for _, dur, ev in timed]
    timed.sort(key=lambda t: (t[0], -t[1]))
    stack = []                       # [start, end, child_ns]
    out = []

    def close(top):
        out.append((top[3], max(top[1] - top[0] - top[2], 0)))

    for start, dur, ev in timed:
        end = start + dur
        while stack and start >= stack[-1][1]:
            close(stack.pop())
        if stack and end <= stack[-1][1]:
            stack[-1][2] += dur      # direct child: parent loses its span
        elif stack:
            # straddles the open parent's end: treat as a sibling
            while stack:
                close(stack.pop())
        stack.append([start, end, 0, ev])
    while stack:
        close(stack.pop())
    return out


def _aggregate(line, rule, attrib):
    """Per-(op, prim) aggregation over ONE normalized line: only the
    rule's categories count, at self time."""
    cats = _RULE_CATS[rule]
    picked = [ev for ev in line.events if ev.dur_ns > 0 and ev.cat in cats]
    host_mods = attrib.host_modules(picked) if rule == "cpu_ops" else None
    ops = {}
    modules = {}
    n_events = 0
    for ev, self_ns in _self_times(picked):
        if self_ns <= 0:
            continue
        n_events += 1
        if rule == "cpu_ops":
            base, prim, module = ev.name, ev.name, host_mods.get(id(ev))
        else:
            base = kernel_base_name(ev.name)
            prim, module = attrib.kernel(ev, base)
        row = ops.setdefault((base, prim), {"op": base, "prim": prim,
                                            "calls": 0, "device_ns": 0,
                                            "_modules": {}})
        row["calls"] += 1
        row["device_ns"] += self_ns
        if module:
            row["_modules"][module] = row["_modules"].get(module, 0) \
                + self_ns
            modules[module] = modules.get(module, 0) + self_ns
    return ops, modules, n_events


def parse(path, top=None, thread=None):
    """Parse one torch.profiler chrome trace into a
    `paddle_tpu.deviceprof.v1` record. A trace with GPU events (or GPU
    device properties) is a CUDA capture and is read from its kernel
    lanes only; otherwise the host's operator lanes are read (`thread`:
    only that thread's, the caller of an in-process capture). Raises
    CaptureError, with the reason, when nothing countable was captured —
    never a silent empty table, and never the host lane of a CUDA
    capture."""
    path = os.path.abspath(path)
    trace = _load_trace(path)
    cuda = bool(trace.device_properties) or any(
        p.device is not None for p in trace.planes)
    if cuda:
        planes = device_planes(trace.planes)
        if not planes:
            raise CaptureError(
                f"no kernel, memcpy or memset events in the CUDA capture "
                f"{path} (planes: {[p.name for p in trace.planes]}); the "
                "window must span launched work, and a CUDA capture is "
                "never read from its host lane")
        picked = [(p, pick_lines(p)) for p in planes]
    else:
        picked = [(p, pick_lines(p, thread)) for p in trace.planes
                  if p.device is None]
        picked = [(p, lines) for p, lines in picked if lines]
        if not picked:
            raise CaptureError(
                f"no cpu_op events in {path}"
                + (f" on thread {thread}" if thread is not None else "")
                + f" (planes: {[p.name for p in trace.planes]}; the "
                "capture must span real executions)")
    attrib = _Attribution(trace)
    ops = {}
    modules = {}
    plane_rows = []
    n_events = 0
    for plane, lines in picked:
        for line, rule in lines:
            p_ops, p_modules, p_n = _aggregate(line, rule, attrib)
            p_total = sum(r["device_ns"] for r in p_ops.values())
            if p_total <= 0:
                continue
            plane_rows.append({"plane": plane.name, "line": line.name,
                               "rule": rule,
                               "device_ms": round(p_total / 1e6, 6),
                               "n_events": p_n})
            n_events += p_n
            for key, row in p_ops.items():
                agg = ops.setdefault(key, {"op": row["op"],
                                           "prim": row["prim"], "calls": 0,
                                           "device_ns": 0, "_modules": {}})
                agg["calls"] += row["calls"]
                agg["device_ns"] += row["device_ns"]
                for m, ns in row["_modules"].items():
                    agg["_modules"][m] = agg["_modules"].get(m, 0) + ns
            for m, ns in p_modules.items():
                modules[m] = modules.get(m, 0) + ns
    total_ns = sum(r["device_ns"] for r in ops.values())
    if total_ns <= 0:
        raise CaptureError(
            f"device planes present but no timed device events in {path} "
            f"(planes: {[r['plane'] for r in plane_rows]})")
    rows = sorted(ops.values(), key=lambda r: -r["device_ns"])
    if top:
        rows = rows[:top]
    out_ops = []
    for r in rows:
        mods = r.pop("_modules")
        main_mod = max(mods, key=mods.get) if mods else None
        out_ops.append({"op": r["op"], "prim": r["prim"],
                        "calls": int(r["calls"]),
                        "device_ms": round(r["device_ns"] / 1e6, 6),
                        "frac": round(r["device_ns"] / total_ns, 6),
                        "hlo_module": main_mod})

    def _uniq(values):
        seen = []
        for v in values:
            if v not in seen:
                seen.append(v)
        return ";".join(seen)

    return {
        "schema": SCHEMA, "ts": time.time(), "pid": os.getpid(),
        "xplane": path, "decoder": DECODER,
        "plane": _uniq(r["plane"] for r in plane_rows),
        "line": _uniq(r["line"] for r in plane_rows),
        "line_rule": _uniq(r["rule"] for r in plane_rows),
        "planes": plane_rows,
        "total_device_ms": round(total_ns / 1e6, 6),
        "n_events": int(n_events),
        "modules": {m: round(ns / 1e6, 6) for m, ns in sorted(
            modules.items(), key=lambda kv: -kv[1])},
        "ops": out_ops,
    }


# -------------------------------------------------------------- the join

def _pred_value(v):
    if isinstance(v, dict):
        v = v.get("predicted_ms")
    return None if v is None else float(v)


def _predicted_ms(prim, per_op):
    """Predicted roofline ms for one measured op: exact primitive match,
    with the `reduce` HLO opcode joining the sum of the model's reduce_*
    family (XLA collapses all reduce kinds into one opcode)."""
    if not prim or not per_op:
        return None
    if prim in per_op:
        return _pred_value(per_op[prim])
    if prim == "reduce":
        vals = [_pred_value(v) for k, v in per_op.items()
                if k.startswith("reduce_")]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None
    return None


def join_cost_model(record, per_op_predicted=None, steps=1,
                    host_window_ms=None, wall_step_ms=None):
    """Attach the join block: device time per step vs the host wall
    window it was captured in (reconciliation: device <= wall) and
    per-op measured-vs-predicted efficiency against the analytical
    roofline (`cost_model.estimate`'s per-op ms). Mutates and returns
    `record`."""
    steps = max(int(steps), 1)
    if host_window_ms is None:
        host_window_ms = record.get("host_window_ms")
    total = float(record["total_device_ms"])
    dev_per_step = total / steps
    wall = wall_step_ms if wall_step_ms is not None else (
        host_window_ms / steps if host_window_ms else None)
    ratio = (dev_per_step / wall) if wall else None
    rows = []
    joined_ms = 0.0
    for op in record["ops"]:
        measured = op["device_ms"] / steps
        pred = _predicted_ms(op.get("prim"), per_op_predicted)
        eff = (pred / measured) if (pred is not None and measured > 0) \
            else None
        if pred is not None:
            joined_ms += op["device_ms"]
        rows.append({"op": op["op"], "prim": op.get("prim"),
                     "measured_ms_per_step": round(measured, 6),
                     "predicted_ms": None if pred is None
                     else round(pred, 6),
                     "efficiency": None if eff is None else round(eff, 6),
                     "device_frac": op["frac"]})
    record["join"] = {
        "steps": steps,
        "host_window_ms": None if host_window_ms is None
        else round(float(host_window_ms), 4),
        "wall_ms_per_step": None if wall is None else round(float(wall), 6),
        "device_ms_per_step": round(dev_per_step, 6),
        "device_wall_ratio": None if ratio is None else round(ratio, 6),
        "reconciles": bool(ratio is not None and ratio <= 1.0),
        "coverage": round(joined_ms / total, 6) if total else 0.0,
        "per_op": rows,
    }
    return record


# ---------------------------------------------------------------- schema

_OP_FIELDS = {"op": str, "calls": int, "device_ms": (int, float),
              "frac": (int, float)}
_JOIN_FIELDS = {"steps": int, "device_ms_per_step": (int, float),
                "reconciles": bool, "coverage": (int, float),
                "per_op": list}
_JOIN_OP_FIELDS = ("op", "measured_ms_per_step", "predicted_ms",
                   "efficiency")


def validate_record(rec):
    """Return a list of schema violations ([] == valid)."""
    errs = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    if rec.get("schema") != SCHEMA:
        errs.append(f"schema={rec.get('schema')!r}, want {SCHEMA!r}")
    for field in ("xplane", "decoder", "plane", "line", "line_rule"):
        if not isinstance(rec.get(field), str) or not rec.get(field):
            errs.append(f"{field}={rec.get(field)!r} invalid")
    if not isinstance(rec.get("total_device_ms"), (int, float)) \
            or rec.get("total_device_ms", -1) < 0:
        errs.append(f"total_device_ms={rec.get('total_device_ms')!r} invalid")
    if not isinstance(rec.get("n_events"), int) or rec.get("n_events", -1) < 0:
        errs.append(f"n_events={rec.get('n_events')!r} invalid")
    if not isinstance(rec.get("ops"), list) or not rec.get("ops"):
        errs.append("ops missing or empty")
    for op in rec.get("ops") or []:
        if not isinstance(op, dict):
            errs.append(f"op row {op!r} not a dict")
            continue
        for k, types in _OP_FIELDS.items():
            if not isinstance(op.get(k), types):
                errs.append(f"op {op.get('op')!r}: {k}={op.get(k)!r} invalid")
        if isinstance(op.get("frac"), (int, float)) \
                and not 0 <= op["frac"] <= 1.000001:
            errs.append(f"op {op.get('op')!r}: frac {op['frac']} out of "
                        "[0,1]")
    join = rec.get("join")
    if join is not None:
        if not isinstance(join, dict):
            errs.append(f"join={join!r} not a dict")
        else:
            for k, types in _JOIN_FIELDS.items():
                if not isinstance(join.get(k), types):
                    errs.append(f"join.{k}={join.get(k)!r} invalid")
            for row in join.get("per_op") or []:
                missing = [k for k in _JOIN_OP_FIELDS if k not in row]
                if missing:
                    errs.append(f"join row {row!r} missing {missing}")
    return errs


def write_record(rec, path):
    """Validate + append one record to a deviceprof JSONL stream."""
    errs = validate_record(rec)
    if errs:
        raise ValueError(f"invalid {SCHEMA} record: " + "; ".join(errs))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


def load_records(path):
    """Parse + validate a deviceprof JSONL; ValueError on any rot."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from None
            errs = validate_record(rec)
            if errs:
                raise ValueError(f"{path}:{i + 1}: " + "; ".join(errs))
            records.append(rec)
    if not records:
        raise ValueError(f"{path}: empty deviceprof stream")
    return records


# -------------------------------------------------------------- rendering

def _fmt(v, spec=".3f"):
    return "-" if v is None else format(v, spec)


def render_record(rec, top=20):
    """Markdown: the per-op device-time table plus (when joined) the
    measured-vs-predicted efficiency table."""
    lines = [f"## device profile: {rec['plane']} — "
             f"{rec['total_device_ms']:.3f} ms total device time",
             f"(decoder {rec['decoder']}, line {rec['line']!r}, "
             f"rule {rec['line_rule']}, {rec['n_events']} events)", "",
             "| op | prim | calls | ms | % |", "|---|---|---|---|---|"]
    total = rec["total_device_ms"] or 1.0
    for op in rec["ops"][:top]:
        lines.append(
            f"| {op['op'][:60]} | {op.get('prim') or '-'} | {op['calls']} | "
            f"{op['device_ms']:.3f} | {100 * op['device_ms'] / total:.1f} |")
    join = rec.get("join")
    if join:
        ratio = join.get("device_wall_ratio")
        lines += ["", f"### join over {join['steps']} step(s): device "
                  f"{join['device_ms_per_step']:.3f} ms/step vs wall "
                  f"{_fmt(join.get('wall_ms_per_step'))} ms/step "
                  f"(ratio {_fmt(ratio)}, "
                  f"{'reconciles' if join['reconciles'] else 'DOES NOT reconcile'})",
                  "",
                  "| op | measured ms/step | predicted ms | efficiency | "
                  "% device |", "|---|---|---|---|---|"]
        for row in join["per_op"][:top]:
            lines.append(
                f"| {row['op'][:60]} | {row['measured_ms_per_step']:.4f} | "
                f"{_fmt(row['predicted_ms'], '.4f')} | "
                f"{_fmt(row['efficiency'])} | "
                f"{100 * row['device_frac']:.1f} |")
        lines.append("")
        lines.append(f"predicted-row coverage of device time: "
                     f"{100 * join['coverage']:.1f}%")
    return "\n".join(lines)


# ----------------------------------------------------------------- gauges

def export_gauges(record):
    """Publish the joined capture as `deviceprof_*` registry gauges — the
    families tools/metrics_report.py --compare gates as failure classes
    (total device ms/step GROWTH, per-op efficiency DROP)."""
    try:
        from . import metrics
    except ImportError:                     # standalone tool load: no-op
        return
    join = record.get("join") or {}
    if join.get("device_ms_per_step") is not None:
        metrics.gauge(
            "deviceprof_total_device_ms_per_step",
            "Device-side op time per step from the last device capture "
            "(growth past the --compare threshold is failure-class)"
        ).set(join["device_ms_per_step"])
    if join.get("device_wall_ratio") is not None:
        metrics.gauge(
            "deviceprof_device_wall_ratio",
            "Device op time / host wall window of the capture (<=1.0 "
            "reconciles)").set(join["device_wall_ratio"])
    if join.get("coverage") is not None:
        metrics.gauge(
            "deviceprof_join_coverage",
            "Fraction of captured device time carrying a cost-model "
            "predicted row").set(join["coverage"])
    effs = []
    eff_gauge = metrics.gauge(
        "deviceprof_op_efficiency",
        "Per-op predicted-roofline / measured-device time from the last "
        "capture (a drop past the --compare threshold is failure-class)",
        labelnames=("op",))
    for row in join.get("per_op") or []:
        if row.get("efficiency") is not None:
            eff_gauge.labels(op=row["op"]).set(row["efficiency"])
            effs.append(row["efficiency"])
    if effs:
        metrics.gauge(
            "deviceprof_min_op_efficiency",
            "Worst per-op device efficiency among joined ops (drop = "
            "failure-class)").set(min(effs))


# ---------------------------------------------------------------- capture

def _fr_annotate(label, value):
    """Record capture state in the flight recorder, so a postmortem of a
    wedged run carries the armed/in-flight capture instead of losing it.
    Best-effort: the capture must not depend on the recorder."""
    fr = sys.modules.get("paddle_tpu_torch.observability.flight_recorder")
    if fr is None:
        try:
            from . import flight_recorder as fr
        except ImportError:
            return
    try:
        fr.get().annotate(f"deviceprof.{label}", value)
    except Exception:                                        # noqa: BLE001
        pass


WARMUP_LAUNCHES = 1024   # tiny kernels run between prepare and window ...
WARMUP_S = 0.02          # ... for at least this long
SETTLE_S = 0.01          # the window open with nothing launched


def start_session(session, device=None):
    """Start the torch.profiler `session` (made, not started) so that its
    window records every activity of `device`, the card it records
    (None: it records none).

    CUPTI can leave device activities at the start of a window
    unrecorded. On an H100 (torch 2.11, CUDA 12.8), in a process that
    had run for a while, a session opened straight away lost its first
    6-8 (the first step's upload copy and the first kernels of its decode
    graph); and now and then, after a slow prepare, a window lost what
    ran in its first milliseconds, up to a whole decode step. A warm-up
    before the window removed the first loss and a pause after it opened
    the second. So the session is prepared (CUPTI enabled), tiny kernels
    run on the card (at least `WARMUP_LAUNCHES` of them, for at least
    `WARMUP_S`), the card is synchronized, the window is opened, and
    nothing is launched for `SETTLE_S`. The warm-up's records fall before
    the window and are dropped, as a torch.profiler schedule drops its
    warm-up step's. No warm-up while the current stream is capturing a
    CUDA graph, which a launch would join; a session that records no
    card starts at once."""
    import torch
    session.prepare_trace()
    if device is None:
        session.start_trace()
        return
    if not torch.cuda.is_current_stream_capturing():
        x = torch.zeros(1, device=device)
        t_end = time.perf_counter() + WARMUP_S
        n = 0
        while n < WARMUP_LAUNCHES or time.perf_counter() < t_end:
            x.add_(1)
            n += 1
        torch.cuda.synchronize(device)
    session.start_trace()
    time.sleep(SETTLE_S)


class DeviceProfiler:
    """Context manager over one `torch.profiler` session: capture the
    device timeline of the enclosed work into `out_dir` (a
    `*.pt.trace.json`), then `parse()` it. `device` (default "cuda")
    picks the activity: the card's kernels, or on an explicit "cpu" the
    host's operators (the calling thread's), which is how the CPU tests
    run the whole pipeline against real output.

    The window synchronizes the card before the profiler stops, so the
    last launch's kernels land inside it."""

    def __init__(self, out_dir, label="deviceprof", device="cuda"):
        from ..core.device import resolve_device
        self.device = resolve_device(device)
        self.out_dir = os.path.abspath(out_dir)
        self.label = label
        self.trace_path = None
        self.host_window_ms = None
        self._prof = None
        self._thread = None
        self._t0 = None

    def _fail(self, error):
        _fr_annotate(self.label, {"state": "failed", "dir": self.out_dir,
                                  "error": str(error)[:300]})

    def __enter__(self):
        import threading
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.out_dir, exist_ok=True)
        _fr_annotate(self.label, {"state": "capturing",
                                  "dir": self.out_dir})
        if torch.autograd._profiler_enabled():
            err = ("another torch.profiler session is recording (Kineto "
                   "runs one at a time)")
            self._fail(err)
            raise CaptureError(f"device trace failed to start: {err}")
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._thread = threading.get_native_id()
        try:
            self._prof = profile(activities=acts)
            start_session(self._prof, self.device
                          if self.device.type == "cuda" else None)
        except Exception as e:                               # noqa: BLE001
            self._fail(e)
            raise CaptureError(
                f"device trace failed to start ({e}); is another capture "
                "already active?") from e
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        """Synchronize the card and stop the session; returns the host
        window in ms."""
        import torch
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            t1 = time.perf_counter()
            self._prof.stop()
        return 1000.0 * (t1 - self._t0)

    def __exit__(self, exc_type, exc, tb):
        try:
            window_ms = self.stop()
        except Exception as e:                               # noqa: BLE001
            self._fail(e)
            if exc_type is None:
                raise CaptureError(f"device trace failed to stop: {e}") \
                    from e
            return False
        self.host_window_ms = window_ms
        if exc_type is not None:
            self._fail(f"{exc_type.__name__}: {str(exc)[:200]}")
            return False
        path = os.path.join(self.out_dir, f"{self.label}_{os.getpid()}_"
                            f"{time.time_ns()}{TRACE_SUFFIX}")
        try:
            self._prof.export_chrome_trace(path)
        except Exception as e:                               # noqa: BLE001
            self._fail(e)
            raise CaptureError(f"trace export to {path} failed: {e}") from e
        self.trace_path = path
        _fr_annotate(self.label, {"state": "captured", "dir": self.out_dir,
                                  "xplane": path})
        return False

    def parse(self, top=None):
        if self.trace_path is None:
            raise CaptureError("nothing captured yet (use as a context "
                               "manager around real executions)")
        rec = parse(self.trace_path, top=top,
                    thread=self._thread if self.device.type == "cpu"
                    else None)
        rec["host_window_ms"] = round(self.host_window_ms, 4)
        return rec


def capture(fn, out_dir, iters=1, label="deviceprof", top=None,
            device="cuda"):
    """One-shot capture: run `fn()` `iters` times under one device trace
    (the card synchronized before the window closes) and return
    (last_result, parsed deviceprof record)."""
    out = None
    with DeviceProfiler(out_dir, label=label, device=device) as dp:
        for _ in range(iters):
            out = fn()
    return out, dp.parse(top=top)


# ----------------------------------------------- one-shot orchestration

class OneShotCapture:
    """An ARMED capture that fires at most once, in a healthy window the
    caller picks (serving: after a successful decode step). States:

        armed -> capturing -> captured -> reported
                    `-> failed (reason kept)      `-> failed

    Every transition lands in the flight recorder's annotations, so a
    run that wedges with the capture still armed (or mid-flight) leaves
    that fact in its postmortem."""

    def __init__(self, out_dir, label="capture", device="cuda"):
        self.out_dir = os.path.abspath(out_dir)
        self.label = label
        self.device = device
        self.state = "armed"
        self.error = None
        self.record = None
        self.profiler = None
        self._annotate()

    def _annotate(self):
        note = {"state": self.state, "dir": self.out_dir}
        if self.error:
            note["error"] = self.error
        _fr_annotate(self.label, note)

    @property
    def armed(self):
        return self.state == "armed"

    @property
    def captured(self):
        return self.state == "captured"

    def start(self):
        """Open the device trace window (once). False if not armed or the
        trace cannot start — never raises into the caller's hot loop."""
        if self.state != "armed":
            return False
        try:
            self.profiler = DeviceProfiler(self.out_dir, label=self.label,
                                           device=self.device)
            self.profiler.__enter__()
        except Exception as e:                               # noqa: BLE001
            self.state, self.error = "failed", str(e)[:300]
            self._annotate()
            return False
        self.state = "capturing"
        self._annotate()
        return True

    def stop(self):
        """Close the window (the card is synchronized first)."""
        if self.state != "capturing":
            return False
        try:
            self.profiler.__exit__(None, None, None)
        except Exception as e:                               # noqa: BLE001
            self.state, self.error = "failed", str(e)[:300]
            self._annotate()
            return False
        self.state = "captured"
        self._annotate()
        return True

    def abort(self, why):
        """The captured work itself failed: close the trace window so it
        cannot poison later work, and record why. Safe in any state."""
        if self.state == "capturing" and self.profiler is not None:
            try:
                self.profiler.stop()
            except Exception:                                # noqa: BLE001
                pass
        if self.state in ("armed", "capturing"):
            self.state = "failed"
            self.error = str(why)[:300]
            self._annotate()

    def finalize(self, cost_model_per_op=None, steps=1, wall_step_ms=None,
                 top=8, aborted_by=None):
        """Parse + join + write the artifact set (deviceprof.jsonl +
        deviceprof_join.md next to the raw trace) + export the
        deviceprof_* gauges. Returns the summary block; on failure returns
        {"state": "failed", "error": ...} instead of raising — the capture
        is evidence, not a dependency.

        `aborted_by`: the window closed early because the captured work
        failed. The artifacts are still written (marked `aborted_by` in
        the persisted record), but the deviceprof_* gauges are NOT
        exported — --compare must never gate against a known-sick
        window."""
        if self.state != "captured":
            out = {"state": self.state}
            if self.error:
                out["error"] = self.error
            return out
        try:
            rec = self.profiler.parse()
            join_cost_model(rec, cost_model_per_op, steps=steps,
                            wall_step_ms=wall_step_ms)
            if aborted_by:
                rec["aborted_by"] = str(aborted_by)[:300]
            jsonl = os.path.join(self.out_dir, "deviceprof.jsonl")
            write_record(rec, jsonl)
            report = os.path.join(self.out_dir, "deviceprof_join.md")
            with open(report, "w") as f:
                f.write(render_record(rec) + "\n")
            if not aborted_by:
                export_gauges(rec)
            self.record = rec
            self.state = "reported"
            self._annotate()
            join = rec["join"]
            return {"state": "reported",
                    **({"aborted_by": rec["aborted_by"]} if aborted_by
                       else {}),
                    "xplane": rec["xplane"], "jsonl": jsonl,
                    "report": report, "decoder": rec["decoder"],
                    "plane": rec["plane"], "line": rec["line"],
                    "line_rule": rec["line_rule"],
                    "total_device_ms": rec["total_device_ms"],
                    "device_ms_per_step": join["device_ms_per_step"],
                    "wall_ms_per_step": join["wall_ms_per_step"],
                    "device_wall_ratio": join["device_wall_ratio"],
                    "reconciles": join["reconciles"],
                    "join_coverage": join["coverage"],
                    "top_ops": join["per_op"][:top]}
        except Exception as e:                               # noqa: BLE001
            self.state = "failed"
            self.error = f"{type(e).__name__}: {str(e)[:300]}"
            self._annotate()
            return {"state": "failed", "error": self.error}


# -------------------------------------------------------------------- CLI

def main(argv=None):
    """Summarize a capture: the per-op device-time table (the
    counterpart of `tools/xplane_summary.py`)."""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.deviceprof",
        description="Summarize a torch.profiler capture: top ops by "
                    "device time.")
    p.add_argument("path", help=f"trace dir (newest *{TRACE_SUFFIX} wins) "
                                "or a trace file")
    p.add_argument("top_n", nargs="?", type=int, default=20)
    p.add_argument("--jsonl", default=None, metavar="OUT",
                   help="also append the schema-validated deviceprof.v1 "
                        "record here")
    p.add_argument("--join-steps", type=int, default=None, metavar="K",
                   help="the capture spans K steps: adds per-step device "
                        "time to the record")
    args = p.parse_args(argv)
    try:
        if os.path.isdir(args.path):
            path = find_trace(args.path)
        elif os.path.isfile(args.path):
            path = args.path
        else:
            raise CaptureError(
                f"no trace at {args.path} (capture never ran?)")
        rec = parse(path)
        if args.join_steps:
            join_cost_model(rec, None, steps=args.join_steps)
        print(render_record(rec, top=args.top_n))
        if args.jsonl:
            write_record(rec, args.jsonl)
            print(f"\n(record appended to {args.jsonl})")
    except CaptureError as e:
        print(f"deviceprof FAILED: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"deviceprof FAILED (schema): {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
