"""The profiler: span recorder, RecordEvent, scheduler windows, summary
views and roofline attribution.

Counterpart of `paddle_tpu/profiler/__init__.py` (after the reference
framework's profiler.py `Profiler`):

- host tracer: `_HostTracer` and its module singleton `_tracer` record
  RecordEvent spans per thread. The fault sites and the flight recorder
  find `_tracer` through `sys.modules["paddle_tpu_torch.profiler"]`, so
  the port's spans never land in the JAX package's tracer. Where the JAX
  `RecordEvent` also opens a `jax.profiler.TraceAnnotation`, the port's
  opens `torch.profiler.record_function(name)`, and only while a torch
  profiler is recording: a profiled serving step then shows
  `serving::decode_step` and its siblings on the card's timeline, and an
  unprofiled step pays only for the host tracer, one attribute load when
  the tracer is closed and no flight recorder is attached.
- device side: a `Profiler` record window is one `torch.profiler`
  session (the CUDA activity for a CUDA profiler), started where the
  reference starts `jax.profiler.start_trace`; its chrome trace is
  exported under `log_dir` (`Profiler.last_trace`) and read by
  `observability.deviceprof`. The reference's Operator spans come from
  the eager framework's `apply_op`; here a window records those of the
  port's `core.tensor.apply_op` (one per eager op, named by the op, with
  its input shapes and dtypes) and the session's top-level aten ops
  (`aten::` events outside any other on their thread), with their input
  shapes when `record_shapes=True`, which `analyze()` prices.
- `profile_memory=True` samples `torch.cuda.memory_allocated()` at span
  boundaries (MemoryView); a CPU profiler has no allocator to sample.
- `export_chrome_tracing` over the host spans, `statistic.py` for the
  summary views and the roofline attribution (`Profiler.analyze`).
"""
import json
import os
import threading
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability.tracecontext import (
    clear_trace as _clear_trace, current_trace_id as _current_trace_id,
    ensure_trace as _ensure_trace, new_span_id as _new_span_id,
    process_trace_id as _process_trace_id,
)

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "TracerEventType", "SortedKeys", "SummaryView",
           "make_scheduler", "export_chrome_tracing", "export_protobuf",
           "load_profiler_result"]

STEP_TIMELINE_SCHEMA = "paddle_tpu.step_timeline.v1"


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"
    CUSTOM_DEVICE = "custom_device"


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Reference: profiler.py make_scheduler — cycle through
    closed/ready/record windows."""
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        cycle = closed + ready + record
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def _live_bytes(device):
    """Bytes the caching allocator holds for tensors on `device` now (the
    MemoryView sample); None on the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.memory_allocated(device))


class _HostTracer:
    """Span recorder. Spans: dicts with name, thread id, start/end (ns),
    nesting depth, optional attrs.

    The `enabled` attribute is the hot-path guard: a closed tracer with no
    flight-recorder ring attached records nothing.

    Thread safety: every thread owns its own nesting stack in `_stacks`
    (keyed by thread id, readable cross-thread by the flight recorder's
    postmortem dump); span and parent ids come from that per-thread stack,
    and the shared `events` list is only touched under `_lock`.

    Trace context: every span carries a fresh 8-byte `span_id`, its
    same-thread `parent` span id and the current `trace` id.

    Flight recorder: when `ring` is attached, closed spans are also pushed
    there, including spans recorded while the tracer is closed.

    Memory: while `memory_device` is set, every span samples the device's
    allocated bytes at its start (`mem0`) and end (`mem1`)."""

    def __init__(self):
        self.enabled = False
        self.memory_device = None
        self.events = []
        self.ring = None                 # FlightRecorder, when enabled
        self._lock = threading.Lock()
        self._stacks = {}                # thread id -> open-span stack

    def _stack(self):
        tid = threading.get_ident()
        st = self._stacks.get(tid)
        if st is None:
            st = self._stacks.setdefault(tid, [])
        return st

    def begin(self, name, event_type, attrs=None):
        if not self.enabled and self.ring is None:
            return None
        st = self._stack()
        rec = {"name": name, "type": event_type,
               "tid": threading.get_ident(),
               "ts": time.perf_counter_ns(), "dur": None,
               "depth": len(st),
               "span_id": _new_span_id(),
               "parent": st[-1]["span_id"] if st else None,
               "trace": _current_trace_id()}
        if not self.enabled:             # ring-only span: keep it out of
            rec["_fr_only"] = True       # the tracer's window events
        if attrs is not None:
            rec["attrs"] = attrs
        if self.memory_device is not None:
            rec["mem0"] = _live_bytes(self.memory_device)
        st.append(rec)
        return rec

    def end(self, rec):
        if rec is None:
            return
        st = self._stack()
        if st and st[-1] is rec:
            st.pop()
        elif rec in st:                   # unbalanced nesting: drop through
            st.remove(rec)
        if not st:                        # evict: dead threads must not
            self._stacks.pop(threading.get_ident(), None)  # leak entries
        rec["dur"] = time.perf_counter_ns() - rec["ts"]
        if self.memory_device is not None:
            rec["mem1"] = _live_bytes(self.memory_device)
        ring = self.ring
        if ring is not None:
            ring.record_span(rec)
        if rec.pop("_fr_only", False):
            return
        with self._lock:
            self.events.append(rec)

    def cancel(self, rec):
        """Abandon an open span without recording it (an RPC handler
        whose connection dropped mid-frame)."""
        if rec is None:
            return
        st = self._stack()
        if st and st[-1] is rec:
            st.pop()
        elif rec in st:
            st.remove(rec)
        if not st:
            self._stacks.pop(threading.get_ident(), None)

    def drain(self):
        with self._lock:
            ev, self.events = self.events, []
        return ev


_tracer = _HostTracer()


class TracerEventType:
    Operator = "Operator"
    Dataloader = "Dataloader"
    ProfileStep = "ProfileStep"
    Forward = "Forward"
    Backward = "Backward"
    Optimization = "Optimization"
    Communication = "Communication"
    PythonOp = "PythonOp"
    UserDefined = "UserDefined"


def _torch_profiling():
    """Whether a torch profiler is recording on this thread."""
    return torch.autograd._profiler_enabled()


class RecordEvent:
    """User-code span. Also opens `torch.profiler.record_function(name)`
    while a torch profiler records, so the span shows on its timeline."""

    __slots__ = ("name", "event_type", "attrs", "_rec", "_ann")

    def __init__(self, name, event_type=TracerEventType.PythonOp, attrs=None):
        self.name = name
        self.event_type = event_type
        self.attrs = attrs
        self._rec = None
        self._ann = None

    def begin(self):
        self._rec = _tracer.begin(self.name, self.event_type, self.attrs)
        if _torch_profiling():
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        _tracer.end(self._rec)
        self._rec = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _json_safe_attrs(rec):
    attrs = rec.get("attrs")
    if not attrs:
        return None
    out = {}
    for k, v in attrs.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out


def export_chrome_tracing(dir_name, worker_name=None):
    """Returns an on_trace_ready handler writing chrome://tracing JSON and
    returning the file's path. Given the `Profiler` (as `on_trace_ready`
    calls it), it exports the last record window (an empty window exports
    as empty, never silently the cumulative history); given a list of
    span records (a window of the tracer's events, `_tracer.drain()`), it
    exports those.

    Each (thread, nesting depth) gets its own tid lane with thread_name
    metadata, so nested spans render stacked. Every span's args carry its
    trace_id/span_id/parent_span_id, and the file's otherData carries
    clock_sync_ns (wall-clock epoch minus this process's perf_counter
    origin): what `observability.merge_chrome_traces` needs to fold the
    per-process exports of a distributed run into one timeline."""
    def handler(prof):
        if isinstance(prof, Profiler):
            window = prof._window_events
            if window is None:      # stopped without ever recording
                window = prof._events
        else:
            window = prof
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_time_{int(time.time())}"
                            ".paddle_trace.json")
        pid = os.getpid()
        lanes = {}                  # (tid, depth) -> lane id
        events = []
        for e in window:
            lane_key = (e["tid"], e["depth"])
            lane = lanes.setdefault(lane_key, len(lanes))
            ev = {"name": e["name"], "cat": e["type"], "ph": "X",
                  "pid": pid, "tid": lane,
                  "ts": e["ts"] / 1000.0, "dur": (e["dur"] or 0) / 1000.0}
            args = _json_safe_attrs(e) or {}
            if e.get("span_id"):
                args["span_id"] = e["span_id"]
            if e.get("parent"):
                args["parent_span_id"] = e["parent"]
            if e.get("trace"):
                args["trace_id"] = e["trace"]
            if args:
                ev["args"] = args
            events.append(ev)
        meta = []
        for (tid, depth), lane in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": lane,
                         "args": {"name": f"thread {tid} · depth {depth}"}})
            meta.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                         "tid": lane, "args": {"sort_index": lane}})
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + events,
                       "displayTimeUnit": "ms",
                       "otherData": {
                           "clock_sync_ns":
                               time.time_ns() - time.perf_counter_ns(),
                           "pid": pid}}, f)
        if isinstance(prof, Profiler):
            prof._exported_path = path
        return path
    return handler


def export_protobuf(dir_name, worker_name=None):
    """The reference's protobuf dump; here an alias of chrome tracing (the
    device timeline is the torch profiler's own trace,
    `Profiler.last_trace`)."""
    return export_chrome_tracing(dir_name, worker_name)


def load_profiler_result(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------------ profiler

def _operator_spans(trace, clock_sync_ns):
    """The window's Operator spans: the session's `aten::` cpu_op events
    that no other `aten::` op on their thread encloses, on the host
    tracer's clock (perf_counter ns), with the recorded inputs as `attrs`
    (shapes, dtypes) and `_ref` (for `statistic.analyze`) when the session
    recorded shapes."""
    by_thread = {}
    for ev in trace.events:
        if ev.cat == "cpu_op" and ev.name.startswith("aten::"):
            by_thread.setdefault(ev.tid, []).append(ev)
    spans = []
    for tid, evs in by_thread.items():
        evs.sort(key=lambda e: (e.ts_ns, -e.dur_ns))
        end = None
        for ev in evs:
            if end is not None and ev.ts_ns < end:
                continue                      # nested in the previous op
            end = ev.ts_ns + ev.dur_ns
            rec = {"name": ev.name, "type": TracerEventType.Operator,
                   "tid": tid, "depth": 0, "dur": ev.dur_ns,
                   "ts": trace.base_ns + ev.ts_ns - clock_sync_ns}
            dims = ev.args.get("Input Dims")
            if dims is not None:
                kinds = ev.args.get("Input type") or [""] * len(dims)
                strides = ev.args.get("Input Strides") or [None] * len(dims)
                concrete = ev.args.get("Concrete Inputs") or [""] * len(dims)
                rec["attrs"] = {
                    "input_shapes": [tuple(d) for d, k in zip(dims, kinds)
                                     if k and isinstance(d, list)
                                     and all(isinstance(x, int) for x in d)],
                    "input_dtypes": [k for k in kinds if k]}
                rec["_ref"] = (ev.name, dims, kinds, strides, concrete)
            spans.append(rec)
    return spans


class Profiler:
    """Scheduler-windowed profiler (reference: profiler.py:340).

    `device` (default "cuda") is where the profiled work runs: without
    CUDA it raises unless "cpu" is passed. targets defaults to host +
    device; timer_only=True records host spans only, without the torch
    profiler session (benchmark mode, reference semantics).
    record_shapes=True records each Operator span's input shapes, which
    `analyze()` needs to price it (with_flops=False keeps the shapes but
    drops the pricing reference). profile_memory=True samples the card's
    allocated bytes at span boundaries (MemoryView). timeline=<path>
    appends one JSONL record per recorded step (phase durations, op
    digest, memory peak) — the artifact tools/perf_report.py renders;
    the records of a window are written when it closes, since its ops
    come from the window's session. log_dir is where each window's trace
    is exported (`last_trace`).

    One torch profiler session runs at a time: a window that opens while
    another session records (a `deviceprof` capture, say) keeps its host
    spans and records no device side; `device_error` says why."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=True, timeline=None, log_dir="./profiler_log",
                 device="cuda"):
        self._device = resolve_device(device)
        if callable(scheduler):
            self._scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            self._scheduler = make_scheduler(closed=lo, record=hi - lo,
                                             repeat=1)
        else:
            self._scheduler = None  # always on
        targets = targets if targets is not None else (
            ProfilerTarget.CPU, ProfilerTarget.GPU)
        self._cuda = (self._device.type == "cuda"
                      and ProfilerTarget.GPU in targets)
        self._on_trace_ready = on_trace_ready
        self._timer_only = timer_only
        self._record_shapes = bool(record_shapes)
        self._profile_memory = bool(profile_memory)
        self._with_flops = bool(with_flops)
        self._timeline_path = timeline
        self._log_dir = log_dir
        self._step = 0
        self._state = ProfilerState.CLOSED
        self._session = None
        self.device_error = None
        self.last_trace = None
        self._events = []
        self._step_times = []
        self._step_samples = []
        self._last_t = None
        self._step_rec = None
        self._exported_path = None
        self._window_events = None
        self._pending = []          # this window's step records, unwritten

    # ------------------------------------------------------------ lifecycle
    def _target_state(self):
        if self._scheduler is None:
            return ProfilerState.RECORD
        return self._scheduler(self._step)

    def _recording(self):
        return self._state in (ProfilerState.RECORD,
                               ProfilerState.RECORD_AND_RETURN)

    def _transition(self, new):
        recording = self._recording()
        want = new in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
        if want and not recording:
            _tracer.memory_device = self._device if self._profile_memory \
                else None
            _tracer.enabled = True
            if not self._timer_only:
                self._start_session()
        if recording and not want:
            self._collect()
        self._state = new

    def _start_session(self):
        from torch.profiler import ProfilerActivity, profile
        from ..observability.deviceprof import start_session
        if torch.autograd._profiler_enabled():
            self.device_error = ("another torch.profiler session is "
                                 "recording (Kineto runs one at a time)")
            return
        acts = [ProfilerActivity.CPU]
        if self._cuda:
            acts.append(ProfilerActivity.CUDA)
        try:
            session = profile(activities=acts,
                              record_shapes=self._record_shapes)
            start_session(session, self._device if self._cuda else None)
        except RuntimeError as e:
            self.device_error = f"torch.profiler failed to start: {e}"
            return
        self._session = session
        self.device_error = None

    def _stop_session(self):
        """Stop the window's session (the card synchronized first), export
        its trace under log_dir and return its Operator spans."""
        from ..observability.deviceprof import TRACE_SUFFIX
        from ..observability.kineto import Trace
        session, self._session = self._session, None
        try:
            if self._cuda:
                torch.cuda.synchronize(self._device)
        finally:
            session.stop()
        os.makedirs(self._log_dir, exist_ok=True)
        path = os.path.join(os.path.abspath(self._log_dir),
                            f"window_{os.getpid()}_{time.time_ns()}"
                            f"{TRACE_SUFFIX}")
        session.export_chrome_trace(path)
        self.last_trace = path
        spans = _operator_spans(Trace.from_file(path),
                                time.time_ns() - time.perf_counter_ns())
        if not self._with_flops:
            for rec in spans:
                rec.pop("_ref", None)
        return spans

    def _collect(self):
        _tracer.enabled = False
        _tracer.memory_device = None
        window = _tracer.drain()
        if self._session is not None:
            window = sorted(window + self._stop_session(),
                            key=lambda e: e["ts"])
        self._events.extend(window)       # cumulative, for statistics()
        self._window_events = window      # this window only, for export
        self._flush_timeline(window)
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def start(self):
        # one trace id for everything this window records, and for every
        # PS RPC issued under it; if we set it, stop() clears it. Ownership
        # keys on the PROCESS default, not current_trace_id(): a
        # thread-local trace_scope would mask the process slot
        self._owns_trace = _process_trace_id() is None
        _ensure_trace()
        self._last_t = time.perf_counter()
        self._transition(self._target_state())
        self._open_step_span()

    def stop(self):
        # timeline records are written per step() call only — stop() closes
        # a partial window that has no step duration to report
        self._close_step_span()
        if self._recording():
            self._collect()
        self._state = ProfilerState.CLOSED
        if getattr(self, "_owns_trace", False):
            _clear_trace()
            self._owns_trace = False

    def _open_step_span(self):
        self._step_rec = _tracer.begin(f"ProfileStep#{self._step}",
                                       TracerEventType.ProfileStep)

    def _close_step_span(self):
        _tracer.end(self._step_rec)
        self._step_rec = None

    def step(self, num_samples=None):
        now = time.perf_counter()
        dt = now - self._last_t if self._last_t is not None else None
        if dt is not None:
            self._step_times.append(dt)
            self._step_samples.append(num_samples)
        self._last_t = now
        step_rec = self._step_rec
        self._close_step_span()
        self._note_timeline_step(step_rec, dt, num_samples)
        self._step += 1
        self._transition(self._target_state())
        self._open_step_span()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ----------------------------------------------------------- timeline
    def _note_timeline_step(self, step_rec, dt, num_samples):
        """Keep the step that just closed (only while the window was
        recording) for its JSONL record, which the window's close writes
        once the session's ops are in."""
        if self._timeline_path is None or not self._recording():
            return
        t0 = step_rec["ts"] if step_rec is not None else None
        t1 = t0 + step_rec["dur"] if step_rec is not None else None
        self._pending.append({"step": self._step, "dt": dt,
                              "num_samples": num_samples, "t0": t0,
                              "t1": t1})

    def _flush_timeline(self, window):
        """One JSONL record per recorded step of the closing window."""
        from . import statistic as _stat
        pending, self._pending = self._pending, []
        if not pending:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self._timeline_path)),
                    exist_ok=True)
        with open(self._timeline_path, "a") as f:
            for p in pending:
                step_events = [
                    e for e in window
                    if e["type"] != TracerEventType.ProfileStep
                    and p["t0"] is not None and p["t0"] <= e["ts"] < p["t1"]]
                rec = {
                    "schema": STEP_TIMELINE_SCHEMA,
                    "step": p["step"],
                    "step_ms": None if p["dt"] is None
                    else round(p["dt"] * 1e3, 4),
                    "phases": _stat.phase_durations_ms(step_events),
                    "ops": _stat.op_digest(step_events, top=8),
                    "num_samples": p["num_samples"],
                }
                mem = [m for e in step_events
                       for m in (e.get("mem0"), e.get("mem1"))
                       if m is not None]
                rec["mem_peak_bytes"] = max(mem) if mem else None
                f.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------ reporting
    def step_info(self, unit=None):
        """Last-10-steps digest. `unit` labels throughput: with
        step(num_samples=...) provided, ips = samples/s in that unit
        (reference: profiler.py step_info's `unit`); else steps/s."""
        if not self._step_times:
            return ""
        arr = np.asarray(self._step_times[-10:])
        pairs = [(t, s) for t, s in zip(self._step_times[-10:],
                                        self._step_samples[-10:])
                 if s is not None]
        if unit and pairs:
            ips = sum(s for _, s in pairs) / sum(t for t, _ in pairs)
            return (f"avg step {arr.mean() * 1000:.2f} ms, "
                    f"ips {ips:.2f} {unit}/s")
        # without num_samples the only honest rate is steps/s — a unit
        # label here would caption steps/s as e.g. images/s
        return (f"avg step {arr.mean() * 1000:.2f} ms, "
                f"ips {1.0 / arr.mean():.2f} steps/s")

    def statistics(self):
        """Aggregate spans by name (reference: profiler_statistic.py)."""
        by_name = {}
        for e in self._events:
            by_name.setdefault(e["name"], []).append(e["dur"] or 0)
        rows = []
        for name, durs in by_name.items():
            d = np.asarray(durs, dtype=np.float64) / 1e6  # ms
            rows.append({"name": name, "calls": len(durs),
                         "total_ms": float(d.sum()), "avg_ms": float(d.mean()),
                         "max_ms": float(d.max()), "min_ms": float(d.min())})
        rows.sort(key=lambda r: -r["total_ms"])
        return rows

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None):
        """Print the summary tables (reference: profiler.py summary /
        profiler_statistic.py _build_table). `views`: a SummaryView value
        or list of them; default prints OverView + OperatorView (+
        DistributedView / MemoryView when comm spans / memory samples
        exist)."""
        from . import statistic as _stat
        text = _stat.build_summary(self._events, sorted_by=sorted_by,
                                   views=views, time_unit=time_unit)
        if text:
            print(text)
        elif not self._step_times:
            return
        if self._step_times:
            print(self.step_info())

    def analyze(self, device=None, top_k=3):
        """Join recorded Operator spans against the analytical roofline
        (cost_model/analytical.py): per-op achieved vs roofline time, the
        top-k MFU gap contributors, phase breakdown, and coverage of the
        recorded compute span time. `device`: a DeviceSpec or `DEVICES`
        name; by default the profiler's device picks it ("cpu" or
        "h100-sxm", unless `PADDLE_TPU_DEVICE_SPEC` names one). Returns
        statistic.AnalyzeReport."""
        from . import statistic as _stat
        return _stat.analyze(self._events, step_times=self._step_times,
                             device=self._device if device is None
                             else device, top_k=top_k)


class SortedKeys:
    """reference: profiler/profiler_statistic.py SortedKeys — summary sort
    orders. The Operator spans are host spans, so the GPU* keys alias
    their CPU counterparts (device time per op is the device profile's)."""
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView:
    """reference: profiler/profiler.py SummaryView — which summary tables
    to print."""
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8
