"""The host half of the profiler: span recorder, RecordEvent, chrome export.

Counterpart of `paddle_tpu/profiler/__init__.py:92-345`: `_HostTracer`
and its module singleton `_tracer`, `TracerEventType`, `RecordEvent` and
`export_chrome_tracing`. The fault sites and the flight recorder find
`_tracer` through `sys.modules["paddle_tpu_torch.profiler"]`, so the
port's spans never land in the JAX package's tracer.

Where the JAX `RecordEvent` also opens a `jax.profiler.TraceAnnotation`,
the port's opens `torch.profiler.record_function(name)`, and only while
a torch profiler is recording: a profiled serving step then shows
`serving::decode_step` and its siblings on the card's timeline, and an
unprofiled step pays only for the host tracer, one attribute load when
the tracer is closed and no flight recorder is attached. The tracer
samples no device memory (the JAX `_live_bytes`).

`Profiler`, `make_scheduler`, `SummaryView` and the statistics tables
come with the device profile (ROADMAP A.12).
"""
import json
import os
import threading
import time

import torch

from ..observability.tracecontext import (
    current_trace_id as _current_trace_id, new_span_id as _new_span_id,
)

__all__ = ["RecordEvent", "TracerEventType", "export_chrome_tracing"]


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
    there, including spans recorded while the tracer is closed."""

    def __init__(self):
        self.enabled = False
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
    """Returns a handler that writes a list of span records (a window of
    the tracer's events, `_tracer.drain()`) as chrome://tracing JSON and
    returns the file's path.

    Each (thread, nesting depth) gets its own tid lane with thread_name
    metadata, so nested spans render stacked. Every span's args carry its
    trace_id/span_id/parent_span_id, and the file's otherData carries
    clock_sync_ns (wall-clock epoch minus this process's perf_counter
    origin): what `observability.merge_chrome_traces` needs to fold the
    per-process exports of a distributed run into one timeline. The JAX
    handler takes its `Profiler` and exports the last record window; the
    port's profiler windows come with A.12."""
    def handler(window):
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
        return path
    return handler
