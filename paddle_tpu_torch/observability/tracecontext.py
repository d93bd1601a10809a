"""Dapper-style trace context: ids, propagation, and chrome-trace merging.

Counterpart of `paddle_tpu/observability/tracecontext.py`, copied. A
*trace* is one causally-linked unit of work (a serving request, a train
step); a *span* is one timed region inside it. The host tracer
(`paddle_tpu_torch.profiler`) stamps every span with (trace_id, span_id,
parent_span_id); the 24-byte wire context (`pack_ctx`) is the one the
JAX package's RPC frames carry, so a mixed fleet shares trace ids, and
`merge_chrome_traces` folds per-process chrome exports into one timeline.

Id model (Dapper / W3C traceparent proportions):
  trace_id  — 16 random bytes (32 hex chars), one per causal unit
  span_id   —  8 random bytes (16 hex chars), one per span

Propagation: a thread-local scope (`trace_scope`) overrides a
process-level default (`ensure_trace`); `current_trace_id()` returns None
when neither is set, the signal not to spend wire bytes on propagation.

Stdlib-only.
"""
import json
import os
import struct
import threading

__all__ = ["new_trace_id", "new_span_id", "current_trace_id",
           "ensure_trace", "clear_trace", "trace_scope", "WIRE_FLAG",
           "CTX_WIRE_BYTES", "pack_ctx", "unpack_ctx",
           "merge_chrome_traces"]

# Header-flag bit a PS RPC frame sets when a trace context follows the
# fixed header. Op codes stay < 0x80, so flagged frames are unambiguous
# and unflagged peers interoperate unchanged.
WIRE_FLAG = 0x80
_CTX = struct.Struct("<16s8s")           # trace_id bytes | span_id bytes
CTX_WIRE_BYTES = _CTX.size


def new_trace_id():
    return os.urandom(16).hex()


def new_span_id():
    return os.urandom(8).hex()


_tls = threading.local()
_process_trace_id = None
_lock = threading.Lock()


def current_trace_id():
    """Innermost active trace id: thread-local scope, else the process
    default, else None (= do not propagate)."""
    tid = getattr(_tls, "trace_id", None)
    return tid if tid is not None else _process_trace_id


def process_trace_id():
    """The process-level default alone (ignores thread-local scopes) —
    what Profiler start/stop checks to decide ensure/clear ownership."""
    return _process_trace_id


def ensure_trace(trace_id=None):
    """Set (or keep) the process-level default trace id; returns it.
    Profiler.start calls this so every span of a profiled window — and
    every RPC issued under it, in every process it touches — shares one
    trace."""
    global _process_trace_id
    with _lock:
        if trace_id is not None:
            _process_trace_id = trace_id
        elif _process_trace_id is None:
            _process_trace_id = new_trace_id()
        return _process_trace_id


def clear_trace():
    global _process_trace_id
    with _lock:
        _process_trace_id = None


class trace_scope:
    """Thread-local trace override: `with trace_scope() as tid:` starts a
    fresh trace for this thread; pass an existing id to join one."""

    def __init__(self, trace_id=None):
        self.trace_id = trace_id or new_trace_id()
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "trace_id", None)
        _tls.trace_id = self.trace_id
        return self.trace_id

    def __exit__(self, *exc):
        _tls.trace_id = self._prev
        return False


def pack_ctx(trace_id, span_id):
    """24 wire bytes for (trace_id hex, span_id hex)."""
    return _CTX.pack(bytes.fromhex(trace_id), bytes.fromhex(span_id))


def unpack_ctx(raw):
    """(trace_id hex, span_id hex) from 24 wire bytes."""
    t, s = _CTX.unpack(raw)
    return t.hex(), s.hex()


# ---------------------------------------------------------------- merging

def merge_chrome_traces(paths, out_path=None):
    """Merge per-process chrome-trace JSON files (export_chrome_tracing
    output) into ONE causally-linked view:

      - every event keeps its own pid lane;
      - per-file `otherData.clock_sync_ns` (epoch minus the process's
        perf_counter origin, stamped at export) rebases each file's
        timestamps onto the shared wall clock, so client and server
        spans line up;
      - for each span whose `parent_span_id` names a span recorded by a
        DIFFERENT process, a chrome flow arrow (ph 's' -> 'f') is added
        from parent to child.

    Returns the merged trace dict; writes it to `out_path` if given.
    """
    events = []
    for path in paths:
        with open(path) as f:
            doc = json.load(f)
        sync_us = doc.get("otherData", {}).get("clock_sync_ns", 0) / 1e3
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = ev["ts"] + sync_us
            events.append(ev)

    by_span = {}
    for ev in events:
        sid = (ev.get("args") or {}).get("span_id")
        if sid and ev.get("ph") == "X":
            by_span[sid] = ev

    flows = []
    for ev in events:
        args = ev.get("args") or {}
        parent_id = args.get("parent_span_id")
        if not parent_id:
            continue
        parent = by_span.get(parent_id)
        if parent is None or parent.get("pid") == ev.get("pid"):
            continue            # same-process nesting renders by lane depth
        flow_id = int(args["span_id"][:8], 16)
        flows.append({"ph": "s", "cat": "xproc", "name": "rpc",
                      "id": flow_id, "pid": parent["pid"],
                      "tid": parent["tid"], "ts": parent["ts"]})
        flows.append({"ph": "f", "bp": "e", "cat": "xproc", "name": "rpc",
                      "id": flow_id, "pid": ev["pid"], "tid": ev["tid"],
                      "ts": ev["ts"]})

    # rebase so the merged view starts near t=0 (chrome renders huge
    # epoch-µs offsets poorly); metadata events carry no ts
    stamped = [e for e in events + flows if "ts" in e]
    if stamped:
        t0 = min(e["ts"] for e in stamped)
        for e in stamped:
            e["ts"] -= t0
    merged = {"traceEvents": events + flows, "displayTimeUnit": "ms"}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged
