"""Flight recorder: a bounded ring of recent spans + a hang/crash
postmortem dumper.

Counterpart of `paddle_tpu/observability/flight_recorder.py`, copied; the
postmortem schema (`paddle_tpu.postmortem.v1`) and the environment names
stay. While enabled it keeps the last N closed spans of the port's host
tracer (`paddle_tpu_torch.profiler`: the serving prefill, decode, retire,
preempt and fault spans). On a hang (armed watchdog deadline), a crash
(SIGTERM), or an explicit call it writes a postmortem JSON artifact
containing:

  - every thread's current python stack (`sys._current_frames`),
  - the span ring + the open spans of every thread,
  - a full snapshot of the port's metrics registry plus counter deltas
    since enable().

Stdlib-only with no imports of the package at module level: the tracer
and the registry are found through sys.modules under the port's own
module names, so a process that loaded both packages never reads the JAX
package's tracer or registry.
"""
import collections
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback

__all__ = ["FlightRecorder", "POSTMORTEM_SCHEMA", "enable", "get",
           "dump_postmortem", "annotate", "thread_stacks"]

POSTMORTEM_SCHEMA = "paddle_tpu.postmortem.v1"
DEFAULT_DIR_ENV = "PADDLE_TPU_POSTMORTEM_DIR"
# Bounded dump retention: each successful dump sweeps the directory down
# to the newest KEEP artifacts, so a crash-looping or watchdog-happy
# process can never grow ./postmortem without bound. 0 disables the
# sweep.
DEFAULT_KEEP_ENV = "PADDLE_TPU_POSTMORTEM_KEEP"
DEFAULT_KEEP = 20


def _tracer():
    """The profiler's host tracer IF the package is loaded (sys.modules
    lookup only — a standalone flight recorder must not import it)."""
    mod = sys.modules.get("paddle_tpu_torch.profiler")
    return getattr(mod, "_tracer", None)


def _registry():
    mod = sys.modules.get("paddle_tpu_torch.observability.metrics")
    return mod.registry() if mod is not None else None


def _flatten(snap):
    mod = sys.modules.get("paddle_tpu_torch.observability.metrics")
    return mod.flatten_snapshot(snap) if mod is not None else {}


def thread_stacks():
    """[{thread_id, name, daemon, stack: [frame strings]}] for every live
    thread — the postmortem's "who is stuck where"."""
    names = {t.ident: (t.name, t.daemon) for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        name, daemon = names.get(tid, ("?", None))
        out.append({"thread_id": tid, "name": name, "daemon": daemon,
                    "stack": [ln.rstrip("\n") for ln in
                              traceback.format_stack(frame)]})
    return out


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _compact_span(rec):
    out = {"name": rec.get("name"), "type": rec.get("type"),
           "tid": rec.get("tid"), "ts": rec.get("ts"),
           "dur": rec.get("dur"), "depth": rec.get("depth"),
           "trace": rec.get("trace"), "span_id": rec.get("span_id"),
           "parent": rec.get("parent")}
    attrs = rec.get("attrs")
    if attrs:
        out["attrs"] = {k: _json_safe(v) for k, v in attrs.items()}
    return out


class FlightRecorder:
    """One ring + one watchdog thread + the dump path."""

    def __init__(self, capacity=512, dir=None, keep_dumps=None):
        self.ring = collections.deque(maxlen=int(capacity))
        self.dir = dir or os.environ.get(DEFAULT_DIR_ENV, "./postmortem")
        if keep_dumps is None:
            keep_dumps = int(os.environ.get(DEFAULT_KEEP_ENV, DEFAULT_KEEP))
        self.keep_dumps = max(0, int(keep_dumps))
        self.last_dump_path = None
        self.annotations = {}               # key -> json-safe state note
        self._baseline = None               # flattened metrics at enable()
        self._enabled = False
        self._watchdogs = {}                # token -> (deadline, what, cb)
        self._tokens = itertools.count(1)
        self._lock = threading.Lock()
        self._watch_thread = None
        self._stop = threading.Event()
        self._prev_sigterm = None

    # ------------------------------------------------------------ lifecycle
    def enable(self, install_signal_handler=False):
        """Attach to the host tracer (closed spans start landing in the
        ring even while the profiler is CLOSED) and baseline the metrics
        for delta reporting. Optionally hook SIGTERM -> dump-then-die."""
        tr = _tracer()
        if tr is not None:
            tr.ring = self
        reg = _registry()
        if reg is not None:
            try:
                self._baseline = _flatten(reg.snapshot())
            except Exception:                                # noqa: BLE001
                self._baseline = None
        self._enabled = True
        if install_signal_handler:
            self.install_signal_handler()
        return self

    def disable(self):
        tr = _tracer()
        if tr is not None and tr.ring is self:
            tr.ring = None
        self._enabled = False
        self._stop.set()
        if self._prev_sigterm is not None and \
                threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except (ValueError, OSError):
                pass
            self._prev_sigterm = None

    @property
    def enabled(self):
        return self._enabled

    # -------------------------------------------------------------- feeding
    def record_span(self, rec):
        """Called by _HostTracer.end for every closed span; deque.append
        with maxlen is atomic under the GIL, so no lock on this path."""
        self.ring.append(_compact_span(rec))

    def spans(self):
        return list(self.ring)

    def annotate(self, key, value):
        """Attach/overwrite a named state note that rides every future
        postmortem dump — how in-flight orchestration (e.g. an armed
        deviceprof capture) stays visible when the run wedges before it
        completes."""
        with self._lock:
            self.annotations[key] = _json_safe(value)

    def annotations_snapshot(self):
        """A consistent copy of the annotations (read under the lock —
        the fleet postmortem bundle reads them from the SLO watchdog's
        breach path while other threads may still be annotating)."""
        with self._lock:
            return dict(self.annotations)

    # ------------------------------------------------------------- watchdog
    def arm(self, timeout_s, what="operation", on_fire=None):
        """Start a hang deadline; returns a token for disarm(). On expiry
        the watchdog thread dumps a postmortem and then calls
        `on_fire(path)` (which may os._exit — the artifact is already on
        disk)."""
        token = next(self._tokens)
        with self._lock:
            self._watchdogs[token] = (time.monotonic() + float(timeout_s),
                                      what, on_fire)
            if self._watch_thread is None or not self._watch_thread.is_alive():
                self._stop.clear()
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, name="flight-recorder-watchdog",
                    daemon=True)
                self._watch_thread.start()
        return token

    def disarm(self, token):
        with self._lock:
            self._watchdogs.pop(token, None)

    class _Deadline:
        def __init__(self, fr, timeout_s, what, on_fire):
            self._fr, self._args = fr, (timeout_s, what, on_fire)
            self._token = None

        def __enter__(self):
            self._token = self._fr.arm(*self._args)
            return self

        def __exit__(self, *exc):
            self._fr.disarm(self._token)
            return False

    def deadline(self, timeout_s, what="operation", on_fire=None):
        """`with recorder.deadline(30, "ps pull"):` — scoped watchdog."""
        return FlightRecorder._Deadline(self, timeout_s, what, on_fire)

    def _watch_loop(self):
        while not self._stop.wait(0.05):
            fired = []
            now = time.monotonic()
            with self._lock:
                for token, (dl, what, cb) in list(self._watchdogs.items()):
                    if now >= dl:
                        fired.append((what, cb))
                        del self._watchdogs[token]
            for what, cb in fired:
                path = self.dump(f"watchdog: {what} exceeded its deadline")
                if cb is not None:
                    try:
                        cb(path)
                    except Exception:                        # noqa: BLE001
                        pass

    # -------------------------------------------------------------- signals
    def install_signal_handler(self):
        """SIGTERM -> write the postmortem, then chain to the previous
        handler (or re-raise the default death). Main thread only."""
        if threading.current_thread() is not threading.main_thread():
            return False

        def handler(signum, frame):
            self.dump(f"signal {signum} (SIGTERM)")
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)
            elif prev != signal.SIG_IGN:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, handler)
        except (ValueError, OSError):
            return False
        return True

    # ----------------------------------------------------------------- dump
    def open_spans(self):
        """Every thread's currently-open span stack, read cross-thread
        from the tracer's per-tid stacks (racy by design: a postmortem
        reader wants best-effort truth, not a lock a wedged thread might
        hold)."""
        tr = _tracer()
        if tr is None:
            return []
        out = []
        for tid, stack in list(getattr(tr, "_stacks", {}).items()):
            for rec in list(stack):
                out.append(_compact_span(rec))
        return out

    def dump(self, reason):
        """Write the postmortem artifact; returns its path. Must succeed
        from ANY thread at ANY moment — everything inside is best-effort
        and failures degrade to nulls, never to a second crash."""
        doc = {"schema": POSTMORTEM_SCHEMA, "reason": str(reason),
               "time": time.time(), "pid": os.getpid(),
               "argv": list(sys.argv)}
        try:
            doc["threads"] = thread_stacks()
        except Exception as e:                               # noqa: BLE001
            doc["threads"] = []
            doc["threads_error"] = repr(e)
        doc["spans"] = self.spans()
        doc["open_spans"] = self.open_spans()
        with self._lock:
            doc["annotations"] = dict(self.annotations)
        reg = _registry()
        if reg is not None:
            try:
                doc["metrics"] = reg.snapshot()
                if self._baseline is not None:
                    now = _flatten(doc["metrics"])
                    doc["metric_deltas"] = {
                        k: v - self._baseline.get(k, 0.0)
                        for k, v in now.items()
                        if v != self._baseline.get(k, 0.0)}
            except Exception as e:                           # noqa: BLE001
                doc["metrics"] = None
                doc["metrics_error"] = repr(e)
        else:
            doc["metrics"] = None
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(
            self.dir, f"postmortem_{os.getpid()}_{int(time.time() * 1e3)}"
            ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)               # atomic: no torn artifacts
        self.last_dump_path = path
        self._sweep_old_dumps(keep=path)
        return path

    def _sweep_old_dumps(self, keep=None):
        """Retention: unlink the oldest postmortem artifacts (and any
        stale .tmp torn by a crash mid-write) past `keep_dumps`, newest
        first by mtime. Best-effort like everything on the dump path —
        a sweep failure must never cost the dump that triggered it."""
        if self.keep_dumps <= 0:
            return
        try:
            entries = []
            now = time.time()
            for name in os.listdir(self.dir):
                full = os.path.join(self.dir, name)
                if name.startswith("postmortem_") and name.endswith(".tmp") \
                        and full != (keep or "") + ".tmp":
                    # torn artifact from a crash — but only if STALE: a
                    # fresh .tmp may be another process's in-flight dump,
                    # and unlinking it would make that os.replace raise
                    try:
                        if now - os.path.getmtime(full) > 60.0:
                            os.unlink(full)
                    except OSError:
                        pass
                    continue
                if not (name.startswith("postmortem_")
                        and name.endswith(".json")):
                    continue
                try:
                    entries.append((os.path.getmtime(full), full))
                except OSError:
                    continue
            entries.sort(reverse=True)      # newest first
            for _, full in entries[self.keep_dumps:]:
                if full == keep:
                    continue                # never sweep the fresh dump
                try:
                    os.unlink(full)
                except OSError:
                    pass
        except OSError:
            pass


_recorder = None
_recorder_lock = threading.Lock()


def get():
    """The process recorder (created lazily, NOT enabled)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def enable(capacity=512, dir=None, install_signal_handler=False):
    """Create/refresh the process recorder and attach it."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder(capacity=capacity, dir=dir)
        else:
            if dir:
                _recorder.dir = dir
            if capacity != _recorder.ring.maxlen:
                _recorder.ring = collections.deque(
                    _recorder.ring, maxlen=int(capacity))
    return _recorder.enable(install_signal_handler=install_signal_handler)


def dump_postmortem(reason):
    """One-call postmortem: dumps through the process recorder (enabling
    a bare one on the spot if nothing was set up)."""
    return get().dump(reason)


def annotate(key, value):
    """One-call state note on the process recorder (see
    FlightRecorder.annotate)."""
    get().annotate(key, value)
