"""Stdlib-only reader of a `torch.profiler` chrome trace: the device half
of a capture.

Counterpart of `paddle_tpu/observability/xplane.py`. Where `jax.profiler`
writes the device timeline as an XSpace protobuf, `torch.profiler` (Kineto
over CUPTI) writes chrome-trace JSON through `prof.export_chrome_trace`:
one list of complete ("X") events, each with a category (`cat`), a start
and a duration in microseconds, a process and thread id and an `args`
dict. This module turns that file into the same shape the XSpace decoder
gives the device-profile parser:

  Trace.planes -> Plane(name, lines, device)   one per device, + the host
  Plane.lines  -> Line(name, events)           one per stream / thread
  Line.events  -> Event(name, cat, ts_ns, dur_ns, pid, tid, args)

Device events (`kernel`, `gpu_memcpy`, `gpu_memset`,
`gpu_user_annotation`) carry `args.device` and `args.stream`; they land on
the plane `/device:GPU:<device>`, one line per stream. Every other complete
event (`cpu_op`, `user_annotation`, `cuda_runtime`, `cuda_driver`,
`python_function`, ...) lands on the plane `/host:CPU`, one line per
thread. `ts_ns` counts from the trace's `baseTimeNanoseconds` (wall
clock), which `Trace.base_ns` keeps.

A file that is not such a trace (not JSON, truncated, no `traceEvents`
list, an event without a numeric start or duration) raises `DecodeError`
with the reason. Stdlib-only, so an offline tool can load it by file
path and read a capture without starting torch.
"""
import json

__all__ = ["Trace", "Plane", "Line", "Event", "DecodeError", "DEVICE_CATS"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")


class DecodeError(ValueError):
    """The bytes are not a parseable torch.profiler chrome trace."""


class Event:
    __slots__ = ("name", "cat", "ts_ns", "dur_ns", "pid", "tid", "args")

    def __init__(self, name, cat, ts_ns, dur_ns, pid, tid, args):
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.pid = pid
        self.tid = tid
        self.args = args

    @property
    def correlation(self):
        return self.args.get("correlation")

    @property
    def stream(self):
        return self.args.get("stream")

    @property
    def device(self):
        return self.args.get("device")

    def __repr__(self):
        return (f"Event({self.name!r}, cat={self.cat!r}, ts_ns={self.ts_ns}, "
                f"dur_ns={self.dur_ns})")


class Line:
    __slots__ = ("name", "events")

    def __init__(self, name, events):
        self.name = name
        self.events = events

    def __repr__(self):
        return f"Line({self.name!r}, {len(self.events)} events)"


class Plane:
    __slots__ = ("name", "lines", "device")

    def __init__(self, name, lines, device):
        self.name = name
        self.lines = lines
        self.device = device          # the GPU index, None for the host

    def __repr__(self):
        return f"Plane({self.name!r}, {len(self.lines)} lines)"


def _ns(v, what, i):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise DecodeError(f"event {i}: {what}={v!r} is not a number")
    return int(round(v * 1000.0))


def _event(raw, i):
    args = raw.get("args")
    if not isinstance(args, dict):
        args = {}
    return Event(str(raw.get("name", "")), str(raw.get("cat", "")),
                 _ns(raw.get("ts"), "ts", i), max(_ns(raw.get("dur"), "dur",
                                                       i), 0),
                 raw.get("pid"), raw.get("tid"), args)


class Trace:
    """The complete events of one chrome trace, grouped into planes."""

    __slots__ = ("planes", "events", "base_ns", "device_properties")

    def __init__(self, events, base_ns=0, device_properties=()):
        self.events = events
        self.base_ns = base_ns
        # the GPUs the session traced (empty for a host-only session)
        self.device_properties = list(device_properties)
        device = {}                   # device -> {stream: [events]}
        host = {}                     # (pid, tid) -> [events]
        for ev in events:
            if ev.cat in DEVICE_CATS:
                dev = ev.device if ev.device is not None else ev.pid
                stream = ev.stream if ev.stream is not None else ev.tid
                device.setdefault(dev, {}).setdefault(stream, []).append(ev)
            else:
                host.setdefault((ev.pid, ev.tid), []).append(ev)
        planes = []
        for dev in sorted(device, key=str):
            lines = [Line(f"stream {s}", sorted(evs, key=lambda e: e.ts_ns))
                     for s, evs in sorted(device[dev].items(),
                                          key=lambda kv: str(kv[0]))]
            planes.append(Plane(f"/device:GPU:{dev}", lines, dev))
        if host:
            lines = [Line(f"thread {tid}", sorted(evs, key=lambda e: e.ts_ns))
                     for (_, tid), evs in sorted(host.items(),
                                                 key=lambda kv: str(kv[0]))]
            planes.append(Plane("/host:CPU", lines, None))
        self.planes = planes

    @classmethod
    def from_dict(cls, data):
        if not isinstance(data, dict):
            raise DecodeError(f"trace is {type(data).__name__}, not an "
                              "object")
        raw = data.get("traceEvents")
        if not isinstance(raw, list):
            raise DecodeError("no traceEvents list")
        for i, r in enumerate(raw):
            if not isinstance(r, dict):
                raise DecodeError(f"event {i} is {type(r).__name__}, not "
                                  "an object")
        events = [_event(r, i) for i, r in enumerate(raw)
                  if r.get("ph") == "X"]
        base = data.get("baseTimeNanoseconds", 0)
        if isinstance(base, bool) or not isinstance(base, int):
            base = 0
        props = data.get("deviceProperties")
        return cls(events, base, props if isinstance(props, list) else ())

    @classmethod
    def from_bytes(cls, data):
        if not data:
            raise DecodeError("empty trace")
        try:
            parsed = json.loads(data)
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise DecodeError(f"not JSON: {e}") from None
        return cls.from_dict(parsed)

    @classmethod
    def from_file(cls, path):
        with open(path, "rb") as f:
            data = f.read()
        try:
            return cls.from_bytes(data)
        except DecodeError as e:
            raise DecodeError(f"{path}: {e}") from None

    def __repr__(self):
        return f"Trace({[p.name for p in self.planes]})"
