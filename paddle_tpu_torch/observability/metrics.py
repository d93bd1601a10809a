"""Framework-wide metrics registry: Counter / Gauge / Histogram with labels.

Counterpart of `paddle_tpu/observability/metrics.py`, copied (the port
imports nothing of the JAX package, not even its stdlib-only modules).
The snapshot schema `paddle_tpu.metrics.v1` and every family name stay as
they are, so `tools/metrics_report.py` renders, validates and compares
the port's snapshots against the JAX package's by name. The default
registry of the port is its own: only the port's producers (the serving
scheduler, the block pool, the prefix cache, the speculative engine, the
fault sites) report to it.

Design points:
  - one shared value lock per registry: `snapshot()` is consistent
    across every metric, and an `inc()` costs one lock acquire
  - zero-cost when disabled: every mutation checks `registry.enabled`
    before touching the lock
  - two exposition formats from the same snapshot: the schema-versioned
    JSONL stream (`write_snapshot`) and the Prometheus text format
    (`dump_prometheus`)
  - collectors: callables registered via `register_collector(fn)` run
    at snapshot time to publish pull-style values

Stdlib-only: the flight recorder reads metrics from a process whose
device init wedged.
"""
import json
import os
import re
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "SNAPSHOT_SCHEMA", "DEFAULT_BUCKETS", "registry", "counter",
           "gauge", "histogram", "flatten_snapshot",
           "prometheus_from_snapshot"]

SNAPSHOT_SCHEMA = "paddle_tpu.metrics.v1"

# Prometheus default buckets, trimmed at the top: nothing in this stack
# legitimately takes minutes, and a 60s observation should saturate +Inf
# loudly rather than vanish into a wide bucket.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Child:
    """One (metric, label-values) time series."""

    __slots__ = ("_reg",)

    def __init__(self, reg):
        self._reg = reg


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, reg):
        super().__init__(reg)
        self.value = 0.0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError(f"counters only go up (inc({amount}))")
        reg = self._reg
        if not reg.enabled:
            return
        with reg._value_lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self, reg):
        super().__init__(reg)
        self.value = 0.0

    def set(self, value):
        reg = self._reg
        if not reg.enabled:
            return
        with reg._value_lock:
            self.value = float(value)

    def inc(self, amount=1):
        reg = self._reg
        if not reg.enabled:
            return
        with reg._value_lock:
            self.value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def set_to_max(self, value):
        """Peak tracking: keep the running maximum (HBM high-water mark)."""
        reg = self._reg
        if not reg.enabled:
            return
        with reg._value_lock:
            if value > self.value:
                self.value = float(value)


class _HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, reg, buckets):
        super().__init__(reg)
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        reg = self._reg
        if not reg.enabled:
            return
        value = float(value)
        i = 0
        for b in self.buckets:
            if value <= b:
                break
            i += 1
        with reg._value_lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


class _Metric:
    """One named metric family; children keyed by label-value tuples."""

    kind = None

    def __init__(self, reg, name, help, labelnames):
        self._reg = reg
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children = {}
        if not self.labelnames:
            self._default = self._new_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(labelvalues)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._reg._value_lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _require_default(self):
        if self._default is None:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.labelnames}; "
                f"use .labels(...)")
        return self._default

    def _sample_rows(self):
        """[(labels_dict, child)] — stable order for exposition."""
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in sorted(self._children.items())]


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._reg)

    def inc(self, amount=1):
        self._require_default().inc(amount)

    @property
    def value(self):
        return self._require_default().value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._reg)

    def set(self, value):
        self._require_default().set(value)

    def inc(self, amount=1):
        self._require_default().inc(amount)

    def dec(self, amount=1):
        self._require_default().dec(amount)

    def set_to_max(self, value):
        self._require_default().set_to_max(value)

    @property
    def value(self):
        return self._require_default().value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, reg, name, help, labelnames, buckets=None):
        self.buckets = tuple(sorted(float(b) for b in
                                    (buckets or DEFAULT_BUCKETS)))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(reg, name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self._reg, self.buckets)

    def observe(self, value):
        self._require_default().observe(value)


class MetricsRegistry:
    """Named-metric registry with get-or-create semantics: calling
    `counter(name, ...)` twice returns the SAME family (so instrumentation
    sites stay import-order independent), and re-registering a name as a
    different kind is a loud error."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self._metrics = {}
        self._collectors = []
        # both locks REENTRANT: the flight recorder's SIGTERM handler may
        # dump (snapshot -> collectors -> gauge()) on a main thread whose
        # interrupted frame already holds one of them — a plain Lock would
        # turn a clean kill into the evidence-free hang this stack exists
        # to prevent
        self._lock = threading.RLock()       # metric/collector registration
        self._value_lock = threading.RLock()  # every child mutation

    # ------------------------------------------------------------ lifecycle
    def enable(self):
        self.enabled = True

    def disable(self):
        """Hot paths see one False attribute load; nothing else runs."""
        self.enabled = False

    def reset(self):
        """Zero every value (families/labels stay registered) — tests."""
        with self._value_lock:
            for m in self._metrics.values():
                for child in m._children.values():
                    if isinstance(child, _HistogramChild):
                        child.counts = [0] * len(child.counts)
                        child.sum, child.count = 0.0, 0
                    else:
                        child.value = 0.0

    # --------------------------------------------------------- registration
    def _get_or_create(self, cls, name, help, labelnames, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r} (want Prometheus-style "
                f"[a-zA-Z_:][a-zA-Z0-9_:]*)")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {cls.kind}")
                if tuple(labelnames) != m.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{m.labelnames}, requested {tuple(labelnames)}")
                return m
            m = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()):
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def register_collector(self, fn):
        """`fn(registry)` runs before every snapshot to publish pull-style
        values; exceptions are swallowed (a broken collector must never
        take down the run it is observing)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def unregister_collector(self, fn):
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # ------------------------------------------------------------- snapshot
    def snapshot(self):
        """One consistent read of every metric (collectors run first,
        OUTSIDE the value lock — they may create/set metrics)."""
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:                                # noqa: BLE001
                pass
        out = []
        # registration lock first (stable family list even while another
        # thread first-creates a metric), then the value lock (consistent
        # values) — same order _get_or_create->labels uses, so no deadlock
        with self._lock:
            families = sorted(self._metrics.items())
        with self._value_lock:
            for name, m in families:
                samples = []
                for labels, child in m._sample_rows():
                    if isinstance(child, _HistogramChild):
                        cum, acc = {}, 0
                        for b, c in zip(m.buckets, child.counts):
                            acc += c
                            cum[repr(float(b))] = acc
                        cum["+Inf"] = acc + child.counts[-1]
                        samples.append({"labels": labels, "buckets": cum,
                                        "sum": child.sum,
                                        "count": child.count})
                    else:
                        samples.append({"labels": labels,
                                        "value": child.value})
                out.append({"name": m.name, "type": m.kind, "help": m.help,
                            "labelnames": list(m.labelnames),
                            "samples": samples})
        return {"schema": SNAPSHOT_SCHEMA, "ts": time.time(),
                "pid": os.getpid(), "metrics": out}

    def write_snapshot(self, path):
        """Append one snapshot line to a JSONL stream; returns the dict."""
        snap = self.snapshot()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(snap) + "\n")
        return snap

    def dump_prometheus(self):
        """Prometheus text exposition (# HELP / # TYPE / samples) from one
        consistent snapshot."""
        return prometheus_from_snapshot(self.snapshot())


def prometheus_from_snapshot(snap):
    """Prometheus text exposition for any metrics.v1 snapshot dict — the
    registry's own `dump_prometheus` and the fleet federator's MERGED
    snapshot (observability.fleet) share this one renderer, so a fleet
    exposition can never drift from the single-process format."""
    lines = []
    for m in snap["metrics"]:
        if m["help"]:
            lines.append(f"# HELP {m['name']} {m['help']}")
        lines.append(f"# TYPE {m['name']} {m['type']}")
        for s in m["samples"]:
            lab = _prom_labels(s["labels"])
            if m["type"] == "histogram":
                for le, c in s["buckets"].items():
                    blab = _prom_labels(dict(s["labels"], le=le))
                    lines.append(f"{m['name']}_bucket{blab} {c}")
                lines.append(f"{m['name']}_sum{lab} {_fmt(s['sum'])}")
                lines.append(f"{m['name']}_count{lab} {s['count']}")
            else:
                lines.append(f"{m['name']}{lab} {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def _fmt(v):
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _prom_labels(labels):
    if not labels:
        return ""
    body = ",".join(
        f'{k}="' + str(v).replace("\\", r"\\").replace('"', r"\"") + '"'
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


def flatten_snapshot(snap, kinds=("counter", "gauge")):
    """{ 'name{k=v,...}': value } for scalar metrics — the comparison key
    space of tools/metrics_report.py and the flight recorder's deltas."""
    out = {}
    for m in snap.get("metrics", []):
        if m["type"] not in kinds:
            continue
        for s in m["samples"]:
            labels = s.get("labels") or {}
            key = m["name"]
            if labels:
                key += "{" + ",".join(f"{k}={labels[k]}"
                                      for k in sorted(labels)) + "}"
            out[key] = s["value"]
    return out


_default_registry = MetricsRegistry()


def registry():
    """The process-default registry every framework subsystem reports to."""
    return _default_registry


def counter(name, help="", labelnames=()):
    return _default_registry.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()):
    return _default_registry.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=None):
    return _default_registry.histogram(name, help, labelnames,
                                       buckets=buckets)
