"""Numerics health plane: tensor sentinels inside the captured executables,
a host-side detector, and a NaN bisection localizer.

Counterpart of `paddle_tpu/observability/numerics.py`. The site names,
`STATS_FIELDS`, `ANOMALY_KINDS`, the detector's rules and the families
`numerics_anomaly_total{site,kind}` and `numerics_site_finite_frac{site}`
are the reference's.

* **Taps.**  ``tap(site, x)`` computes one fixed-shape stats vector,
  ``[finite_frac, absmax, rms, sat_frac]`` (float32 [4]), from torch
  tensors and records it in the ambient *sink*.  An engine opens a
  ``sink_scope()`` inside the function of an executable and returns the
  sink with its outputs, so on the card the stats are computed inside the
  captured CUDA graph and read back with the step's own host read.
* **Arming contract.**  Taps are armed when the engine is built
  (``EngineConfig(numerics_taps=True)``).  With no sink open, ``tap`` is
  one attribute probe and touches no tensor, so a disarmed engine
  captures the same graphs, with the same kernels, as an engine without
  the plane.
* **Per-layer taps are the localizer's tool.**  ``tap_layer(i, ...)``
  sites sit at every block boundary of the GPT's cached forward and fire
  only under an explicit layer filter (``sink_scope(layers=...)``).  When
  the detector latches a nonfinite anomaly, the engine replays the step
  eagerly through per-layer probes and names the first unhealthy layer.
* **Host-side detector.**  ``NumericsMonitor`` keeps rolling median/MAD
  baselines per site and latches anomalies (``nonfinite`` / ``drift`` /
  ``saturation``) into the registry, a flight-recorder annotation and
  (once) a postmortem bundle.

Integer tensors (int8 KV codes, int8 weight codes) are all finite; their
stats never make a float32 copy: each leaf is squared in an int16 copy
(|code| <= 128, so squares fit) and summed in int64, so the sum of
squares and the saturated count are exact.  Float sums of squares
accumulate in float64.  The fractions divide float32 counts, as the
reference's means do.

Import contract: stdlib only at import time; torch and numpy are
imported inside the helpers that use them.
"""

import collections
import math
import statistics
import threading

from . import flight_recorder as _flight_recorder
from . import metrics as _metrics

__all__ = [
    "STATS_FIELDS", "ANOMALY_KINDS",
    "tap", "tap_layer", "tap_tree", "sink_scope", "null_scope",
    "stats_vector", "tree_stats_vector", "np_stats", "np_tree_stats",
    "stats_dict", "stats_unhealthy",
    "NumericsMonitor", "bisect_first_unhealthy",
    "set_monitor", "get_monitor", "observe", "observe_tree",
]

# one fixed-shape vector per site; the LAST slot is only nonzero for taps
# armed with a saturation threshold (int8 codes)
STATS_FIELDS = ("finite_frac", "absmax", "rms", "sat_frac")
ANOMALY_KINDS = ("nonfinite", "drift", "saturation")

_C_ANOMALY = _metrics.counter(
    "numerics_anomaly_total",
    "Latched numerics anomalies, by tap site and kind "
    "(nonfinite/drift/saturation)",
    labelnames=("site", "kind"))
_G_FINITE = _metrics.gauge(
    "numerics_site_finite_frac",
    "Finite fraction of the most recent observation at each tap site "
    "(1.0 == healthy)",
    labelnames=("site",))

# ---------------------------------------------------------------------------
# the sink

_TLS = threading.local()


class sink_scope:
    """Arm the tap plane for the dynamic extent of an executable's
    function (its eager run, its capture or a localizer probe) and
    collect ``{site: float32 [4] tensor}`` in ``scope.stats``.  Nested
    scopes shadow the outer one.

    ``layers`` controls the per-layer ``tap_layer`` sites: ``None``
    (default) leaves them dormant, ``"all"`` arms every layer, and an
    iterable of ints arms exactly those layer indices: the knob the
    localizer turns.
    """

    def __init__(self, layers=None):
        self.stats = {}
        if layers is None or layers == "all":
            self._layers = layers
        else:
            self._layers = frozenset(int(i) for i in layers)
        self._prev = None

    def __enter__(self):
        self._prev = (getattr(_TLS, "sink", None),
                      getattr(_TLS, "layers", None))
        _TLS.sink = self.stats
        _TLS.layers = self._layers
        return self.stats

    def __exit__(self, *exc):
        _TLS.sink, _TLS.layers = self._prev
        return False


class null_scope:
    """Context manager for the disarmed arm: yields None, touches no
    state, so call sites write ``with self._numerics_scope() as sink``
    unconditionally."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def tap(site, x, sat_threshold=None):
    """Record the stats vector of tensor ``x`` under ``site`` in the
    ambient sink; one attribute probe when no sink is open."""
    sink = getattr(_TLS, "sink", None)
    if sink is None:
        return
    sink[site] = stats_vector(x, sat_threshold)


def tap_layer(index, name, x):
    """Per-layer tap (``layer<i>.<name>``): fires only when the ambient
    scope armed a layer filter covering ``index``."""
    sink = getattr(_TLS, "sink", None)
    if sink is None:
        return
    layers = getattr(_TLS, "layers", None)
    if layers is None:
        return
    index = int(index)
    if layers != "all" and index not in layers:
        return
    sink[f"layer{index}.{name}"] = stats_vector(x)


def _leaves(tree):
    """The tensors of a nested dict / list / tuple, in traversal order."""
    from torch.utils._pytree import tree_leaves
    return [leaf for leaf in tree_leaves(tree) if hasattr(leaf, "dtype")]


def tap_tree(site, tree, sat_threshold=None):
    """One stats vector across every tensor of a nested structure (the
    pools' scales and codes, the int8 weights, the adapter rows); rms is
    the global root-mean-square over all elements."""
    sink = getattr(_TLS, "sink", None)
    if sink is None:
        return
    leaves = _leaves(tree)
    if not leaves:
        return
    sink[site] = tree_stats_vector(leaves, sat_threshold)


# ---------------------------------------------------------------------------
# the stats math on torch tensors (inside the executables)

def _float_parts(x, sat_threshold):
    """(elements, finite count, absmax, sum of squares, saturated count
    or None) of one float tensor, the last four 0-d tensors on its
    device: about seven kernels."""
    import torch
    xf = x if x.dtype == torch.float32 else x.to(torch.float32)
    finite = torch.isfinite(xf)
    safe = torch.where(finite, xf, 0.0)
    absmax = torch.linalg.vector_norm(safe, float("inf"))
    sumsq = torch.sum(torch.square(safe), dtype=torch.float64)
    sat = None
    if sat_threshold is not None:
        sat = torch.count_nonzero(torch.abs(xf) >= float(sat_threshold))
    return x.numel(), torch.count_nonzero(finite), absmax, sumsq, sat


def _int8_parts(leaves, sat_threshold):
    """The same parts over int8 tensors, which are all finite. Each leaf
    is squared in an int16 copy (|code| <= 128, so the squares are exact)
    and summed in int64; the per-leaf results are stacked and combined
    once, so a leaf costs six kernels and no float copy."""
    import torch
    sumsq, peak, sat = [], [], []
    thr = None if sat_threshold is None else float(sat_threshold)
    for x in leaves:
        sq = x.to(torch.int16)
        sq.mul_(sq)
        sumsq.append(torch.sum(sq, dtype=torch.int64))
        peak.append(torch.amax(sq))
        if thr is not None:
            sat.append(torch.count_nonzero(sq >= thr * thr) if thr > 0
                       else torch.full((), sq.numel(), dtype=torch.int64,
                                       device=sq.device))
    n = sum(x.numel() for x in leaves)
    absmax = torch.sqrt(torch.stack(peak).amax().to(torch.float32))
    total = torch.stack(sumsq).sum().to(torch.float64)
    return (n, n, absmax, total,
            torch.stack(sat).sum() if sat else None)


def _combine(parts, recip):
    """The [4] vector from the parts. The fractions are float32 counts
    over the element count: a division for a list of tensors, a product
    with the float32 reciprocal for one tensor, as the reference's sum and
    mean round them."""
    import torch
    n = sum(p[0] for p in parts)
    dev = parts[0][2].device

    def add(a, b):
        return a if b is None else (b if a is None else a + b)
    fin = sat = sumsq = absmax = None
    for _, f, a, ss, st in parts:
        fin, sumsq, sat = add(fin, f), add(sumsq, ss), add(sat, st)
        absmax = a if absmax is None else torch.maximum(absmax, a)

    def frac(count):
        if not torch.is_tensor(count):
            count = torch.full((), count, dtype=torch.float32, device=dev)
        count = count.to(torch.float32)
        # tensor operands: a true division (a CUDA division by a python
        # scalar multiplies by its reciprocal)
        if recip:
            return count * torch.full((), 1.0 / n, dtype=torch.float32,
                                      device=dev)
        return count / torch.full((), float(n), dtype=torch.float32,
                                  device=dev)
    rms = torch.sqrt(sumsq / n).to(torch.float32)
    sat = frac(sat) if sat is not None else \
        torch.zeros((), dtype=torch.float32, device=dev)
    return torch.stack([frac(fin), absmax.to(torch.float32), rms, sat])


def tree_stats_vector(leaves, sat_threshold=None):
    """``[finite_frac, absmax, rms, sat_frac]`` (float32 [4]) over a list
    of tensors.  Non-finite elements are masked out of absmax and rms, so
    a NaN shows in finite_frac without poisoning the magnitude channels
    the drift baseline reads.  Float leaves are flattened into one tensor
    first (they are small: scales, adapter rows), int8 leaves are reduced
    one by one."""
    import torch
    leaves = [x for x in leaves if x.numel()]
    if not leaves:
        return torch.zeros((4,), dtype=torch.float32)
    ints = [x for x in leaves if x.dtype == torch.int8]
    floats = [x for x in leaves if x.dtype != torch.int8]
    parts = []
    if floats:
        flat = floats[0] if len(floats) == 1 else torch.cat(
            [x.reshape(-1).to(torch.float32) for x in floats])
        parts.append(_float_parts(flat, sat_threshold))
    if ints:
        parts.append(_int8_parts(ints, sat_threshold))
    return _combine(parts, recip=False)


def stats_vector(x, sat_threshold=None):
    """``[finite_frac, absmax, rms, sat_frac]`` of one tensor (float32
    [4] on its device); see ``tree_stats_vector``."""
    import torch
    if not x.numel():
        return torch.zeros((4,), dtype=torch.float32)
    parts = _int8_parts([x], sat_threshold) if x.dtype == torch.int8 \
        else _float_parts(x, sat_threshold)
    return _combine([parts], recip=True)


# ---------------------------------------------------------------------------
# host-side (numpy) stats for eager paths: the host tier's requantization

def np_stats(x, sat_threshold=None):
    """Host-side twin of ``stats_vector``: a plain [4] float list."""
    import numpy as np
    a = np.asarray(x, dtype=np.float32)
    if a.size == 0:
        return [1.0, 0.0, 0.0, 0.0]
    finite = np.isfinite(a)
    safe = np.where(finite, a, 0.0)
    sat = 0.0
    if sat_threshold is not None:
        sat = float(np.mean(np.abs(a) >= float(sat_threshold)))
    return [float(np.mean(finite)),
            float(np.max(np.abs(safe))),
            float(np.sqrt(np.mean(np.square(safe)))),
            sat]


def np_tree_stats(arrays, sat_threshold=None):
    """Host-side twin of ``tree_stats_vector``."""
    import numpy as np
    n = 0
    fin = 0.0
    absmax = 0.0
    sumsq = 0.0
    sat = 0.0
    for arr in arrays:
        a = np.asarray(arr, dtype=np.float32)
        if a.size == 0:
            continue
        finite = np.isfinite(a)
        safe = np.where(finite, a, 0.0)
        n += a.size
        fin += float(np.sum(finite))
        absmax = max(absmax, float(np.max(np.abs(safe))))
        sumsq += float(np.sum(np.square(safe)))
        if sat_threshold is not None:
            sat += float(np.sum(np.abs(a) >= float(sat_threshold)))
    n = max(n, 1)
    return [fin / n, absmax, math.sqrt(sumsq / n), sat / n]


def stats_dict(vec):
    """[4] vector -> {field: float} for reports and bundles."""
    return {k: float(v) for k, v in zip(STATS_FIELDS, vec)}


def stats_unhealthy(vec, sat_frac_max=0.25):
    """Structural health predicate on a stats vector (no baseline
    needed) — what the bisection localizer evaluates per probe."""
    ff, absmax, rms, sat = (float(v) for v in vec)
    if not (math.isfinite(ff) and math.isfinite(absmax)
            and math.isfinite(rms)):
        return True
    return ff < 1.0 or sat > float(sat_frac_max)


# ---------------------------------------------------------------------------
# the online detector

class NumericsMonitor:
    """Rolling median/MAD baselines per site + anomaly latching.

    ``observe(site, vec)`` classifies one stats vector:

    * ``nonfinite``  — finite_frac < 1 (or a non-finite stats slot)
    * ``saturation`` — sat_frac above ``sat_frac_max``
    * ``drift``      — |rms - median| > drift_mads * MAD, once the site
      has ``min_history`` healthy observations (MAD is floored so a
      perfectly-constant baseline still admits noise)

    Every anomaly latches ``numerics_anomaly_total{site,kind}`` and a
    flight-recorder annotation; with ``auto_bundle`` the FIRST anomaly
    also dumps a postmortem bundle.  Engines pass ``auto_bundle=False``
    so they can run the bisection localizer first and bundle a record
    that already names the guilty layer.
    """

    def __init__(self, window=64, min_history=8, drift_mads=10.0,
                 sat_frac_max=0.25, auto_bundle=True):
        self.window = int(window)
        self.min_history = int(min_history)
        self.drift_mads = float(drift_mads)
        self.sat_frac_max = float(sat_frac_max)
        self.auto_bundle = bool(auto_bundle)
        self.anomalies = []           # [{site, kind, detail, stats}]
        self.bundle_path = None
        self._hist = {}               # site -> deque of healthy rms
        self._last = {}               # site -> stats dict
        self._counts = collections.Counter()
        self._bundled = False
        self._lock = threading.Lock()

    # -- observation ------------------------------------------------------

    def observe(self, site, vec):
        """Classify one [4] stats vector for ``site``; returns the list
        of anomaly kinds latched by THIS observation (empty == healthy).
        """
        ff, absmax, rms, sat = (float(v) for v in vec)
        found = []
        with self._lock:
            self._last[site] = {"finite_frac": ff, "absmax": absmax,
                                "rms": rms, "sat_frac": sat}
            _G_FINITE.labels(site=site).set(ff if math.isfinite(ff)
                                            else 0.0)
            if not math.isfinite(ff) or ff < 1.0 \
                    or not math.isfinite(rms):
                found.append(("nonfinite", f"finite_frac={ff:.6g}"))
            if sat > self.sat_frac_max:
                found.append(("saturation",
                              f"sat_frac={sat:.4g} > {self.sat_frac_max}"))
            hist = self._hist.setdefault(
                site, collections.deque(maxlen=self.window))
            if math.isfinite(rms) and not found:
                if len(hist) >= self.min_history:
                    med = statistics.median(hist)
                    mad = statistics.median(abs(h - med) for h in hist)
                    scale = max(mad, 1e-3 * max(abs(med), 1e-6))
                    if abs(rms - med) > self.drift_mads * scale:
                        found.append((
                            "drift",
                            f"rms={rms:.6g} vs median={med:.6g} "
                            f"(mad={mad:.3g})"))
                    else:
                        hist.append(rms)   # only healthy values extend
                else:                      # the baseline
                    hist.append(rms)
            for kind, detail in found:
                self._latch(site, kind, detail)
        return [kind for kind, _ in found]

    def observe_sink(self, sink, prefix=""):
        """Feed a whole traced-program sink ({site: vec}) through the
        detector.  Returns [(site, kind)] for anomalies latched now."""
        import numpy as np
        new = []
        for site in sorted(sink):
            vec = np.asarray(sink[site], dtype=np.float32)
            for kind in self.observe(prefix + site, vec):
                new.append((prefix + site, kind))
        return new

    def _latch(self, site, kind, detail):
        # caller holds self._lock
        self._counts[(site, kind)] += 1
        _C_ANOMALY.labels(site=site, kind=kind).inc()
        rec = {"site": site, "kind": kind, "detail": detail,
               "stats": dict(self._last.get(site) or {})}
        self.anomalies.append(rec)
        _flight_recorder.annotate("numerics", {
            "anomalies": len(self.anomalies),
            "last": rec,
            "counts": {f"{s}:{k}": n
                       for (s, k), n in sorted(self._counts.items())},
        })
        if self.auto_bundle and not self._bundled:
            self._bundled = True
            self.bundle_path = _flight_recorder.dump_postmortem(
                f"numerics:{site}:{kind}")

    def bundle(self, reason):
        """Dump the one-shot postmortem bundle now (idempotent).  The
        engine calls this AFTER localization so the bundle carries the
        localizer's annotation."""
        with self._lock:
            if not self._bundled:
                self._bundled = True
                self.bundle_path = _flight_recorder.dump_postmortem(reason)
        return self.bundle_path

    # -- reporting --------------------------------------------------------

    def total(self):
        with self._lock:
            return sum(self._counts.values())

    def counts(self):
        with self._lock:
            return {f"{site}:{kind}": n
                    for (site, kind), n in sorted(self._counts.items())}

    def site_stats(self):
        with self._lock:
            return {site: dict(st) for site, st in self._last.items()}

    def report(self):
        with self._lock:
            return {
                "anomalies": sum(self._counts.values()),
                "counts": {f"{s}:{k}": n
                           for (s, k), n in sorted(self._counts.items())},
                "sites": {site: dict(st)
                          for site, st in self._last.items()},
                "bundle": self.bundle_path,
            }


# ---------------------------------------------------------------------------
# bisection

def bisect_first_unhealthy(n_layers, unhealthy_at):
    """Smallest layer index whose tap is unhealthy, or None when even
    the last layer is clean.  ``unhealthy_at(k)`` must be monotone in k
    (true stays true once corruption appears — NaN/Inf propagate
    forward through the stack), which a per-layer activation tap
    satisfies.  O(log n) probe evaluations plus the initial guard."""
    n_layers = int(n_layers)
    if n_layers <= 0 or not unhealthy_at(n_layers - 1):
        return None
    lo, hi = 0, n_layers - 1          # invariant: unhealthy_at(hi) True
    while lo < hi:
        mid = (lo + hi) // 2
        if unhealthy_at(mid):
            hi = mid
        else:
            lo = mid + 1
    return hi


# ---------------------------------------------------------------------------
# process-global monitor for host-side observation points (the host
# tier's requantization).  Disabled by default: with no monitor
# installed, observe() is one global read, at no cost on hot paths.

_MONITOR = None


def set_monitor(monitor):
    """Install (or, with None, remove) the process-global monitor.
    Returns the previous one so callers can restore it."""
    global _MONITOR
    prev = _MONITOR
    _MONITOR = monitor
    return prev


def get_monitor():
    return _MONITOR


def observe(site, x, sat_threshold=None):
    """Host-side observation point: no-op without a process monitor."""
    if _MONITOR is None:
        return None
    return _MONITOR.observe(site, np_stats(x, sat_threshold))


def observe_tree(site, arrays, sat_threshold=None):
    """Host-side observation over a list of arrays (global norms)."""
    if _MONITOR is None:
        return None
    return _MONITOR.observe(site, np_tree_stats(arrays, sat_threshold))
