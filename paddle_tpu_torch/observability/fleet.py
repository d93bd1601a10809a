"""Fleet observability plane: metrics federation + SLO watchdog.

Counterpart of `paddle_tpu/observability/fleet.py`, copied (stdlib plus
the port's registry and flight recorder); the merged snapshot keeps
schema `paddle_tpu.metrics.v1` and the bundle schema is unchanged, so
the repo's tools read the port's fleet files as they read the JAX
package's.

Every serving process keeps its own metrics registry, which dies with
the process. This module is the live fleet view:

  merge_snapshots(members)
      Folds N per-process `paddle_tpu.metrics.v1` snapshots into ONE
      consistent fleet snapshot. Every series is re-labeled with
      `worker_id`/`role`; counters and histograms additionally get a
      fleet aggregate series (worker_id/role = "_fleet") — counter
      values sum, histogram buckets merge BUCKET-WISE (cumulative counts
      stay cumulative, `+Inf` stays == count), so fleet-level p99s fall
      straight out of `tools/metrics_report.py`'s quantile math. Gauges
      stay per-worker only: summing occupancies across hosts is a lie.
      The merged snapshot keeps schema `paddle_tpu.metrics.v1`, so the
      whole offline toolchain (render/validate/--compare) works on fleet
      files unchanged.

  BurnRateWatchdog
      Online SLO judgment from a stream of (federated) snapshots.
      Each SLO is either a latency objective over a histogram ("<=
      `threshold_s` for `objective` of observations") or a failure-ratio
      objective over counters. Burn rate over a window = (bad fraction
      in the window) / (1 - objective): burn 1.0 means the error budget
      is being consumed exactly as fast as allowed; >> 1 means an
      incident. Two windows (fast + slow, the classic multi-window
      alert) must BOTH burn past `burn_threshold` for `sustain`
      consecutive observations before the fleet is declared degraded —
      a single slow request can't page, a sustained breach can't hide.
      Exports `serving_slo_burn{slo,window,tenant}` and `serving_slo_degraded`
      gauges; fires `on_breach(details)` once per degraded episode.

  FleetPlane
      The router-side pump: polls every live worker's full registry over
      the read-only OP_METRICS verb (plus the router's own registry as
      member "router"), merges, appends the merged snapshot to a
      `fleet_metrics.jsonl` stream, feeds the watchdog, and renders one
      merged Prometheus exposition. On a sustained SLO breach it
      annotates the router's flight recorder and pulls every surviving
      worker's postmortem dump over OP_DUMP into one fleet postmortem
      bundle (schema `paddle_tpu.fleet_postmortem.v1`): a directory with
      `bundle.json` (reason, burn figures, router annotations, member
      index) plus one `<worker_id>.json` postmortem per reachable
      worker. `DistFrontend.pump()` drives `maybe_poll()` automatically
      once a plane is attached.

This module is stdlib-only (the snapshots are plain dicts); only
FleetPlane touches the serving clients, and only through duck-typed
`metrics(i)` / `dump(i)` calls.
"""
import collections
import json
import os
import re
import time

from . import flight_recorder as _fr
from . import metrics as _metrics

__all__ = ["FLEET_LABEL", "ALL_TENANTS", "BUNDLE_SCHEMA",
           "merge_snapshots", "SLO", "default_slos", "per_tenant_slos",
           "prime_tenant_series", "BurnRateWatchdog", "FleetPlane"]

# worker_id/role value of the fleet-aggregate series in a merged snapshot
FLEET_LABEL = "_fleet"
BUNDLE_SCHEMA = "paddle_tpu.fleet_postmortem.v1"
_WID_PAT = re.compile(r"worker_id=([^,}]+)")

_M_BURN = _metrics.gauge(
    "serving_slo_burn",
    "Online SLO burn rate (bad fraction per window / error budget); "
    "1.0 = consuming budget exactly as fast as allowed. tenant=_all "
    "for fleet-wide SLOs, else the tenant the SLO is scoped to",
    labelnames=("slo", "window", "tenant"))

# tenant label value of SLOs judging the whole fleet (no tenant scope)
ALL_TENANTS = "_all"
_M_DEGRADED = _metrics.gauge(
    "serving_slo_degraded",
    "1 while the fleet is in a sustained SLO breach (fast AND slow "
    "windows burning past threshold), else 0 — failure-class on flip "
    "in tools/metrics_report.py")


# ------------------------------------------------------------- federation

def _label_key(labels):
    return tuple(sorted(labels.items()))


def merge_snapshots(members, ts=None, pid=None):
    """One fleet snapshot from per-process ones.

    `members`: [{"worker_id": str, "role": str, "snapshot": metrics.v1
    dict}, ...]. Series keep their original labels plus `worker_id` and
    `role`; counter/histogram series additionally aggregate into a
    worker_id="_fleet" series per original label set (bucket-wise for
    histograms — and only when every member agrees on the bucket edges;
    a mismatched family keeps its per-worker series but drops the
    aggregate rather than summing incomparable buckets)."""
    fams = {}                           # name -> merged family dict
    for mem in members:
        wid = str(mem["worker_id"])
        role = str(mem.get("role") or "?")
        for fam in mem["snapshot"].get("metrics", []):
            f = fams.get(fam["name"])
            if f is None:
                f = fams[fam["name"]] = {
                    "name": fam["name"], "type": fam["type"],
                    "help": fam.get("help", ""),
                    "labelnames": list(fam.get("labelnames", []))
                    + ["worker_id", "role"],
                    "samples": [], "_agg": {}}
            elif f["type"] != fam["type"]:
                # same name, different kind across members: unmergeable —
                # keep the first kind's series, skip this member's
                continue
            for s in fam["samples"]:
                labels = dict(s.get("labels") or {})
                row = dict(s)
                row["labels"] = dict(labels, worker_id=wid, role=role)
                f["samples"].append(row)
                key = _label_key(labels)
                if fam["type"] == "counter":
                    agg = f["_agg"].setdefault(key, {
                        "labels": dict(labels, worker_id=FLEET_LABEL,
                                       role=FLEET_LABEL), "value": 0.0})
                    agg["value"] += float(s["value"])
                elif fam["type"] == "histogram":
                    agg = f["_agg"].get(key)
                    if agg is None:
                        f["_agg"][key] = {
                            "labels": dict(labels, worker_id=FLEET_LABEL,
                                           role=FLEET_LABEL),
                            "buckets": dict(s["buckets"]),
                            "sum": float(s["sum"]),
                            "count": int(s["count"])}
                    elif agg.get("_skip"):
                        pass
                    elif set(agg["buckets"]) != set(s["buckets"]):
                        agg["_skip"] = True    # incomparable edges
                    else:
                        for edge, c in s["buckets"].items():
                            agg["buckets"][edge] += c
                        agg["sum"] += float(s["sum"])
                        agg["count"] += int(s["count"])
    metrics_out = []
    for name in sorted(fams):
        f = fams[name]
        aggs = [dict(a) for k, a in sorted(f.pop("_agg").items())
                if not a.pop("_skip", False)]
        f["samples"] = f["samples"] + aggs
        metrics_out.append(f)
    if ts is None:
        ts = max((m["snapshot"].get("ts", 0) for m in members),
                 default=time.time()) or time.time()
    return {"schema": _metrics.SNAPSHOT_SCHEMA, "ts": float(ts),
            "pid": int(pid if pid is not None else os.getpid()),
            "metrics": metrics_out}


def _flat(snap, kinds=("counter", "gauge")):
    return _metrics.flatten_snapshot(snap, kinds=kinds)


# ---------------------------------------------------------------- the SLOs

class SLO:
    """One serving objective.

    kind="latency": `hist` is a histogram family; an observation is BAD
    when it exceeds `threshold_s` (judged from the cumulative bucket at
    the largest edge <= threshold). `objective` is the good fraction
    (0.99 = "99% of observations under threshold").

    kind="failure": `bad` is a tuple of regexes over flattened counter
    keys (fleet-aggregate rows) whose sum counts failure events; `total`
    a regex tuple for the event denominator. objective 0.99 = "at most
    1% of events may fail".

    `tenant` scopes the SLO to ONE tenant's label slice:
    only histogram samples / counter series carrying tenant=<value>
    contribute, and the burn gauge exports as
    `serving_slo_burn{slo,window,tenant}` — the per-tenant isolation
    gate ROADMAP item 5 rides on. tenant=None judges every series
    (exported under tenant="_all")."""

    def __init__(self, name, kind="latency", hist=None, threshold_s=None,
                 objective=0.99, bad=(), total=(), tenant=None):
        if kind not in ("latency", "failure"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and (not hist or threshold_s is None):
            raise ValueError("latency SLO needs hist= and threshold_s=")
        if kind == "failure" and (not bad or not total):
            raise ValueError("failure SLO needs bad= and total= patterns")
        self.name = str(name)
        self.kind = kind
        self.hist = hist
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.objective = float(objective)
        self.budget = max(1.0 - self.objective, 1e-9)
        self.bad = tuple(re.compile(p) for p in bad)
        self.total = tuple(re.compile(p) for p in total)
        self.tenant = None if tenant is None else str(tenant)
        self._tenant_pat = None if tenant is None else re.compile(
            r"[{,]tenant=" + re.escape(self.tenant) + r"[,}]")

    @property
    def key(self):
        """Unique series key inside a watchdog: two SLOs may share a
        NAME (the gauge label) while judging different tenants."""
        return self.name if self.tenant is None \
            else f"{self.name}@{self.tenant}"

    def _in_scope(self, labels):
        return self.tenant is None or \
            (labels or {}).get("tenant") == self.tenant

    def _hist_bad_total(self, s):
        good = 0
        best_edge = None
        for edge, c in s["buckets"].items():
            if edge == "+Inf":
                continue
            e = float(edge)
            if e <= self.threshold_s and \
                    (best_edge is None or e > best_edge):
                best_edge, good = e, c
        return float(s["count"] - good), float(s["count"])

    def sample_members(self, snap):
        """{member_id: (bad_cum, total_cum)} cumulative event counts
        PER FLEET MEMBER from one (merged) snapshot; a raw
        single-process snapshot yields one "_solo" member. The watchdog
        differences these per member — NOT the fleet aggregate — so a
        member dying (its cumulative counts vanishing from the merge)
        or restarting (counts resetting to zero) cannot drive the
        fleet-wide delta negative and silently zero the burn rate
        during exactly the incident the watchdog exists to catch."""
        out = {}
        if self.kind == "latency":
            for m in snap.get("metrics", []):
                if m["name"] != self.hist or m["type"] != "histogram":
                    continue
                for s in m["samples"]:
                    labels = s.get("labels") or {}
                    wid = labels.get("worker_id", "_solo")
                    if wid == FLEET_LABEL:
                        continue           # aggregates would double-count
                    if not self._in_scope(labels):
                        continue           # another tenant's series
                    # zero-count samples still record: first sight at
                    # (0, 0) means the member's entire burst since
                    # attach counts as delta, not baseline
                    bad, total = self._hist_bad_total(s)
                    b0, t0 = out.get(wid, (0.0, 0.0))
                    out[wid] = (b0 + bad, t0 + total)
            return out
        for key, v in _flat(snap, kinds=("counter",)).items():
            m = _WID_PAT.search(key)
            wid = m.group(1) if m else "_solo"
            if wid == FLEET_LABEL:
                continue
            if self._tenant_pat is not None and \
                    not self._tenant_pat.search(key):
                continue                   # another tenant's series
            is_bad = any(p.search(key) for p in self.bad)
            is_total = any(p.search(key) for p in self.total)
            if not (is_bad or is_total):
                continue
            b0, t0 = out.get(wid, (0.0, 0.0))
            out[wid] = (b0 + (v if is_bad else 0.0),
                        t0 + (v if is_total else 0.0))
        return out


def default_slos(ttft_s=1.0, decode_step_s=0.5, latency_objective=0.99,
                 failure_objective=0.999):
    """The fleet defaults: TTFT and decode-step latency objectives over
    the scheduler histograms, and a failure-class ratio (errors,
    timeouts, router failovers, swap drops) over admitted requests."""
    return (
        SLO("ttft", hist="serving_ttft_seconds", threshold_s=ttft_s,
            objective=latency_objective),
        SLO("decode_step", hist="serving_decode_step_seconds",
            threshold_s=decode_step_s, objective=latency_objective),
        SLO("failures", kind="failure", objective=failure_objective,
            bad=(r"^serving_requests_total\{.*status=(error|timeout)",
                 r"^serving_failover_total",
                 r"^serving_decode_failures_total",
                 r"^serving_swap_dropped_requests_total"),
            total=(r"^serving_requests_total\{.*status=admitted",)),
    )


def prime_tenant_series(tenants, registry=None):
    """Create the zero-valued tenant-labeled children the per-tenant
    SLOs read, BEFORE a watchdog takes its baseline observation. Label
    children are created lazily on first use — without priming, a fresh
    tenant's series would first appear in the post-traffic snapshot,
    which the watchdog's first-sight-is-baseline rule would swallow
    whole (exactly the burst the caller wants judged). A (0, 0) sample
    in the baseline makes the whole burst a DELTA instead. Idempotent;
    tenants with existing history are untouched."""
    reg = registry or _metrics.registry()
    hist = reg.histogram("serving_ttft_seconds", labelnames=("tenant",))
    requests = reg.counter("serving_requests_total",
                           labelnames=("status", "tenant"))
    shed = reg.counter("serving_shed_total", labelnames=("tenant",))
    # the KV residency plane rides the same priming rule: a
    # tenant's serving_kv_blocks{tenant,kind} children exist at zero in
    # the merged fleet snapshot before its first block lands, so a
    # dashboard join over tenants never sees a hole
    kv_blocks = reg.gauge("serving_kv_blocks",
                          labelnames=("tenant", "kind"))
    kv_bytes = reg.gauge("serving_kv_bytes",
                         labelnames=("tenant", "kind"))
    for t in tenants:
        hist.labels(tenant=t)
        shed.labels(tenant=t)
        for status in ("admitted", "error", "timeout"):
            requests.labels(status=status, tenant=t)
        for kind in ("private", "shared", "cached", "host", "disk"):
            kv_blocks.labels(tenant=t, kind=kind)
            kv_bytes.labels(tenant=t, kind=kind)


def per_tenant_slos(tenants, ttft_s=1.0, latency_objective=0.99,
                    failure_objective=0.999, include_fleet=True):
    """The per-tenant labelset: one TTFT SLO and one failure-ratio SLO
    PER TENANT (each scoped to that tenant's label slice — shed and
    errored requests count against the tenant they belong to), plus the
    fleet-wide defaults. Feeding these to a BurnRateWatchdog makes
    `serving_slo_burn{slo,window,tenant}` live — the isolation gate of
    ROADMAP item 5 ("tenant A's burst cannot move tenant B's p99 TTFT")
    is then one threshold comparison over these gauges."""
    slos = list(default_slos(ttft_s=ttft_s,
                             latency_objective=latency_objective,
                             failure_objective=failure_objective)) \
        if include_fleet else []
    for t in tenants:
        slos.append(SLO("ttft", hist="serving_ttft_seconds",
                        threshold_s=ttft_s,
                        objective=latency_objective, tenant=t))
        # sheds count in the DENOMINATOR too: a window where every one
        # of a tenant's requests is shed at admission must read as max
        # burn (bad == total), not divide-by-zero-quietly-0.0 — the
        # total-denial scenario is exactly what the isolation gate is
        # for
        slos.append(SLO(
            "failures", kind="failure", objective=failure_objective,
            tenant=t,
            bad=(r"^serving_requests_total\{.*status=(error|timeout)",
                 r"^serving_shed_total"),
            total=(r"^serving_requests_total\{.*status=admitted",
                   r"^serving_shed_total")))
    return tuple(slos)


class BurnRateWatchdog:
    """Multi-window burn-rate evaluation over a snapshot stream.

    Feed every federated snapshot to `observe()`; per SLO it
    differences each member's cumulative counts against that member's
    previous sample (first sight = baseline, a reset clamps to zero, a
    dead member stops contributing — see SLO.sample_members), folds the
    monotone deltas into its own cumulative (bad, total) series,
    differences THAT over the fast and slow windows, and publishes
    `serving_slo_burn{slo,window,tenant}` (tenant="_all" for
    unscoped SLOs). The fleet is DEGRADED while at least
    one SLO burns past `burn_threshold` on BOTH windows for `sustain`
    consecutive observations (`serving_slo_degraded` = 1); the first
    observation that establishes a degraded episode fires `on_breach`
    exactly once (latched until the fleet recovers)."""

    def __init__(self, slos=None, fast_window_s=60.0, slow_window_s=600.0,
                 burn_threshold=1.0, sustain=2, clock=time.monotonic,
                 registry=None, on_breach=None):
        self.slos = tuple(slos if slos is not None else default_slos())
        if not self.slos:
            raise ValueError("need at least one SLO")
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.sustain = max(1, int(sustain))
        self._clock = clock
        self.on_breach = on_breach
        reg = registry or _metrics.registry()
        self._g_burn = reg.gauge("serving_slo_burn", _M_BURN.help,
                                 labelnames=("slo", "window", "tenant"))
        self._g_degraded = reg.gauge("serving_slo_degraded",
                                     _M_DEGRADED.help)
        # keyed by slo.key, not name: per-tenant SLOs share a NAME (the
        # gauge label) while tracking separate series
        self._series = {s.key: collections.deque() for s in self.slos}
        if len(self._series) != len(self.slos):
            raise ValueError("duplicate SLO (name, tenant) pairs")
        # per-member previous cumulative samples + the watchdog's OWN
        # monotone cumulative sums (see observe): member churn/restart
        # can never drive a window delta negative
        self._prev = {s.key: {} for s in self.slos}
        self._cum = {s.key: [0.0, 0.0] for s in self.slos}
        self._breach_streak = 0
        self._breached = False            # latched for this episode
        self.degraded = False
        self.last_burn = {}               # {slo: {fast, slow}}

    def _window_burn(self, slo, series, now, window_s):
        """Burn over [now - window_s, now]: delta bad / delta total
        against the newest sample at least `window_s` old (or the oldest
        available — a young watchdog judges what it has seen)."""
        cur = series[-1]
        cutoff = now - window_s
        base = None
        # newest-first: the base is the first sample at least window_s
        # old, so the scan only walks the in-window samples instead of
        # the (up to 2x slow-window) history behind the base
        for t, b, tot in reversed(series):
            if t <= cutoff:
                base = (t, b, tot)
                break
        if base is None:
            base = series[0]
        dbad = cur[1] - base[1]
        dtotal = cur[2] - base[2]
        if dtotal <= 0:
            return 0.0
        return (dbad / dtotal) / slo.budget

    def observe(self, snap):
        """Ingest one merged snapshot; returns {slo: {fast, slow}}."""
        now = self._clock()
        burns = {}
        candidate = False
        for slo in self.slos:
            series = self._series[slo.key]
            # per-member monotone differencing: a member first seen is a
            # baseline (its history predates this watchdog), a member
            # whose counts DROPPED restarted (delta clamps to 0 for that
            # round), and a vanished member simply stops contributing —
            # the accumulated (bad, total) sums only ever grow, so the
            # window deltas below stay meaningful through host death,
            # exactly when they matter most
            prev = self._prev[slo.key]
            cum = self._cum[slo.key]
            for wid, (b, t) in slo.sample_members(snap).items():
                pb, pt = prev.get(wid, (None, None))
                if pb is not None:
                    cum[0] += max(0.0, b - pb)
                    cum[1] += max(0.0, t - pt)
                prev[wid] = (b, t)
            bad, total = cum
            series.append((now, bad, total))
            horizon = now - 2.0 * self.slow_window_s
            while len(series) > 2 and series[1][0] < horizon:
                series.popleft()
            fast = self._window_burn(slo, series, now, self.fast_window_s)
            slow = self._window_burn(slo, series, now, self.slow_window_s)
            burns[slo.key] = {"fast": fast, "slow": slow}
            tenant = slo.tenant if slo.tenant is not None else ALL_TENANTS
            self._g_burn.labels(slo=slo.name, window="fast",
                                tenant=tenant).set(fast)
            self._g_burn.labels(slo=slo.name, window="slow",
                                tenant=tenant).set(slow)
            if min(fast, slow) >= self.burn_threshold:
                candidate = True
        self.last_burn = burns
        if candidate:
            self._breach_streak += 1
        else:
            self._breach_streak = 0
            self._breached = False
        self.degraded = self._breach_streak >= self.sustain
        self._g_degraded.set(1.0 if self.degraded else 0.0)
        if self.degraded and not self._breached:
            self._breached = True
            details = {"burn": burns, "threshold": self.burn_threshold,
                       "sustain": self.sustain, "ts": time.time()}
            if self.on_breach is not None:
                try:
                    self.on_breach(details)
                except Exception:                        # noqa: BLE001
                    pass                  # judgment must not kill serving
        return burns


# ---------------------------------------------------------------- the plane

class FleetPlane:
    """The router's federation pump (see module docstring). Attaches
    itself to `frontend` so `DistFrontend.pump()` drives `maybe_poll()`
    without bespoke wiring; `poll_now()` is the explicit hook for tests
    and final flushes."""

    def __init__(self, frontend, jsonl_path=None, poll_interval_s=1.0,
                 watchdog=None, postmortem_dir=None, include_router=True,
                 clock=time.monotonic):
        self.frontend = frontend
        self.jsonl_path = jsonl_path
        self.poll_interval_s = float(poll_interval_s)
        self.postmortem_dir = postmortem_dir
        self.include_router = bool(include_router)
        self._clock = clock
        self._last_poll_t = None
        self.last_merged = None
        self.last_members = []
        self.last_bundle = None           # newest fleet postmortem dir
        self.polls = 0
        self.watchdog = watchdog or BurnRateWatchdog()
        if self.watchdog.on_breach is None:
            self.watchdog.on_breach = self.on_breach
        frontend.fleet_plane = self

    # -- member collection ---------------------------------------------------
    def _pool_members(self, client, indexes, prefix):
        out = []
        for i in indexes:
            try:
                reply = client.metrics(i)
            except Exception:                            # noqa: BLE001
                continue                  # dark worker: skip this round
            out.append({"worker_id": f"{prefix}{i}",
                        "role": reply.get("role", prefix),
                        "endpoint": client.endpoints[i],
                        "snapshot": reply["snapshot"]})
        return out

    def members(self):
        """One OP_METRICS sweep over every live worker (+ the router's
        own registry, so router-side series — failover counts, burn
        gauges, router TTFT — federate too)."""
        fe = self.frontend
        out = self._pool_members(fe.decode, fe.live_decode_workers(),
                                 "decode")
        if fe.prefill is not None:
            out += self._pool_members(
                fe.prefill, range(len(fe.prefill.endpoints)), "prefill")
        if self.include_router:
            out.append({"worker_id": "router", "role": "router",
                        "endpoint": None,
                        "snapshot": _metrics.registry().snapshot()})
        return out

    # -- polling -------------------------------------------------------------
    def poll_now(self):
        members = self.members()
        # judge over the full membership (router counters — failover —
        # feed the failure SLO), then RE-snapshot the router so the burn
        # gauges set by this very observation ride the written snapshot
        self.watchdog.observe(merge_snapshots(members))
        for m in members:
            if m["role"] == "router":
                m["snapshot"] = _metrics.registry().snapshot()
        merged = merge_snapshots(members)
        self.last_members = members
        self.last_merged = merged
        self.polls += 1
        if self.jsonl_path:
            d = os.path.dirname(os.path.abspath(self.jsonl_path))
            os.makedirs(d, exist_ok=True)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(merged) + "\n")
        return merged

    def maybe_poll(self):
        """Interval-gated poll — what DistFrontend.pump() calls."""
        now = self._clock()
        if self._last_poll_t is not None and \
                now - self._last_poll_t < self.poll_interval_s:
            return None
        self._last_poll_t = now
        return self.poll_now()

    def prometheus(self):
        """ONE merged Prometheus exposition for the whole fleet."""
        if self.last_merged is None:
            self.poll_now()
        return _metrics.prometheus_from_snapshot(self.last_merged)

    def write_prometheus(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.prometheus())
        return path

    # -- breach handling -----------------------------------------------------
    def on_breach(self, details):
        """Sustained SLO breach: annotate the router's flight recorder
        (the postmortem trail must say WHY the bundle exists) and pull a
        fleet postmortem bundle when a destination is configured."""
        _fr.annotate("fleet.slo_breach", details)
        if self.postmortem_dir:
            self.collect_postmortems(
                f"slo breach: burn {details.get('burn')}")

    def _pool_dumps(self, client, indexes, prefix, reason):
        out = []
        for i in indexes:
            entry = {"worker_id": f"{prefix}{i}",
                     "endpoint": client.endpoints[i]}
            try:
                reply = client.dump(i, reason)
            except Exception as e:                       # noqa: BLE001
                entry.update(ok=False, error=f"{type(e).__name__}: {e}")
            else:
                entry.update(ok=True, role=reply.get("role"),
                             remote_path=reply.get("path"),
                             postmortem=reply.get("postmortem"))
            out.append(entry)
        return out

    def collect_postmortems(self, reason, out_dir=None):
        """The fleet postmortem bundle: one directory holding
        `bundle.json` (schema, reason, burn figures, the router's
        flight-recorder annotations, member index) plus one
        `<worker_id>.json` postmortem per worker that answered OP_DUMP.
        Unreachable workers are RECORDED as unreachable — a bundle
        gathered because a host died must say which host stayed dark."""
        fe = self.frontend
        base = out_dir or self.postmortem_dir or "./postmortem"
        bundle_dir = os.path.join(
            base, f"fleet_postmortem_{int(time.time() * 1e3)}")
        os.makedirs(bundle_dir, exist_ok=True)
        # sweep EVERY decode endpoint, not just the live set: the host
        # whose death caused the breach must appear in the bundle as
        # unreachable, not silently vanish (its breaker makes the
        # failed dump cheap)
        dumps = self._pool_dumps(fe.decode,
                                 range(len(fe.decode.endpoints)),
                                 "decode", reason)
        if fe.prefill is not None:
            dumps += self._pool_dumps(
                fe.prefill, range(len(fe.prefill.endpoints)), "prefill",
                reason)
        members = []
        for d in dumps:
            entry = {k: d[k] for k in
                     ("worker_id", "endpoint", "ok") if k in d}
            entry.update({k: d[k] for k in ("role", "remote_path", "error")
                          if k in d})
            if d.get("ok"):
                path = os.path.join(bundle_dir, f"{d['worker_id']}.json")
                with open(path, "w") as f:
                    json.dump(d["postmortem"], f, indent=1)
                entry["path"] = path
            members.append(entry)
        doc = {"schema": BUNDLE_SCHEMA, "reason": str(reason),
               "time": time.time(), "router_pid": os.getpid(),
               "burn": dict(self.watchdog.last_burn),
               "degraded": bool(self.watchdog.degraded),
               "router_annotations": _fr.get().annotations_snapshot(),
               "members": members}
        with open(os.path.join(bundle_dir, "bundle.json"), "w") as f:
            json.dump(doc, f, indent=1)
        self.last_bundle = bundle_dir
        return bundle_dir
