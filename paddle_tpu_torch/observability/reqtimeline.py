"""Per-request end-to-end timelines: phase segments + record.

Counterpart of `paddle_tpu/observability/reqtimeline.py`, copied, schema
`paddle_tpu.reqtimeline.v1` included. A request's latency decomposes into
phases (queue wait, prefill, KV handoff, adoption, prefix restore,
decode, a failover hop):

  - the canonical phase names, one vocabulary across the scheduler and
    the fleet router, so `tools/serve_report.py` attributes tails
    without per-emitter casing,
  - `PhaseTrail`: contiguous phase segments for one request — exactly
    one phase is open at any moment, and closing/opening share a single
    timestamp, so the segment durations sum exactly to the span between
    the first open and the final close,
  - `build_record`: the `paddle_tpu.reqtimeline.v1` dict the scheduler
    appends to its serving JSONL (kind "timeline").

The port's scheduler trails every request through queue -> kv_restore? ->
prefill|adopt -> decode (-> queue again on preemption). Stdlib-only.
"""

__all__ = ["SCHEMA", "PH_QUEUE", "PH_PREFILL", "PH_KV_HANDOFF", "PH_ADOPT",
           "PH_PLACE", "PH_DECODE", "PH_FAILOVER", "PH_KV_RESTORE",
           "PHASES", "PhaseTrail", "build_record", "ttft_breakdown"]

SCHEMA = "paddle_tpu.reqtimeline.v1"

# the canonical phase vocabulary (queued -> placed -> prefill
# -> KV handoff -> adopt -> decode steps -> done/preempted/failover)
PH_QUEUE = "queue"            # admission queue wait (re-opens on preempt)
PH_PREFILL = "prefill"        # local prefill, or the remote PREFILL RPC
PH_KV_HANDOFF = "kv_handoff"  # prefill->decode bundle stream (fleet only)
PH_ADOPT = "adopt"            # placement from a staged KV bundle
PH_PLACE = "place"            # router SUBMIT/placement overhead (fleet)
PH_DECODE = "decode"          # first token -> terminal (or next eviction)
PH_FAILOVER = "failover"      # dead-worker hop: detection -> re-placed
PH_KV_RESTORE = "kv_restore"  # tier promote / cross-host prefix restore
PHASES = (PH_QUEUE, PH_PREFILL, PH_KV_HANDOFF, PH_ADOPT, PH_PLACE,
          PH_DECODE, PH_FAILOVER, PH_KV_RESTORE)


class PhaseTrail:
    """Contiguous phase segments of one request.

    `begin(phase, now)` closes the open segment AT `now` and opens the
    next one there; `close(now)` seals the trail. Because one timestamp
    serves as both boundary values, `sum(dur_s) == last_close -
    first_open` holds by construction — the timeline record's
    phases-sum-to-e2e contract is structural, not measured."""

    __slots__ = ("segments", "_open")

    def __init__(self):
        self.segments = []            # [(phase, t0, t1), ...] closed
        self._open = None             # (phase, t0) or None

    def begin(self, phase, now):
        self.close(now)
        self._open = (str(phase), float(now))

    def close(self, now):
        if self._open is None:
            return
        phase, t0 = self._open
        self._open = None
        self.segments.append((phase, t0, max(float(now), t0)))

    def append(self, phase, t0, t1):
        """Directly add a closed segment (the router splits one measured
        interval into prefill/kv_handoff/place parts)."""
        self.segments.append((str(phase), float(t0), float(t1)))

    def rel(self, origin):
        """[{phase, t0, dur_s}] with t0 relative to `origin` — the wire/
        JSONL shape (closed segments only)."""
        return [{"phase": p, "t0": round(t0 - origin, 6),
                 "dur_s": round(t1 - t0, 6)}
                for p, t0, t1 in self.segments]


def build_record(status, submitted_t, finished_t, phases, request_id=None,
                 key=None, tokens=0, ttft_s=None, priority=None,
                 preempted=0, failovers=0, worker=None, adopted=False,
                 trace_id=None, worker_phases=None, tenant=None,
                 cohort=None):
    """One `paddle_tpu.reqtimeline.v1` record. `phases` is the
    `PhaseTrail.rel()` list (t0 relative to `submitted_t`);
    `worker_phases` optionally carries the serving worker's own trail
    for fleet requests (durations on the worker's clock — the join that
    splits a remote decode segment into its queue/prefill/decode
    constituents)."""
    rec = {"kind": "timeline", "schema": SCHEMA, "status": str(status),
           "e2e_s": round(float(finished_t) - float(submitted_t), 6),
           "ttft_s": None if ttft_s is None else round(float(ttft_s), 6),
           "tokens": int(tokens), "preempted": int(preempted),
           "failovers": int(failovers), "adopted": bool(adopted),
           "phases": list(phases)}
    if request_id is not None:
        rec["request_id"] = int(request_id)
    if key is not None:
        rec["key"] = str(key)
    if priority is not None:
        rec["priority"] = int(priority)
    if worker is not None:
        rec["worker"] = int(worker)
    if trace_id is not None:
        rec["trace_id"] = str(trace_id)
    if worker_phases is not None:
        rec["worker_phases"] = list(worker_phases)
    # request attribution: the tenant/cohort labels join the
    # timeline to the request's metric labelsets and decision records
    if tenant is not None:
        rec["tenant"] = str(tenant)
    if cohort is not None:
        rec["cohort"] = str(cohort)
    return rec


def ttft_breakdown(record):
    """{phase: seconds} decomposition of one timeline record's TTFT
    window — each segment's overlap with [0, ttft_s). The decode phase's
    share is reported as `first_decode` (placement -> first delivered
    token; ~0 for local scheduling, real for fleet requests whose first
    token rides a POLL). None when the request never produced a token.
    This is the attribution `tools/load_harness.py` exports as
    `serving_load_ttft_phase_seconds{phase=...}` gauges."""
    ttft = record.get("ttft_s")
    if ttft is None:
        return None
    out = {}
    for seg in record.get("phases", ()):
        lo = float(seg["t0"])
        hi = lo + float(seg["dur_s"])
        overlap = min(hi, float(ttft)) - max(lo, 0.0)
        if overlap <= 0.0:
            continue
        phase = seg["phase"]
        if phase == PH_DECODE:
            phase = "first_decode"
        out[phase] = out.get(phase, 0.0) + overlap
    return out
