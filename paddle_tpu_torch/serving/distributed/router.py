"""The serving frontend: placement, streaming, failover, health, drain.

Counterpart of `paddle_tpu/serving/distributed/router.py`, copied: the
placement, failover, health, hedging, migration and drain rules, their
decisions.v1 and reqtimeline.v1 records and the `serving_*` families are
the JAX router's, and its verbs reach either package's workers. The
router is host code: it moves keys and JSON, never KV bytes, and touches
no device.

`DistFrontend` sits in front of disaggregated prefill and decode pools.
Per request it:

  1. PLACES: picks the live decode worker with the fewest in-flight
     requests (a dead worker's breaker keeps it out), and a prefill
     worker round-robin;
  2. PREFILLS REMOTELY: the prefill worker computes the prompt's KV and
     streams the bundle straight to the chosen decode worker; any
     prefill or handoff failure falls back to a decode-local prefill,
     losing only the disaggregation, never the request;
  3. SUBMITS + PUMPS: admits on the decode worker and batch-polls the
     token stream;
  4. FAILS OVER: when a decode worker goes dark mid-stream
     (PSUnavailableError: retries exhausted or breaker open, e.g. a
     SIGKILLed process), every request it carried restarts on a live
     worker recompute-style: prompt + tokens received so far becomes the
     restart prompt (the scheduler's preemption rule, across processes),
     so the delivered stream completes as an unkilled run would, under
     greedy decoding and under temperature > 0: every placement carries
     the request's stable `rng_seed` plus the delivered-token count, and
     token n samples with the generator of (rng_seed, n) wherever it
     runs (`sampling.slot_generator_seed`). `serving_failover_total`
     counts the events.

Trace stitching: under a `tracecontext.trace_scope` every verb frame
carries the trace id; worker handler spans parent under the router's
client spans and the prefill->decode KVPUT rides the same id, so
`merge_chrome_traces` renders one timeline across the processes.

Gray failures, four planes:

  HEALTH   pump() drives an interval-gated OP_HEALTH sweep over every
           decode endpoint (dead ones included: the rejoin path). A
           per-worker suspicion score accrues from heartbeat staleness,
           heartbeat RTT against the fleet median and decode-step p99
           against the fleet median; thresholds map it to healthy ->
           suspect -> dark (`serving_worker_suspicion`,
           `serving_worker_state`, a `health` decision per transition).
  DEADLINE the remaining budget rides PREFILL/SUBMIT/POLL so workers
           shed work they cannot finish
           (`serving_deadline_missed_total{where=router|worker}`).
  HEDGE +  read-only fan-outs get one hedged duplicate on a second
  BUDGET   socket after a p99-derived delay (`serving_hedged_total`);
           every router-initiated retry draws from a per-worker token
           bucket (`serving_retry_budget_exhausted_total`).
  MIGRATE  a worker crossing into suspect has its streams migrated
           (OP_KV_EXPORT wire-restore of the prefix chain when the
           source is alive, else recompute), with the failover rule
           (`serving_migrations_total{reason=suspect|drain}`). OP_DRAIN
           and `rolling_drain()` reuse the path for zero-drop rolling
           restarts.
"""
import collections
import itertools
import json
import os
import threading
import time
import zlib

from ...distributed.ps import rpc as _rpc
from ...observability import decisions as _dec
from ...observability import metrics as _metrics
from ...observability import reqtimeline as _rt
from ...observability import tracecontext as _tc
from ..scheduler import DONE, ERROR, QUEUED, RUNNING, SHED, TIMEOUT
from . import kv_handoff as _kv
from .worker import _M_DEADLINE_MISS
from .worker import (OP_DRAIN, OP_DUMP, OP_HEALTH, OP_KV_EXPORT,
                     OP_KV_PUT, OP_METRICS, OP_POLL, OP_PREFILL,
                     OP_PREFIX_LOOKUP, OP_STAT, OP_SUBMIT, OP_SWAP)

__all__ = ["ServingShardClient", "DistFrontend", "DistRequest",
           "NoWorkersError"]

_M_FAILOVER = _metrics.counter(
    "serving_failover_total",
    "Requests re-routed off a dead decode worker mid-stream (each one "
    "resumed recompute-style on a live worker)")
_M_MIGRATIONS = _metrics.counter(
    "serving_migrations_total",
    "Streams proactively moved off a suspect/draining worker before "
    "their deadlines burned (bit-exact, like failover)",
    labelnames=("reason",))
_M_HEDGED = _metrics.counter(
    "serving_hedged_total",
    "Hedged readonly calls that actually fired a duplicate, by which "
    "copy answered first (or 'denied' when the retry budget refused)",
    labelnames=("verb", "outcome"))
# the paired rate family (metrics_report rate rule): of all hedge-
# eligible calls, primary answered inside the hedge delay vs a
# duplicate fired — the ratio dropping means the fleet got slower
_M_HEDGE_PRIMARY = _metrics.counter(
    "serving_hedge_primary_total",
    "Hedge-eligible calls the primary answered within the hedge delay",
    labelnames=("verb",))
_M_HEDGE_FIRED = _metrics.counter(
    "serving_hedge_fired_total",
    "Hedge-eligible calls whose hedge delay lapsed (duplicate fired "
    "or was budget-denied)",
    labelnames=("verb",))
_M_RETRY_DENIED = _metrics.counter(
    "serving_retry_budget_exhausted_total",
    "Router-initiated retries denied by a worker's token-bucket "
    "retry budget (the retry-storm brake engaging)",
    labelnames=("worker",))
_M_SUSPICION = _metrics.gauge(
    "serving_worker_suspicion",
    "Per-worker phi-accrual-style suspicion score (0 = healthy; "
    "suspect/dark thresholds are router config)",
    labelnames=("worker",))
_M_STATE = _metrics.gauge(
    "serving_worker_state",
    "Per-worker health state: 0 healthy, 1 suspect, 2 dark",
    labelnames=("worker",))

_TERMINAL = (DONE, TIMEOUT, ERROR, SHED)
_STATE_LEVELS = {"healthy": 0, "suspect": 1, "dark": 2}


def _median(xs):
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class _TokenBucket:
    """Per-worker retry budget: `rate` tokens/s up to `burst`. Every
    router-initiated retry (failover restart, submit re-place, hedge
    duplicate) costs one token, so a sick fleet degrades to fast-fail
    instead of amplifying load into a retry storm."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self, cost=1.0):
        """(granted, tokens_available_post_refill) — the second figure
        is what the decisions.v1 denial record replays against."""
        now = time.monotonic()
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            avail = self._tokens
            if cost <= self._tokens:
                self._tokens -= cost
                return True, avail
            return False, avail


class _WorkerHealth:
    """Router-side health ledger for one decode worker: probe EWMAs +
    the thresholded state. Mutated by probe threads and read by the
    sweep evaluation, both under the frontend lock."""

    __slots__ = ("state", "suspicion", "last_ok", "ewma_interval",
                 "ewma_rtt", "step_p99", "reachable")

    def __init__(self, now, interval_s):
        self.state = "healthy"
        self.suspicion = 0.0
        self.last_ok = now            # until a probe lands, "ok at boot"
        self.ewma_interval = interval_s
        self.ewma_rtt = None
        self.step_p99 = None
        self.reachable = True


class NoWorkersError(ConnectionError):
    """Every decode worker in the pool is dark."""


class ServingShardClient(_rpc.ShardClientBase):
    """JSON-verb client over a pool of serving workers — one instance
    spans N endpoints with per-endpoint sockets, retries, and breakers
    (ShardClientBase), like the PS clients span table shards."""

    def _call(self, i, op, obj, tail=b"", aux=0):
        payload = _kv.pack_payload(obj, tail)
        msg = _rpc._HDR.pack(op, len(payload), aux) + payload

        def reader(s):
            n = self._ack(s)
            obj_out, _ = _kv.unpack_payload(_rpc._recv_exact(s, n))
            return obj_out
        return self._exchange(i, msg, reader)

    def prefill(self, i, key, prompt, decode_endpoint=None,
                rng_seed=None, rng_gen=0, tenant=None, cohort=None,
                namespace=None, deadline_left_s=None):
        return self._call(i, OP_PREFILL, {
            "key": key, "prompt": [int(t) for t in prompt],
            "decode_endpoint": decode_endpoint,
            "rng_seed": rng_seed, "rng_gen": int(rng_gen),
            "tenant": tenant, "cohort": cohort,
            "namespace": namespace, "deadline_left_s": deadline_left_s})

    def kv_put(self, i, key, bundle):
        return self._call(i, OP_KV_PUT, {"key": key}, tail=bundle)

    def submit(self, i, key, prompt, max_new=None, priority="standard",
               timeout_s=None, use_staged=False, rng_seed=None,
               rng_gen=0, tenant=None, cohort=None, adapter_id=None,
               prefix_namespace=None, deadline_left_s=None):
        return self._call(i, OP_SUBMIT, {
            "key": key, "prompt": [int(t) for t in prompt],
            "max_new": max_new, "priority": priority,
            "timeout_s": timeout_s, "use_staged": bool(use_staged),
            "rng_seed": rng_seed, "rng_gen": int(rng_gen),
            "tenant": tenant, "cohort": cohort,
            "adapter_id": adapter_id,
            "prefix_namespace": prefix_namespace,
            "deadline_left_s": deadline_left_s})

    def poll(self, i, keys, cancel=None, deadlines=None):
        """Batch stream fetch; `cancel` lists keys the worker should
        release now (migrated/drained streams), `deadlines` maps key ->
        remaining budget seconds so the worker expires overdue work
        server-side."""
        obj = {"keys": list(keys)}
        if cancel:
            obj["cancel"] = list(cancel)
        if deadlines:
            obj["deadlines"] = dict(deadlines)
        return self._call(i, OP_POLL, obj)

    def health(self, i):
        """The worker's OP_HEALTH heartbeat (readonly): decode-step
        p99, queue depth, last-step age, drain flag, in-flight count —
        the router's suspicion-score inputs."""
        return self._call(i, OP_HEALTH, {})

    def drain(self, i, enter=None):
        """OP_DRAIN: enter=True stops admission, enter=False
        reinstates, enter=None is a pure status query ({draining,
        inflight})."""
        return self._call(i, OP_DRAIN, {"enter": enter})

    def prefix_lookup(self, i, prompt, namespace=None):
        """How many tokens of `prompt` worker `i` could serve from its
        prefix cache (OP_PREFIX_LOOKUP,
        read-only) — the affinity placement probe."""
        return self._call(i, OP_PREFIX_LOOKUP, {
            "prompt": [int(t) for t in prompt], "namespace": namespace})

    def kv_export(self, i, key, prompt, decode_endpoint=None,
                  namespace=None, tenant=None):
        """Ask worker `i` to export its cached chain for `prompt` and
        stream it to `decode_endpoint`'s staging area as a prefix_only
        bundle (OP_KV_EXPORT) — the cross-host restore edge."""
        return self._call(i, OP_KV_EXPORT, {
            "key": key, "prompt": [int(t) for t in prompt],
            "decode_endpoint": decode_endpoint, "namespace": namespace,
            "tenant": tenant})

    def swap(self, i, path, version=None, apply_timeout_s=30):
        return self._call(i, OP_SWAP, {
            "path": path, "version": version,
            "apply_timeout_s": apply_timeout_s})

    def stat(self, i):
        return self._call(i, OP_STAT, {})

    def metrics(self, i):
        """The worker's full metrics.v1 registry snapshot (OP_METRICS,
        read-only) — the fleet federation input."""
        return self._call(i, OP_METRICS, {})

    def dump(self, i, reason=""):
        """Pull the worker's flight-recorder postmortem (OP_DUMP) — the
        fleet postmortem bundle's per-member document."""
        return self._call(i, OP_DUMP, {"reason": str(reason)})


class DistRequest:
    """Router-side view of one request: the merged token stream across
    (possibly several) decode workers."""

    _ids = itertools.count()

    def __init__(self, prompt, max_new, priority, timeout_s=None,
                 rng_seed=None, tenant=None, cohort=None,
                 adapter_id=None, prefix_namespace=None):
        self.key = f"r{next(self._ids)}.{os.getpid()}"
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.priority = priority
        self.timeout_s = timeout_s
        # request attribution: carried on every PREFILL/
        # SUBMIT wire frame next to rng_seed, into the worker scheduler's
        # labelsets, and onto this router's own timeline + decision
        # records — one label from router to fleet snapshot
        self.tenant = str(tenant) if tenant else _dec.DEFAULT_TENANT
        self.cohort = str(cohort) if cohort else None
        # multi-tenant serving: the adapter a decode worker
        # should bind the request's slot to, and the prefix-cache
        # namespace its prompt blocks key under — both ride the wire
        # next to tenant, and both survive every re-placement (the
        # failover restart binds the same adapter on the new worker)
        self.adapter_id = str(adapter_id) if adapter_id else None
        self.prefix_namespace = str(prefix_namespace) \
            if prefix_namespace is not None else None
        # the request's sampler seed: STABLE across every
        # placement — original, preempt restart, failover restart — so
        # a temperature>0 stream replays bit-identically wherever it
        # lands. Derived from the wire key when not supplied; callers
        # comparing against an out-of-process oracle pass it explicitly.
        self.rng_seed = int(rng_seed) if rng_seed is not None \
            else (zlib.crc32(self.key.encode()) & 0x7FFFFFFF)
        self.status = QUEUED
        self.error = None
        self.worker = None           # decode shard index currently serving
        self.failovers = 0
        # deadline propagation: the ABSOLUTE deadline fixed
        # at submission; every wire verb carries the REMAINING budget so
        # workers can shed work the router can no longer use
        self.deadline = (time.monotonic() + float(timeout_s)) \
            if timeout_s is not None else None
        self.staged = False          # last placement used a handed bundle
        self.submitted_at = time.monotonic()
        self.first_token_at = None
        self.finished_at = None
        self._base = []              # tokens from previous (dead) workers
        self._cur = []               # tokens from the current worker
        self._wire_key = self.key    # re-keyed per placement attempt
        # router-side end-to-end phase timeline: opens in
        # `queue` at submission; _place accounts prefill/kv_handoff/
        # place segments from its measured RPC intervals, failover hops
        # get their own named segment, and the trail seals at terminal
        # status — segment durations sum exactly to e2e by construction
        self.trail = _rt.PhaseTrail()
        self.trail.begin(_rt.PH_QUEUE, self.submitted_at)
        self._timeline_done = False
        # the active trace id at submission (None outside a profiler
        # window / trace_scope): joins the timeline record to the
        # merged chrome trace's RPC spans for this request
        self.trace_id = _tc.current_trace_id()

    @property
    def tokens(self):
        return self._base + self._cur

    def deadline_left(self, now=None):
        """Remaining deadline budget in seconds (negative = overdue),
        None when the request has no deadline."""
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() if now is None else now)

    def done(self):
        return self.status in _TERMINAL

    @property
    def ttft_s(self):
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class DistFrontend:
    def __init__(self, decode_endpoints, prefill_endpoints=(),
                 retry=None, breaker_threshold=2, breaker_cooldown_s=30.0,
                 request_timeout_s=10.0, connect_timeout_s=5.0,
                 timeline_path=None, prefix_affinity=False,
                 affinity_min_match=1, affinity_load_slack=0,
                 health_interval_s=0.25, suspect_threshold=3.0,
                 dark_threshold=8.0, hedge_delay_min_s=0.02,
                 hedge_delay_max_s=0.5, retry_budget_rate=8.0,
                 retry_budget_burst=32.0, proactive_migration=True):
        # fast-failing defaults: a dead worker should cost milliseconds
        # of retries, then its breaker holds it dark while we re-place
        retry = retry or _rpc.RetryPolicy(max_attempts=2,
                                          base_delay_s=0.02,
                                          max_delay_s=0.1)
        kwargs = dict(retry=retry, breaker_threshold=breaker_threshold,
                      breaker_cooldown_s=breaker_cooldown_s,
                      request_timeout_s=request_timeout_s,
                      connect_timeout_s=connect_timeout_s)
        self.decode = ServingShardClient(list(decode_endpoints), **kwargs)
        self.prefill = ServingShardClient(list(prefill_endpoints),
                                          **kwargs) \
            if prefill_endpoints else None
        # the hedge twin: per-endpoint sockets serialize
        # calls, so a hedged duplicate MUST ride a second connection
        # pool or it would queue behind the stalled primary it is
        # hedging against. Sockets are lazy — idle twins cost nothing.
        self._hedge = ServingShardClient(list(decode_endpoints), **kwargs)
        self._request_timeout_s = float(request_timeout_s)
        self._live = set(range(len(self.decode.endpoints)))
        self._prefill_rr = 0
        # gray-failure health plane
        self.health_interval_s = float(health_interval_s)
        self.suspect_threshold = float(suspect_threshold)
        self.dark_threshold = float(dark_threshold)
        self.hedge_delay_min_s = float(hedge_delay_min_s)
        self.hedge_delay_max_s = float(hedge_delay_max_s)
        self.proactive_migration = bool(proactive_migration)
        now = time.monotonic()
        self._health = {i: _WorkerHealth(now, self.health_interval_s)
                        for i in range(len(self.decode.endpoints))}
        self._health_last_sweep = 0.0
        self._rtts = collections.deque(maxlen=128)   # readonly RPC RTTs
        self._retry_budgets = {
            i: _TokenBucket(retry_budget_rate, retry_budget_burst)
            for i in range(len(self.decode.endpoints))}
        self._draining_workers = set()
        # fleet-global prefix cache: with prefix_affinity on,
        # placement probes every live decode worker (OP_PREFIX_LOOKUP)
        # and routes to the longest cached match — unless that owner is
        # already `affinity_load_slack` requests busier than the least-
        # loaded worker, in which case the request lands least-loaded
        # and the owner's chain is WIRE-RESTORED there (OP_KV_EXPORT).
        # Matches below `affinity_min_match` tokens (set it to the
        # engine's block_size: sub-block matches restore nothing) never
        # bind. The rule IS decisions.replay_affinity_place over the
        # recorded inputs.
        self.prefix_affinity = bool(prefix_affinity)
        self.affinity_min_match = int(affinity_min_match)
        self.affinity_load_slack = float(affinity_load_slack)
        self._inflight = {}          # key -> DistRequest
        self._lock = threading.Lock()
        # the fleet observability plane: attaching an
        # observability.fleet.FleetPlane sets this, and pump() then
        # drives its interval-gated OP_METRICS federation sweep
        self.fleet_plane = None
        self.timeline_path = timeline_path
        if timeline_path:
            os.makedirs(os.path.dirname(os.path.abspath(timeline_path)),
                        exist_ok=True)
        self._timeline = []          # reqtimeline.v1 records, in
                                     # finalization order
        # decisions.v1 records: place/failover, newest-last.
        # RING-bounded like the scheduler's — the timeline JSONL keeps
        # the full history
        self._decisions = collections.deque(maxlen=4096)

    def _append_stream(self, rec):
        """Append one record to the timeline JSONL stream (timelines
        and decisions share it; the directory exists from __init__)."""
        if self.timeline_path:
            with open(self.timeline_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # -- the decision audit log -----------------------------------
    def _decide(self, action, req, inputs, outcome):
        """One router-side decisions.v1 record (placement, failover) —
        appended in memory and to the timeline JSONL stream, keyed and
        tenant-labeled like the request's timeline record."""
        rec = _dec.build_record(
            action, inputs, outcome, "router", time.monotonic(),
            key=req.key, tenant=req.tenant, cohort=req.cohort,
            trace_id=req.trace_id)
        with self._lock:
            self._decisions.append(rec)
        self._append_stream(rec)
        return rec

    def _decide_fleet(self, action, inputs, outcome):
        """A decisions.v1 record with no owning request (health
        transitions, drain phases, hedge budget denials) — same stream,
        default tenant."""
        rec = _dec.build_record(action, inputs, outcome, "router",
                                time.monotonic())
        with self._lock:
            self._decisions.append(rec)
        self._append_stream(rec)
        return rec

    def decision_records(self):
        """Every router decisions.v1 record so far (placements and
        failover hops) — what tests/bench audit without re-parsing the
        JSONL."""
        with self._lock:
            return list(self._decisions)

    # -- placement -----------------------------------------------------------
    # Locking discipline: `self._lock` guards only the bookkeeping
    # (_live, _inflight, _prefill_rr) in short critical sections —
    # NEVER a network round-trip. Blocking RPCs under the lock would
    # stall pump() (token delivery, failover detection) behind every
    # admission's retry budget.
    def live_decode_workers(self):
        with self._lock:
            return sorted(self._live)

    def _mark_dead(self, i):
        with self._lock:
            self._live.discard(i)

    def _pick_decode(self, req=None, exec_prompt=None):
        """SLO-aware placement: the live worker carrying the fewest
        in-flight router requests (queue-depth-proportional load
        balancing without a STAT round-trip per submit). With
        prefix_affinity on, a per-worker OP_PREFIX_LOOKUP
        sweep runs first and the longest cached match wins ahead of
        least-loaded, within the load-slack bound. Either way the
        choice IS the matching decisions replay rule over the recorded
        inputs. Returns (worker, loads, matches-or-None); the lookup
        RPCs run OUTSIDE the lock, per the locking discipline above.

        Eligibility: live minus draining; when any of those
        are `healthy`, suspect workers are additionally excluded —
        placement prefers the healthy subset but degrades to the full
        candidate set rather than refusing service when the whole
        fleet looks suspect (suspicion is relative; an all-suspect
        fleet usually means a bad baseline, not a dead fleet)."""
        with self._lock:
            candidates = self._live - self._draining_workers
            if not candidates:
                raise NoWorkersError("every decode worker is dark")
            healthy = {i for i in candidates
                       if self._health[i].state == "healthy"}
            pool = healthy or candidates
            loads = {i: 0 for i in pool}
            for req_ in self._inflight.values():
                if not req_.done() and req_.worker in loads:
                    loads[req_.worker] += 1
        if self.prefix_affinity and req is not None and exec_prompt:
            matches = self._probe_matches(sorted(loads), exec_prompt,
                                          req.prefix_namespace)
            choice = _dec.replay_affinity_place(
                {"loads": loads, "matches": matches,
                 "min_match": self.affinity_min_match,
                 "load_slack": self.affinity_load_slack})
            return choice, loads, matches
        return _dec.replay_place({"loads": loads}), loads, None

    def _probe_matches(self, workers, exec_prompt, namespace):
        """The affinity sweep: one CONCURRENT OP_PREFIX_LOOKUP probe per
        live worker (ShardClientBase holds per-endpoint sockets + locks,
        so parallel probes never share a connection), each probe hedged
        (a duplicate fires on the twin client after the hedge delay —
        a transient stall on one socket no longer decides placement).
        The sweep's wall time is additionally CAPPED per worker at the
        suspicion-scaled hedge deadline (previously
        a gray worker's probe burned its whole retry/timeout budget
        inside every placement): a worker that hasn't answered by
        2*hedge_delay/(1+suspicion) simply claims no affinity this
        round — placement proceeds, the probe thread retires on its
        own. A dark/failed probe claims no affinity."""
        matches = {i: 0 for i in workers}

        def probe(i):
            try:
                reply = self._hedged_call(
                    "PREFIXLOOKUP", i,
                    lambda c: c.prefix_lookup(i, exec_prompt,
                                              namespace=namespace))
                matches[i] = int(reply.get("match_tokens") or 0)
            except (_rpc.PSUnavailableError, _rpc.PSServerError):
                matches[i] = 0           # dark probe: no affinity claim
        if len(workers) == 1:
            probe(workers[0])
            return dict(matches)
        threads = {i: threading.Thread(target=probe, args=(i,),
                                       daemon=True) for i in workers}
        for t in threads.values():
            t.start()
        base = 2.0 * self._hedge_delay()
        t0 = time.monotonic()
        with self._lock:
            susp = {i: self._health[i].suspicion for i in workers}
        for i, t in threads.items():
            cap = base / (1.0 + max(0.0, susp.get(i, 0.0)))
            t.join(max(0.0, t0 + cap - time.monotonic()))
        # snapshot: a straggler thread finishing later must not mutate
        # the dict the placement rule + decision record already used
        return dict(matches)

    # -- hedging + retry budgets ----------------------------------
    def _note_rtt(self, dt):
        with self._lock:
            self._rtts.append(dt)

    def _hedge_delay(self):
        """The p99 of recent successful readonly RPC RTTs, clamped to
        [hedge_delay_min_s, hedge_delay_max_s]; before enough samples
        exist the max applies (hedge conservatively while cold)."""
        with self._lock:
            if len(self._rtts) < 8:
                return self.hedge_delay_max_s
            xs = sorted(self._rtts)
            d = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        return min(max(d, self.hedge_delay_min_s), self.hedge_delay_max_s)

    def _budget_take(self, i, what, req=None):
        """Draw one token from worker i's retry budget. A denial is a
        decision: counted, recorded (replayable), and the caller
        fast-fails instead of retrying into a sick fleet."""
        bucket = self._retry_budgets.get(i)
        if bucket is None:
            return True
        ok, avail = bucket.take(1.0)
        if ok:
            return True
        _M_RETRY_DENIED.labels(worker=str(i)).inc()
        inputs = {"worker": i, "cost": 1.0,
                  "tokens_available": round(avail, 6), "what": what}
        outcome = {"denied": True,
                   "reason": _dec.replay_retry_budget(inputs)}
        if req is not None:
            self._decide("retry_budget", req, inputs, outcome)
        else:
            self._decide_fleet("retry_budget", inputs, outcome)
        return False

    def _hedged_call(self, verb, i, call):
        """Run `call(client)` against worker i with one hedged
        duplicate: primary on the main client; if it hasn't answered
        within the hedge delay (and worker i's retry budget grants a
        token), the SAME call fires on the twin client's independent
        socket — first answer (or first error) wins. Only readonly
        verbs ride this path."""
        delay = self._hedge_delay()
        result = []
        done = threading.Event()
        res_lock = threading.Lock()

        def run(client, who):
            t0 = time.monotonic()
            try:
                v, err = call(client), None
            except Exception as e:                       # noqa: BLE001
                v, err = None, e
            if err is None:
                self._note_rtt(time.monotonic() - t0)
            with res_lock:
                if not result:
                    result.append((v, err, who))
                    done.set()
        threading.Thread(target=run, args=(self.decode, "primary"),
                         daemon=True).start()
        fired = False
        if done.wait(delay):
            _M_HEDGE_PRIMARY.labels(verb=verb).inc()
        else:
            _M_HEDGE_FIRED.labels(verb=verb).inc()
            if self._budget_take(i, "hedge"):
                fired = True
                threading.Thread(target=run, args=(self._hedge, "hedge"),
                                 daemon=True).start()
            else:
                _M_HEDGED.labels(verb=verb, outcome="denied").inc()
            if not done.wait(2.0 * self._request_timeout_s + 1.0):
                raise _rpc.PSUnavailableError(
                    f"worker {i} hedged {verb} timed out")
        v, err, who = result[0]
        if fired:
            _M_HEDGED.labels(verb=verb, outcome=who).inc()
        if err is not None:
            raise err
        return v

    # -- the health plane -----------------------------------------
    def _maybe_health_sweep(self):
        now = time.monotonic()
        if now - self._health_last_sweep < self.health_interval_s:
            return
        self._health_last_sweep = now
        self._health_sweep(now)

    def _health_sweep(self, now):
        """One OP_HEALTH round over EVERY decode endpoint — dead and
        dark included, which is exactly the reinstatement path (a
        breaker-half-open probe that answers rejoins placement).
        Probe threads update the per-worker ledgers themselves (under
        the lock) and the sweep joins them only briefly: a gray
        worker's slow heartbeat lands late and is evaluated next
        sweep, while pump() never stalls behind it."""
        with self._lock:
            draining = set(self._draining_workers)
        targets = [i for i in self._health if i not in draining]

        def probe(i):
            t0 = time.monotonic()
            try:
                rep = self.decode.health(i)
            except (_rpc.PSUnavailableError, _rpc.PSServerError,
                    ConnectionError, OSError):
                with self._lock:
                    self._health[i].reachable = False
                return
            rtt = time.monotonic() - t0
            self._note_rtt(rtt)
            with self._lock:
                h = self._health[i]
                dt = time.monotonic() - h.last_ok
                h.ewma_interval += 0.3 * (dt - h.ewma_interval)
                h.last_ok = time.monotonic()
                h.ewma_rtt = rtt if h.ewma_rtt is None \
                    else h.ewma_rtt + 0.3 * (rtt - h.ewma_rtt)
                p99 = rep.get("decode_step_p99_s")
                if p99:
                    h.step_p99 = float(p99)
                h.reachable = True
        threads = [threading.Thread(target=probe, args=(i,), daemon=True)
                   for i in targets]
        for t in threads:
            t.start()
        join_until = time.monotonic() + min(0.05, self.health_interval_s)
        for t in threads:
            t.join(max(0.0, join_until - time.monotonic()))
        self._evaluate_health(time.monotonic())

    # ratio-term floors: below these absolute latencies a worker is fast
    # in any deployment, and the fleet-relative ratios are pure noise
    # (two sub-millisecond RTTs can differ 5x jitter-to-jitter — that
    # must never read as a 5x-slow gray worker)
    _RTT_FLOOR_S = 0.01
    _STEP_FLOOR_S = 0.01

    def _suspicion_of(self, h, now, rtt_base, step_base):
        """phi-accrual staleness (heartbeat age vs the worker's own
        EWMA inter-arrival, with a 3x grace so probe-join jitter stays
        quiet) + heartbeat-RTT ratio vs the fleet + decode-step-p99
        ratio vs the fleet, each contributing only its excess over 1x
        and each fleet baseline floored at an absolute latency below
        which ratios are noise. Relative terms catch the 10x-slow gray
        worker; the staleness term catches the silent one."""
        s = max(0.0, (now - h.last_ok)
                / max(3.0 * h.ewma_interval, 3.0 * self.health_interval_s,
                      1e-3) - 1.0)
        if h.ewma_rtt is not None and rtt_base is not None:
            s += max(0.0, h.ewma_rtt / max(rtt_base, self._RTT_FLOOR_S)
                     - 1.0)
        if h.step_p99 and step_base is not None:
            s += max(0.0, h.step_p99 / max(step_base, self._STEP_FLOOR_S)
                     - 1.0)
        return s

    def _evaluate_health(self, now):
        """Threshold every ledger into healthy/suspect/dark, export the
        gauges, record transitions as replayable decisions, and act:
        entering suspect/dark migrates the worker's streams (and dark
        leaves placement); a healthy answer from a dead/dark worker
        REJOINS it — `_mark_dead` is no longer forever."""
        with self._lock:
            ledgers = dict(self._health)
            draining = set(self._draining_workers)
            live = set(self._live)
        rtts = {i: h.ewma_rtt for i, h in ledgers.items()
                if h.ewma_rtt is not None and i not in draining}
        steps = {i: h.step_p99 for i, h in ledgers.items()
                 if h.step_p99 and i not in draining}
        for i, h in sorted(ledgers.items()):
            if i in draining:
                continue             # rolling_drain owns these
            rtt_base = _median([v for j, v in rtts.items() if j != i])
            step_base = _median([v for j, v in steps.items() if j != i])
            s = self._suspicion_of(h, now, rtt_base, step_base)
            inputs = {"worker": i, "suspicion": round(s, 6),
                      "suspect_threshold": self.suspect_threshold,
                      "dark_threshold": self.dark_threshold,
                      "reachable": bool(h.reachable)}
            state = _dec.replay_health(inputs)
            with self._lock:
                h.suspicion = s
                old = h.state
                h.state = state
            _M_SUSPICION.labels(worker=str(i)).set(round(s, 6))
            _M_STATE.labels(worker=str(i)).set(_STATE_LEVELS[state])
            reinstate = (state == "healthy" and h.reachable
                         and i not in live)
            if state != old:
                self._decide_fleet(
                    "health", inputs,
                    {"state": state, "from": old,
                     "reinstated": bool(reinstate)})
            if state == "dark":
                self._mark_dead(i)
            if state != "healthy" and old == "healthy" \
                    and self.proactive_migration:
                self._migrate_worker(i, "suspect")
            if reinstate:
                if state == old:
                    # no threshold transition (e.g. a poll blip called
                    # _mark_dead while the ledger stayed healthy): the
                    # rejoin is still an auditable health event
                    self._decide_fleet("health", inputs,
                                       {"state": state,
                                        "reinstated": True})
                with self._lock:
                    self._live.add(i)
                    live.add(i)

    # -- proactive migration --------------------------------------
    def _migrate_worker(self, i, reason):
        """Move every live stream off worker i before its deadlines
        burn. reason='suspect' (health-plane trigger: i crossed out of
        healthy) or 'drain' (rolling_drain trigger)."""
        with self._lock:
            victims = [r for r in self._inflight.values()
                       if not r.done() and r.worker == i]
            eligible = sorted(
                w for w in self._live - self._draining_workers - {i}
                if self._health[w].state == "healthy")
            state = "drain" if reason == "drain" else self._health[i].state
        for req in victims:
            self._migrate(req, i, reason, state, eligible)

    def _migrate(self, req, from_worker, reason, state, eligible):
        """Migrate ONE stream: fold delivered tokens into the restart
        prompt (the failover rule — bit-exact under temperature>0 via
        the stable rng_seed + delivered count), cancel the original
        copy fire-and-forget (the source may be slow; its slot frees
        when the cancel lands), and re-place preferring an
        OP_KV_EXPORT wire-restore of the prefix chain off the source
        while it is still alive. The decision records the migrate rule
        inputs (decisions.replay_migrate) plus the measured latency."""
        inputs = {"from_worker": from_worker, "state": state,
                  "reason": reason,
                  "tokens_remaining": req.max_new - len(req.tokens),
                  "eligible_workers": list(eligible)}
        if not _dec.replay_migrate(inputs):
            # nearly-done stream or nowhere healthy to go: let it ride
            self._decide("migrate", req, inputs, {"migrated": False})
            return False
        t0 = time.monotonic()
        _M_MIGRATIONS.labels(reason=reason).inc()
        req.failovers += 1
        req.trail.begin(_rt.PH_FAILOVER, t0)
        old_key = req._wire_key
        req._base = req.tokens
        req._cur = []
        req._wire_key = f"{req.key}.m{req.failovers}"
        threading.Thread(target=self._cancel_on_worker,
                         args=(from_worker, old_key), daemon=True).start()
        try:
            self._place(req, restore_from=from_worker
                        if state != "dark" else None)
        except NoWorkersError as e:
            req.status = ERROR
            req.error = str(e)
            self._finalize_timeline(req)
        self._decide("migrate", req, inputs,
                     {"migrated": True, "to": req.worker,
                      "latency_s": round(time.monotonic() - t0, 6)})
        return True

    def _cancel_on_worker(self, i, key):
        """Best-effort release of a migrated/drained stream's original
        copy (rides the hedge twin so a slow source never blocks the
        primary poll socket). Failure is fine: the copy expires at its
        deadline or is shed when the worker drains."""
        try:
            self._hedge.poll(i, [], cancel=[key])
        except Exception:                                # noqa: BLE001
            pass

    def _remote_prefill(self, req, decode_i, exec_prompt):
        """Remote prefill + handoff toward `decode_i`. Returns
        (staged, handoff_s): staged=True when the bundle landed on the
        decode worker, False degrades to decode-local recompute (dead
        prefill pool, chaos on the handoff path...); handoff_s is the
        prefill worker's measured KVPUT wall time, which _place uses to
        split the observed PREFILL interval into prefill vs kv_handoff
        timeline segments."""
        if self.prefill is None:
            return False, 0.0
        target = self.decode.endpoints[decode_i]
        for _ in range(len(self.prefill.endpoints)):
            with self._lock:
                i = self._prefill_rr % len(self.prefill.endpoints)
                self._prefill_rr += 1
            try:
                reply = self.prefill.prefill(
                    i, req._wire_key, exec_prompt,
                    decode_endpoint=target, rng_seed=req.rng_seed,
                    rng_gen=len(req.tokens), tenant=req.tenant,
                    cohort=req.cohort,
                    namespace=req.prefix_namespace,
                    deadline_left_s=req.deadline_left())
                return True, float(reply.get("handoff_s") or 0.0)
            except (_rpc.PSUnavailableError, _rpc.PSServerError):
                continue             # next prefill worker, else fallback
        return False, 0.0

    def submit(self, prompt, max_new=16, priority="standard",
               timeout_s=None, rng_seed=None, tenant=None, cohort=None,
               adapter_id=None, prefix_namespace=None):
        req = DistRequest(prompt, max_new, priority, timeout_s=timeout_s,
                          rng_seed=rng_seed, tenant=tenant, cohort=cohort,
                          adapter_id=adapter_id,
                          prefix_namespace=prefix_namespace)
        self._place(req)                 # RPCs happen OUTSIDE the lock
        with self._lock:
            self._inflight[req.key] = req
        return req

    def _place(self, req, restore_from=None):
        """(Re-)place a request on a live decode worker (fresh submits,
        failover restarts, migrations — `restore_from` names a still-
        alive source worker whose prefix chain should be wire-restored
        to the new placement). Does its own fine-grained locking —
        never called with the frontend lock held."""
        exec_prompt = req.prompt + req.tokens
        remaining = req.max_new - len(req.tokens)
        while True:
            # deadline propagation: a budget that expired
            # before placement is a ROUTER-side miss — fail fast, do
            # not burn a worker slot on undeliverable work
            left = req.deadline_left()
            if left is not None and left <= 0.0:
                _M_DEADLINE_MISS.labels(where="router").inc()
                req.status = TIMEOUT
                self._finalize_timeline(req)
                return
            # NoWorkersError when dark; `loads` (+ affinity `matches`)
            # are the decision inputs
            decode_i, loads, matches = self._pick_decode(req, exec_prompt)
            t0 = time.monotonic()
            staged, handoff_s = self._remote_prefill(req, decode_i,
                                                     exec_prompt)
            t1 = time.monotonic()
            # cross-host prefix restore: when affinity found
            # a chain owner but placement landed elsewhere (load slack)
            # — and no full prefill bundle is already staged — ship the
            # owner's chain to the chosen worker's staging area. Any
            # failure restores nothing: the local prefill recomputes.
            restored_from = None
            if not staged:
                owner = None
                if matches:
                    owner = next(
                        (w for w in sorted(matches)
                         if matches[w] >= self.affinity_min_match
                         and matches[w] == max(matches.values())), None)
                if owner is None and restore_from is not None:
                    # migration preference: the gray source
                    # still holds the stream's whole prefix chain —
                    # wire-restore beats recomputing it on the target
                    owner = restore_from
                if owner is not None and owner != decode_i:
                    try:
                        reply = self.decode.kv_export(
                            owner, req._wire_key, exec_prompt,
                            decode_endpoint=self.decode.endpoints[
                                decode_i],
                            namespace=req.prefix_namespace,
                            tenant=req.tenant)
                        if reply.get("ok"):
                            restored_from = owner
                    except (_rpc.PSUnavailableError, _rpc.PSServerError):
                        pass
            t2 = time.monotonic()
            # timeline: seal the open queue/failover segment at the
            # placement start, then account the measured intervals —
            # a SUCCESSFUL remote prefill splits into prefill vs
            # kv_handoff (the worker reports its KVPUT wall time) and
            # the SUBMIT round-trip is `place`. A FAILED sweep (dead
            # prefill pool, chaos) folds into `place` instead: no
            # prefill ran there, and labeling the retry budget
            # `prefill` would point the p99 tail attribution at
            # prefill compute instead of the dark pool — the real
            # prefill cost then shows up decode-local in
            # worker_phases. Contiguous boundaries keep the
            # phases-sum-to-e2e invariant exact.
            req.trail.close(t0)
            place_from = t0
            if staged:
                h = min(max(handoff_s, 0.0), t1 - t0)
                req.trail.append(_rt.PH_PREFILL, t0, t1 - h)
                if h > 0.0:
                    req.trail.append(_rt.PH_KV_HANDOFF, t1 - h, t1)
                place_from = t1
            if restored_from is not None:
                # the wire restore is its own named phase: the owner's
                # export + KVPUT wall time, visible in the request's
                # latency decomposition like prefill/kv_handoff are
                req.trail.append(_rt.PH_KV_RESTORE, place_from, t2)
                place_from = t2
            # the affinity decision inputs ride every place record so
            # the validator replays the same rule the sweep used
            dec_inputs = {"loads": loads, "staged": staged}
            if matches is not None:
                dec_inputs.update(
                    {"matches": matches,
                     "min_match": self.affinity_min_match,
                     "load_slack": self.affinity_load_slack})
            try:
                # rng_gen = tokens already DELIVERED: the worker samples
                # this placement's first token at that stream position,
                # so a temperature>0 failover restart replays exactly
                left = req.deadline_left()
                reply = self.decode.submit(
                    decode_i, req._wire_key, exec_prompt,
                    max_new=remaining, priority=req.priority,
                    timeout_s=left if left is not None else req.timeout_s,
                    use_staged=staged or restored_from is not None,
                    rng_seed=req.rng_seed, rng_gen=len(req.tokens),
                    tenant=req.tenant, cohort=req.cohort,
                    adapter_id=req.adapter_id,
                    prefix_namespace=req.prefix_namespace,
                    deadline_left_s=left)
            except _rpc.PSUnavailableError:
                now = time.monotonic()
                req.trail.append(_rt.PH_PLACE, place_from, now)
                req.trail.begin(_rt.PH_QUEUE, now)
                self._mark_dead(decode_i)
                # the failed attempt is auditable too: the load table
                # named this worker, the SUBMIT found it dark
                self._decide("place", req, dec_inputs,
                             {"worker": decode_i, "ok": False,
                              "error": "decode worker unavailable"})
                req._wire_key = f"{req.key}.p{req.failovers}" \
                                f".{decode_i}x"
                # the re-place is a router-initiated retry: it draws
                # from the failed worker's budget, so a flapping fleet
                # fast-fails instead of cycling placements forever
                if not self._budget_take(decode_i, "replace", req=req):
                    req.status = ERROR
                    req.error = f"retry budget exhausted re-placing " \
                                f"off worker {decode_i}"
                    self._finalize_timeline(req)
                    return
                continue
            except _rpc.PSServerError as e:
                msg = str(e)
                now = time.monotonic()
                if "draining" in msg:
                    # a deliberate refusal, not a failure: the worker
                    # entered drain after placement chose it. Re-route
                    # without marking dead or charging retry budget.
                    req.trail.append(_rt.PH_PLACE, place_from, now)
                    req.trail.begin(_rt.PH_QUEUE, now)
                    with self._lock:
                        self._draining_workers.add(decode_i)
                    self._decide("place", req, dec_inputs,
                                 {"worker": decode_i, "ok": False,
                                  "error": "draining"})
                    req._wire_key = f"{req.key}.p{req.failovers}" \
                                    f".{decode_i}x"
                    continue
                if "[fault-injection]" in msg:
                    # an in-band gray error (flaky worker): retryable,
                    # but only within the worker's retry budget
                    req.trail.append(_rt.PH_PLACE, place_from, now)
                    req.trail.begin(_rt.PH_QUEUE, now)
                    self._decide("place", req, dec_inputs,
                                 {"worker": decode_i, "ok": False,
                                  "error": "flaky"})
                    req._wire_key = f"{req.key}.p{req.failovers}" \
                                    f".{decode_i}x"
                    if not self._budget_take(decode_i, "flaky_retry",
                                             req=req):
                        req.status = ERROR
                        req.error = f"retry budget exhausted: {msg}"
                        self._finalize_timeline(req)
                        return
                    continue
                raise                # contract errors (queue full,
                                     # validation) stay the caller's
            if reply and not reply.get("ok", 1) \
                    and reply.get("deadline_missed"):
                # the worker shed it: budget expired in flight (the
                # worker already counted the where="worker" miss)
                now = time.monotonic()
                req.trail.append(_rt.PH_PLACE, place_from, now)
                self._decide("place", req, dec_inputs,
                             {"worker": decode_i, "ok": False,
                              "error": "deadline_missed"})
                req.status = TIMEOUT
                self._finalize_timeline(req)
                return
            now = time.monotonic()
            req.trail.append(_rt.PH_PLACE, place_from, now)
            req.trail.begin(_rt.PH_DECODE, now)
            req.worker = decode_i
            req.staged = staged
            req.status = RUNNING
            self._decide("place", req,
                         dict(dec_inputs,
                              tokens_delivered=len(req.tokens)),
                         {"worker": decode_i, "ok": True,
                          "staged": staged,
                          "restored_from": restored_from})
            return

    # -- streaming / failover ------------------------------------------------
    def pump(self):
        """One poll round: batch-fetch every live request's stream from
        its worker, merge tokens, finalize terminal ones — and fail over
        everything a dead worker was carrying. Returns the number of
        requests still in flight."""
        with self._lock:
            by_worker = {}
            for req in self._inflight.values():
                if not req.done():
                    by_worker.setdefault(req.worker, []).append(req)
        for i, reqs in sorted(by_worker.items()):
            keys = [r._wire_key for r in reqs]
            # propagated deadlines ride the poll: the worker expires
            # overdue streams server-side instead of holding slots
            deads = {r._wire_key: round(r.deadline_left(), 6)
                     for r in reqs if r.deadline is not None}
            with self._lock:
                suspect = i in self._health \
                    and self._health[i].state != "healthy"
            try:
                if suspect:
                    # a poll against a suspect worker gets the hedged
                    # duplicate: one stalled socket must not stall the
                    # whole pump round
                    polled = self._hedged_call(
                        "POLL", i,
                        lambda c, i=i, keys=keys, deads=deads:
                        c.poll(i, keys, deadlines=deads or None))
                else:
                    t0 = time.monotonic()
                    polled = self.decode.poll(i, keys,
                                              deadlines=deads or None)
                    self._note_rtt(time.monotonic() - t0)
            except (_rpc.PSUnavailableError, ConnectionError):
                self._mark_dead(i)
                for req in reqs:
                    self._failover(req)
                continue
            except _rpc.PSServerError:
                # in-band gray error (flaky serve path): the worker is
                # alive — skip this round, the next poll retries
                continue
            for req in reqs:
                self._merge(req, polled.get(req._wire_key))
        # the health plane rides the pump cadence (interval-gated)
        self._maybe_health_sweep()
        plane = self.fleet_plane
        if plane is not None:
            # the fleet plane rides the existing poll loop: one
            # interval-gated OP_METRICS federation sweep per pump.
            # Observation must never kill token delivery — a failed
            # sweep (full disk under the jsonl stream, a member
            # shipping a malformed snapshot) skips this round
            try:
                plane.maybe_poll()
            except Exception:                            # noqa: BLE001
                pass
        with self._lock:
            return sum(1 for r in self._inflight.values()
                       if not r.done())

    def _merge(self, req, view):
        if not view:
            return
        status = view.get("status")
        if status == "UNKNOWN":
            # worker restarted / lost the key: recompute elsewhere
            self._failover(req)
            return
        req._cur = [int(t) for t in view.get("tokens", [])]
        if req._cur and req.first_token_at is None:
            req.first_token_at = time.monotonic()
        if status in _TERMINAL:
            if status == ERROR:
                req.error = view.get("error")
            req.status = status
            self._finalize_timeline(req, view)

    def _failover(self, req):
        """Restart `req` on a live worker, recompute-style: everything
        already DELIVERED to the caller is folded into the restart
        prompt, so the merged greedy stream continues bit-identically.
        Tokens the dead worker generated but never got polled are simply
        regenerated — exactly, by determinism."""
        _M_FAILOVER.inc()
        req.failovers += 1
        # the hop gets its own named timeline phase: opens at detection
        # (the failed poll / UNKNOWN answer) and seals when the
        # re-placement's prefill starts inside _place — so a SIGKILLed
        # worker's victims show `failover` between two decode segments
        req.trail.begin(_rt.PH_FAILOVER, time.monotonic())
        dead = req.worker
        req._base = req.tokens
        req._cur = []
        req._wire_key = f"{req.key}.f{req.failovers}"
        # the hop's audit record: same key/tenant/trace_id
        # as the request's timeline, so "why did tenant A's stream move
        # hosts" joins its latency decomposition in one grep
        self._decide("failover", req,
                     {"dead_worker": dead,
                      "tokens_delivered": len(req._base),
                      "failovers": req.failovers,
                      "live_workers": self.live_decode_workers()},
                     {"restart": req.max_new - len(req._base) >= 1})
        if req.max_new - len(req._base) < 1:
            req.status = DONE          # it raced its own completion
            self._finalize_timeline(req)
            return
        # the restart is a router-initiated retry charged to the worker
        # that failed: a flapping worker exhausts its own
        # budget and its victims fast-fail instead of retry-storming
        if dead is not None and not self._budget_take(dead, "failover",
                                                      req=req):
            req.status = ERROR
            req.error = f"retry budget exhausted failing over off " \
                        f"worker {dead}"
            self._finalize_timeline(req)
            return
        try:
            self._place(req)
        except NoWorkersError as e:
            req.status = ERROR
            req.error = str(e)
            self._finalize_timeline(req)

    def _finalize_timeline(self, req, view=None):
        """Seal the request's phase trail and emit its reqtimeline.v1
        record, joining the serving worker's own trail (`worker_phases`,
        shipped on the terminal POLL) when the worker reported one.
        Idempotent: a request finalizes exactly once."""
        if req._timeline_done:
            return
        req._timeline_done = True
        req.finished_at = time.monotonic()
        req.trail.close(req.finished_at)
        rec = _rt.build_record(
            req.status, req.submitted_at, req.finished_at,
            req.trail.rel(req.submitted_at), key=req.key,
            tokens=len(req.tokens), ttft_s=req.ttft_s,
            failovers=req.failovers, worker=req.worker,
            adopted=bool((view or {}).get("adopted")),
            trace_id=req.trace_id,
            worker_phases=(view or {}).get("phases"),
            tenant=req.tenant, cohort=req.cohort)
        with self._lock:
            self._timeline.append(rec)
        self._append_stream(rec)

    def timeline_records(self):
        """The reqtimeline.v1 records of every finalized request so far
        — what bench/tests read without re-parsing the JSONL."""
        with self._lock:
            return list(self._timeline)

    def run(self, timeout_s=120.0, poll_interval_s=0.01):
        """Pump until every submitted request is terminal (or the
        timeout lapses); returns the inflight dict."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.pump() == 0:
                break
            time.sleep(poll_interval_s)
        return dict(self._inflight)

    def results(self):
        return {k: r for k, r in self._inflight.items()}

    # -- rolling drain -------------------------------------------------------
    def _worker_index(self, w):
        """Accept a decode worker index or its endpoint string."""
        if isinstance(w, int):
            return w
        return self.decode.endpoints.index(str(w))

    def drain_worker(self, i, migrate=True):
        """Put decode worker i into drain: excluded from placement,
        OP_DRAIN stops its admission, and (by default) its live streams
        migrate to healthy peers. Returns the worker's status reply
        (or an error dict when it is unreachable)."""
        i = self._worker_index(i)
        with self._lock:
            self._draining_workers.add(i)
            inflight = sum(1 for r in self._inflight.values()
                           if not r.done() and r.worker == i)
        try:
            reply = self.decode.drain(i, enter=True)
        except (_rpc.PSUnavailableError, _rpc.PSServerError,
                ConnectionError) as e:
            reply = {"ok": 0, "error": str(e)}
        self._decide_fleet("drain",
                           {"worker": i, "phase": "enter",
                            "router_inflight": inflight},
                           {"entered": bool(reply.get("ok"))})
        if migrate:
            self._migrate_worker(i, "drain")
        return reply

    def resume_worker(self, i):
        """Undo drain: OP_DRAIN(enter=False) re-opens admission and the
        worker rejoins placement."""
        i = self._worker_index(i)
        try:
            reply = self.decode.drain(i, enter=False)
        except (_rpc.PSUnavailableError, _rpc.PSServerError,
                ConnectionError) as e:
            reply = {"ok": 0, "error": str(e)}
        with self._lock:
            self._draining_workers.discard(i)
            if reply.get("ok"):
                self._live.add(i)
        self._decide_fleet("drain", {"worker": i, "phase": "resume"},
                           {"resumed": bool(reply.get("ok"))})
        return reply

    def rolling_drain(self, workers=None, timeout_s=30.0,
                      poll_interval_s=0.02):
        """Zero-drop rolling restart over `workers` (indices or
        endpoint strings; default every decode worker), one at a time:
        drain -> migrate its streams -> pump until the worker reports
        zero in-flight -> resume -> next. The scale-down primitive: at
        every instant at most one worker is out of placement, no
        admitted request is dropped (migration is the bit-exact
        failover rule), and every step is a decisions.v1
        `drain`/`migrate` record. Returns {endpoint: report}."""
        if workers is None:
            workers = list(range(len(self.decode.endpoints)))
        report = {}
        for w in workers:
            i = self._worker_index(w)
            t0 = time.monotonic()
            self.drain_worker(i)
            drained = False
            deadline = t0 + timeout_s
            while time.monotonic() < deadline:
                self.pump()
                try:
                    status = self.decode.drain(i)
                except (_rpc.PSUnavailableError, _rpc.PSServerError,
                        ConnectionError):
                    break            # died mid-drain: poll failover
                                     # already re-placed its streams
                if not status.get("inflight"):
                    drained = True
                    break
                time.sleep(poll_interval_s)
            self.resume_worker(i)
            wall = time.monotonic() - t0
            self._decide_fleet("drain",
                               {"worker": i, "phase": "drained",
                                "timeout_s": timeout_s},
                               {"drained": drained,
                                "wall_s": round(wall, 6)})
            report[self.decode.endpoints[i]] = {
                "drained": drained, "wall_s": wall}
        return report

    # -- control plane -------------------------------------------------------
    def swap_all(self, path, version=None):
        """Push a committed checkpoint into every live worker (decode
        pools first, then prefill — new requests may briefly prefill
        under old weights, which the recompute fallback already
        tolerates). Returns {endpoint: reply}."""
        out = {}
        for i in self.live_decode_workers():
            try:
                out[self.decode.endpoints[i]] = self.decode.swap(
                    i, path, version)
            except (_rpc.PSUnavailableError, _rpc.PSServerError) as e:
                out[self.decode.endpoints[i]] = {"ok": False,
                                                 "error": str(e)}
        if self.prefill is not None:
            for i in range(len(self.prefill.endpoints)):
                try:
                    out[self.prefill.endpoints[i]] = self.prefill.swap(
                        i, path, version)
                except (_rpc.PSUnavailableError, _rpc.PSServerError) as e:
                    out[self.prefill.endpoints[i]] = {
                        "ok": False, "error": str(e)}
        return out

    def stats(self):
        out = {}
        for i in self.live_decode_workers():
            try:
                out[self.decode.endpoints[i]] = self.decode.stat(i)
            except (_rpc.PSUnavailableError, _rpc.PSServerError) as e:
                out[self.decode.endpoints[i]] = {"error": str(e)}
        if self.prefill is not None:
            for i in range(len(self.prefill.endpoints)):
                try:
                    out[self.prefill.endpoints[i]] = self.prefill.stat(i)
                except (_rpc.PSUnavailableError, _rpc.PSServerError) as e:
                    out[self.prefill.endpoints[i]] = {"error": str(e)}
        return out

    def stop_workers(self):
        self.decode.stop_servers()
        if self.prefill is not None:
            self.prefill.stop_servers()

    def close(self):
        self.decode.close()
        self._hedge.close()
        if self.prefill is not None:
            self.prefill.close()
