"""One serving host: an engine and a scheduler behind RPC verbs.

Counterpart of `paddle_tpu/serving/distributed/worker.py`, copied with
the verb numbers (16-27), the wire payloads and the metric families
unchanged, so a JAX router drives a port worker and a port router a JAX
worker. A `ServingWorker` wraps a serving engine (dense / paged /
speculative) and serves it on the RPC fabric (`distributed/ps/rpc.py`)
through extension verbs:

  PREFILL  (prefill role)  run a prompt's prefill, pack its KV bundle
           (`kv_handoff.pack_kv_bundle`, v3 with the sampler state when
           the request is seeded) and stream it to the target decode
           worker's staging area (KVPUT) under the caller's trace id;
           replies with the first token. Keyed by the router's request
           key: a retried PREFILL returns the cached result.
  KVPUT    (decode role)   stage a KV bundle for a key (idempotent
           overwrite; a truncated bundle is refused with an in-band
           error frame, never adopted torn).
  SUBMIT   (decode role)   admit a request, from its staged bundle
           (`use_staged`) or by a local prefill. A retried SUBMIT of a
           live key is a no-op.
  POLL     (decode role)   batch {status, tokens} for keys (the router's
           stream pump); carries cancels and deadline budgets.
  SWAP     (both roles)    load a committed checkpoint
           (`framework.ckpt_commit`) and apply it between decode steps
           (`Scheduler.schedule_weight_swap`; the swap copies into the
           engine's own storage, so no graph is captured again); the
           reply carries the outcome, and `serving_model_version` flips.
  STAT     (both roles)    queue depth, active slots, pool occupancy,
           model version, handoff bytes: a projection of one registry
           snapshot, plus `trace_counts`, which the port answers with
           the engine's CUDA-graph capture counts.
  METRICS  (both roles)    the worker's whole `paddle_tpu.metrics.v1`
           registry snapshot, the input `observability/fleet.py`
           federates. Read-only.
  DUMP     (both roles)    write and return the flight recorder's
           postmortem.
  PREFIXLOOKUP, KVEXPORT (decode role)  probe the prefix cache, tiered
           continuations included; export a servable chain (device pool
           entries and tier records, sha-verified) to a peer as a
           `prefix_only` bundle.
  HEALTH, DRAIN (both roles)  the router's heartbeat; admission stop for
           zero-drop rolling drains.

The decode role runs a background step loop (continuous batching through
the scheduler); the prefill role serves from its handler threads. Every
engine and scheduler call runs under the worker's one `RLock`, and the
paged-attention scope (`blocks.attention_impl`) is per thread. On the
card every executable must be captured (`engine.precompile()`) before
the worker starts serving: a CUDA-graph capture made while a handler
thread or the step loop issues CUDA work would be invalidated.
One process = one worker is the deployment shape (`worker_main.py`);
tests that host several workers in one process give each its own model
object. Faults: `serving.kv_handoff` fires in bundle pack/unpack,
`serving.weight_swap` inside `engine.swap_params`, `serving.rpc.serve`
in the fabric's server, keyed by endpoint.

`tenancy` (a `tenancy.TenancyConfig`) arms the decode scheduler's token
buckets, prefix-namespace quotas and tenant namespaces on this host. A
SUBMIT's `adapter_id` binds the engine's adapter row for it when the
engine has a bank attached that holds it (else the base weights).
"""
import json
import re
import threading
import time

import numpy as np

from ...distributed.checkpoint import load_state_dict, save_state_dict
from ...distributed.ps import rpc as _rpc
from ...framework import ckpt_commit as _ckpt
from ...observability import flight_recorder as _fr
from ...observability import metrics as _metrics
from ...observability import tracecontext as _tc
from ...profiler import RecordEvent, TracerEventType
from ..scheduler import TIMEOUT as _TIMEOUT
from ..scheduler import Scheduler, ServingConfig
from . import kv_handoff as _kv

__all__ = ["ServingWorker", "load_checkpoint_params",
           "save_swap_checkpoint", "OP_KV_PUT", "OP_PREFILL", "OP_SUBMIT",
           "OP_POLL", "OP_SWAP", "OP_STAT", "OP_METRICS", "OP_DUMP",
           "OP_PREFIX_LOOKUP", "OP_KV_EXPORT", "OP_HEALTH", "OP_DRAIN"]

# extension verbs on the PS fabric (< 0x40; see rpc.register_verb).
# All are retry-safe: keyed dedup (PREFILL/SUBMIT), idempotent
# overwrite (KVPUT/SWAP), or read-only (POLL/STAT/METRICS).
OP_KV_PUT = 16
OP_PREFILL = 17
OP_SUBMIT = 18
OP_POLL = 19
OP_SWAP = 20
OP_STAT = 21
OP_METRICS = 22
OP_DUMP = 23
# the fleet-global prefix cache: PREFIXLOOKUP answers "how
# many tokens of this prompt could you serve from your prefix cache?"
# — the router's affinity-placement probe; KVEXPORT reads the matched
# chain and streams it to a peer's staging area as a prefix_only bundle
OP_PREFIX_LOOKUP = 24
OP_KV_EXPORT = 25
# the gray-failure health plane: HEALTH is the router's
# suspicion heartbeat — a readonly projection of liveness signals
# (decode-step p99, queue depth, last-step age, drain flag); DRAIN
# toggles admission-stop for zero-drop rolling restarts (idempotent:
# re-entering the current drain state is a no-op status report)
OP_HEALTH = 26
OP_DRAIN = 27

for _op, _name in ((OP_KV_PUT, "KVPUT"), (OP_PREFILL, "PREFILL"),
                   (OP_SUBMIT, "SUBMIT"), (OP_POLL, "POLL"),
                   (OP_SWAP, "SWAP"), (OP_STAT, "STAT")):
    _rpc.register_verb(_op, _name, idempotent=True)
# the fleet observability sweep: METRICS is genuinely
# side-effect-free; DUMP writes a postmortem artifact but is retry-safe
# (bounded retention, every dump self-contained)
_rpc.register_verb(OP_METRICS, "METRICS", readonly=True)
_rpc.register_verb(OP_DUMP, "DUMP", idempotent=True)
# PREFIXLOOKUP is a pure probe; KVEXPORT re-reads + re-puts the same
# bytes on retry (idempotent overwrite at the receiver, like KVPUT)
_rpc.register_verb(OP_PREFIX_LOOKUP, "PREFIXLOOKUP", readonly=True)
_rpc.register_verb(OP_KV_EXPORT, "KVEXPORT", idempotent=True)
_rpc.register_verb(OP_HEALTH, "HEALTH", readonly=True)
_rpc.register_verb(OP_DRAIN, "DRAIN", idempotent=True)

# deadline budget rides the PREFILL/SUBMIT/POLL verbs:
# `where` splits router-side misses (budget gone before placement) from
# worker-side ones (a worker shed/expired work it could not finish) —
# the label the gray-chaos acceptance gate compares against its oracle
_M_DEADLINE_MISS = _metrics.counter(
    "serving_deadline_missed_total",
    "Requests whose propagated deadline budget expired, by side",
    labelnames=("where",))

_M_HANDOFF_S = _metrics.histogram(
    "serving_kv_handoff_seconds",
    "Wall time of one prefill->decode KV bundle transfer (sender side)")
_M_HANDOFF_BYTES = _metrics.counter(
    "serving_kv_handoff_bytes_total",
    "KV bundle bytes streamed from prefill to decode workers")
_M_MODEL_VERSION = _metrics.gauge("serving_model_version")

_DONE_CACHE_CAP = 1024               # per-worker keyed-result retention


class _HandoffLock:
    """A re-entrant lock that counts the threads waiting for it, so its
    holder can hand it over (`ServingWorker._step_loop`): Python's lock
    is not fair, and a loop that releases and re-takes it at once wins
    the race against a woken waiter now and then, costing that waiter a
    whole decode step each time it loses."""

    def __init__(self):
        self._lock = threading.RLock()
        self._count = threading.Lock()
        self.waiting = 0

    def acquire(self, blocking=True, timeout=-1):
        if self._lock.acquire(blocking=False):
            return True
        if not blocking:
            return False
        with self._count:
            self.waiting += 1
        try:
            return self._lock.acquire(True, timeout)
        finally:
            with self._count:
                self.waiting -= 1

    def release(self):
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


# the longest a busy loop holds off for a waiting handler before it steps
# again (a handler that never comes for the lock costs this once)
_HANDOFF_S = 0.05


def load_checkpoint_params(path):
    """Raw {name: np array} weights from a ckpt_commit-committed
    checkpoint (distributed/checkpoint.py layout) — digest-verified,
    torn checkpoints fall back per the shared resolution rules. The
    hot-swap source: only checkpoints that VERIFY can ever reach
    `engine.swap_params`."""
    return load_state_dict(path, return_numpy=True)


class ServingWorker:
    """One serving host process. role='decode' runs the step loop and
    admits traffic; role='prefill' computes prefills and streams KV
    bundles to decode workers. Both swap weights and report stats."""

    def __init__(self, model, engine, role="decode", serving_config=None,
                 host="127.0.0.1", port=0, version=0,
                 peer_client_kwargs=None, step_interval_s=0.0,
                 tenancy=None):
        if role not in ("decode", "prefill"):
            raise ValueError(f"role must be 'decode' or 'prefill', "
                             f"got {role!r}")
        self.role = role
        self.model = model
        self.engine = engine
        self.version = version
        self._lock = _HandoffLock()          # scheduler/engine guard
        self.loop_yields = 0                 # busy steps that yielded it
        self._requests = {}                  # key -> RequestHandle
        self._staged = {}                    # key -> (ks, vs, meta)
        self._prefill_done = {}              # key -> cached PREFILL reply
        self._peers = {}                     # endpoint -> client
        self._peer_kwargs = dict(peer_client_kwargs or {})
        # an optional decode-step pace (tests use it to hold a kill
        # window open; production leaves it 0)
        self.step_interval_s = float(step_interval_s)
        self._stop = threading.Event()
        # health plane: drain flag + the step loop's last-activity stamp
        # (OP_HEALTH's "last-step age": a wedged loop shows up as a
        # growing age even while RPC answers)
        self.draining = False
        self._last_step_at = time.monotonic()
        self.scheduler = Scheduler(engine, serving_config or ServingConfig(),
                                   device=engine.device, tenancy=tenancy) \
            if role == "decode" else None
        _M_MODEL_VERSION.set(float(version))
        handlers = {OP_SWAP: self._h_swap, OP_STAT: self._h_stat,
                    OP_METRICS: self._h_metrics, OP_DUMP: self._h_dump,
                    OP_HEALTH: self._h_health, OP_DRAIN: self._h_drain}
        if role == "decode":
            handlers.update({OP_KV_PUT: self._h_kv_put,
                             OP_SUBMIT: self._h_submit,
                             OP_POLL: self._h_poll,
                             OP_PREFIX_LOOKUP: self._h_prefix_lookup,
                             OP_KV_EXPORT: self._h_kv_export})
        else:
            handlers[OP_PREFILL] = self._h_prefill
        self.server = _rpc.PSServer(host=host, port=port, handlers=handlers)
        self._loop_thread = None
        if role == "decode":
            self._loop_thread = threading.Thread(target=self._step_loop,
                                                 daemon=True)
            self._loop_thread.start()

    @property
    def endpoint(self):
        return self.server.endpoint

    # -- the decode step loop ------------------------------------------------
    def _step_loop(self):
        """Continuous batching: step while there is work, sleep a hair
        when idle. A pending hot-swap is applied even on an idle host
        (apply_pending_swap outside step), so swaps never wait for
        traffic."""
        while not self._stop.is_set() and not self.server._stop.is_set():
            with self._lock:
                self.scheduler.apply_pending_swap()
                busy = self.scheduler.step()
            self._last_step_at = time.monotonic()
            if self.step_interval_s:
                time.sleep(self.step_interval_s)
            elif not busy:
                time.sleep(0.002)
            else:
                # yield between busy steps: the lock is not fair, and a
                # loop that re-takes it at once starves the handler
                # threads waiting on it (SUBMIT, POLL cancels, SWAP), so
                # the loop steps again only once they have taken it
                self.loop_yields += 1
                time.sleep(0)
                until = time.monotonic() + _HANDOFF_S
                while self._lock.waiting and time.monotonic() < until:
                    time.sleep(0.0002)

    def shutdown(self):
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)
        for client in self._peers.values():
            client.close()
        self.server.shutdown()

    def kill(self):
        """Host-death simulation for in-process chaos tests: halt the
        step loop AND sever every live connection mid-frame, so peers
        observe exactly what a SIGKILLed process would give them —
        resets, then refused connections. (Real deployments just die;
        tests that fork worker_main use an actual SIGKILL instead.)"""
        self._stop.set()
        self.server.shutdown()
        self.server.close_connections()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10)

    def serve_until_stopped(self, poll_s=0.05):
        """Block until a client sends OP_STOP (worker_main's main loop),
        then drain the step loop."""
        while not self.server._stop.is_set():
            time.sleep(poll_s)
        self.shutdown()

    # -- peers ---------------------------------------------------------------
    def _peer(self, endpoint):
        """A (cached) client to another worker — the prefill->decode
        handoff edge; rides the same retry/breaker fabric as every
        client."""
        client = self._peers.get(endpoint)
        if client is None:
            from .router import ServingShardClient
            client = ServingShardClient([endpoint], **self._peer_kwargs)
            self._peers[endpoint] = client
        return client

    # -- handlers (run on server connection threads) -------------------------
    def _h_prefill(self, body, aux, reqid, rctx):
        obj, _ = _kv.unpack_payload(body)
        key = obj["key"]
        cached = self._prefill_done.get(key)
        if cached is not None:               # retried PREFILL: replay
            return _kv.pack_payload(dict(cached, cached=True))
        if self.draining:
            # in-band error, NOT a dead connection: the router re-routes
            # without tripping the breaker or marking this host dead
            raise RuntimeError("worker is draining")
        left = obj.get("deadline_left_s")
        if left is not None and float(left) <= 0.0:
            # the propagated budget is gone — shed before burning a
            # prefill the caller can no longer use
            _M_DEADLINE_MISS.labels(where="worker").inc()
            raise RuntimeError("deadline budget exhausted before prefill")
        prompt = [int(t) for t in obj["prompt"]]
        # per-request sampler state: the router pins the
        # request's seed + delivered count, so this prefill's first
        # token is generation index `rng_gen` of THAT stream — and the
        # bundle ships the post-first-token state for the adopter
        rng = None
        if obj.get("rng_seed") is not None:
            rng = (int(obj["rng_seed"]), int(obj.get("rng_gen") or 0))
        # the attribution label reaches the prefill HOST too:
        # the remote prefill's span carries the request's tenant/cohort,
        # so a prefill-side trace attributes its compute like the decode
        # side's scheduler spans do
        with self._lock, RecordEvent(
                "serving::remote_prefill", TracerEventType.UserDefined,
                {"key": key, "tenant": obj.get("tenant") or "default",
                 "cohort": obj.get("cohort"), "prompt_len": len(prompt)}):
            slot = 0                          # one prefill at a time
            # the namespace rides the PREFILL frame: the
            # prefill host's prefix cache keys this prompt under the
            # request's tenant namespace, so cross-tenant prompts never
            # share blocks on the prefill side either
            pkw = {}
            if obj.get("namespace") is not None:
                pkw["namespace"] = obj["namespace"]
            first = self.engine.prefill(slot, prompt, rng=rng, **pkw)
            bundle_rng = self.engine.slot_rng(slot) \
                if rng is not None else None
            # quantization-aware: a kv_dtype="int8" engine ships the
            # int8 codes + per-block scales (a v2 bundle, ~1/4 the
            # bytes); float engines ship the v1 layout unchanged
            wire = self.engine.extract_kv_wire(slot)
            plen = wire["plen"]
            stats = dict(getattr(self.engine, "last_prefill_stats", {}))
            self.engine.reset_slot(slot)
        # the handoff: fire the chaos site, then stream the bundle to
        # the decode worker UNDER THE CALLER'S TRACE so the KVPUT spans
        # stitch into the router's timeline
        handoff_bytes = 0
        handoff_s = 0.0
        target = obj.get("decode_endpoint")
        if target:
            # serving.kv_handoff fires inside pack (sender end) and
            # inside the decode worker's unpack (receiver end)
            bundle = _kv.pack_kv_bundle(
                wire["ks"], wire["vs"],
                meta={"key": key, "plen": plen, "first_token": int(first)},
                k_scales=wire.get("k_scales"),
                v_scales=wire.get("v_scales"),
                scale_block=wire.get("scale_block"),
                rng=bundle_rng)
            t0 = time.perf_counter()
            scope = _tc.trace_scope(rctx[0]) if rctx is not None else None
            try:
                if scope is not None:
                    scope.__enter__()
                self._peer(target).kv_put(0, key, bundle)
            finally:
                if scope is not None:
                    scope.__exit__(None, None, None)
            handoff_s = time.perf_counter() - t0
            _M_HANDOFF_S.observe(handoff_s)
            _M_HANDOFF_BYTES.inc(len(bundle))
            handoff_bytes = len(bundle)
        result = {"first_token": int(first), "plen": int(plen),
                  "handoff_bytes": handoff_bytes,
                  # measured KVPUT wall time: lets the router split its
                  # one observed PREFILL interval into prefill vs
                  # kv_handoff timeline segments
                  "handoff_s": round(handoff_s, 6),
                  "prefix_hit_tokens": int(
                      stats.get("prefix_hit_tokens", 0) or 0)}
        self._prefill_done[key] = result
        self._trim(self._prefill_done)
        return _kv.pack_payload(result)

    def _h_kv_put(self, body, aux, reqid, rctx):
        obj, tail = _kv.unpack_payload(body)
        ks, vs, meta = _kv.unpack_kv_bundle(tail)   # validates; may raise
        self._staged[obj["key"]] = (ks, vs, meta)
        self._trim(self._staged)
        return _kv.pack_payload({"ok": 1, "bytes": len(tail)})

    def _h_submit(self, body, aux, reqid, rctx):
        obj, _ = _kv.unpack_payload(body)
        key = obj["key"]
        left = obj.get("deadline_left_s")
        if left is not None and float(left) <= 0.0:
            # worker-side deadline shed: the router's budget
            # expired in flight — refuse cleanly instead of admitting
            # work that can only TIMEOUT after consuming a slot
            _M_DEADLINE_MISS.labels(where="worker").inc()
            return _kv.pack_payload({"ok": 0, "deadline_missed": True})
        with self._lock:
            if key in self._requests:        # retried SUBMIT: no-op
                return _kv.pack_payload({"ok": 1, "dup": True})
            staged_kv = None
            staged_prefix = None
            if obj.get("use_staged"):
                staged = self._staged.pop(key, None)
                if staged is not None:
                    ks, vs, meta = staged
                    if meta.get("prefix_only"):
                        # a KVEXPORT bundle: a peer's cached
                        # PREFIX chain, not a finished prefill — it
                        # restores into the prefix cache ahead of this
                        # request's own local prefill
                        staged_prefix = (
                            ks, vs, int(meta.get("plen", len(ks[0]))),
                            meta.get("namespace"))
                    else:
                        staged_kv = (ks, vs,
                                     int(meta.get("plen", len(ks[0]))),
                                     int(meta.get("first_token", 0)))
                        if meta.get("rng") is not None:
                            # a v3 bundle: the prefill host's post-first-
                            # token sampler state rides into adoption
                            staged_kv += (tuple(meta["rng"]),)
            handle = self.scheduler.submit(
                [int(t) for t in obj["prompt"]],
                max_new_tokens=obj.get("max_new"),
                timeout_s=obj.get("timeout_s"),
                priority=obj.get("priority", "standard"),
                staged_kv=staged_kv,
                rng_seed=obj.get("rng_seed"),
                rng_gen=int(obj.get("rng_gen") or 0),
                tenant=obj.get("tenant"),
                cohort=obj.get("cohort"),
                adapter_id=obj.get("adapter_id"),
                prefix_namespace=obj.get("prefix_namespace"),
                staged_prefix=staged_prefix)
            self._requests[key] = handle
            self._trim_requests()
        return _kv.pack_payload({"ok": 1,
                                 "staged": staged_kv is not None,
                                 "staged_prefix":
                                     staged_prefix is not None})

    def _trim_requests(self):
        """Bound the handle map like the other keyed caches — but only
        TERMINAL handles may go (evicting a live key would make POLL
        answer UNKNOWN and trigger a spurious router failover). Oldest
        finished requests leave first; live handles always survive."""
        if len(self._requests) <= _DONE_CACHE_CAP:
            return
        for key in [k for k, h in self._requests.items() if h.done()]:
            if len(self._requests) <= _DONE_CACHE_CAP:
                break
            del self._requests[key]

    def _h_poll(self, body, aux, reqid, rctx):
        obj, _ = _kv.unpack_payload(body)
        # migration/drain cancels ride the poll verb: the
        # router has re-placed these streams elsewhere — release the
        # original copies' slots/KV now, not at their deadline
        for key in obj.get("cancel") or ():
            handle = self._requests.get(key)
            if handle is not None and not handle.done():
                with self._lock:
                    self.scheduler.cancel(handle)
        # propagated per-key deadline budgets: expire overdue work
        # server-side so a slow worker sheds instead of holding slots
        deadlines = obj.get("deadlines") or {}
        out = {}
        for key in obj["keys"]:
            handle = self._requests.get(key)
            left = deadlines.get(key)
            if handle is not None and not handle.done() \
                    and left is not None and float(left) <= 0.0:
                with self._lock:
                    if self.scheduler.cancel(handle, status=_TIMEOUT):
                        _M_DEADLINE_MISS.labels(where="worker").inc()
            if handle is None:
                out[key] = {"status": "UNKNOWN", "tokens": []}
            else:
                out[key] = {"status": handle.status,
                            "tokens": [int(t) for t in handle.tokens],
                            "error": handle.error,
                            "adopted": handle.adopted}
                if handle.done():
                    # terminal only: the worker's own phase trail rides
                    # the LAST poll, so the router can join it into the
                    # request's fleet timeline as `worker_phases`
                    # without bloating every poll round
                    out[key]["phases"] = handle.phases
        return _kv.pack_payload(out)

    def _h_prefix_lookup(self, body, aux, reqid, rctx):
        """OP_PREFIX_LOOKUP: how many tokens of `prompt` this worker
        could serve from its prefix cache, counting the device pool's
        entries and their tiered continuations. Genuinely read-only (no
        refs, LRU touches, or promotion), so the router can probe every
        shard per placement without perturbing cache state anywhere."""
        obj, _ = _kv.unpack_payload(body)
        probe = getattr(self.engine, "prefix_probe", None)
        n = 0
        if probe is not None:
            with self._lock:
                n = int(probe([int(t) for t in obj["prompt"]],
                              obj.get("namespace")))
        return _kv.pack_payload({"match_tokens": n})

    def _h_kv_export(self, body, aux, reqid, rctx):
        """OP_KV_EXPORT: read this worker's servable chain for `prompt`
        (the device pool's entries and their tiered continuation, tier
        records sha-verified on the way) and stream it
        to the target peer's staging area as a `prefix_only` KV bundle
        under the caller's trace — the cross-host restore edge of the
        fleet-global prefix cache. The chain stays resident here; the
        peer registers a COPY. Retry-safe: a retried export re-reads
        and re-puts the same bytes (idempotent overwrite, like KVPUT)."""
        obj, _ = _kv.unpack_payload(body)
        key = obj["key"]
        ns = obj.get("namespace")
        extract = getattr(self.engine, "extract_prefix_kv", None)
        if extract is None:
            return _kv.pack_payload({"ok": 0, "plen": 0, "bytes": 0})
        with self._lock, RecordEvent(
                "serving::kv_export", TracerEventType.UserDefined,
                {"key": key, "tenant": obj.get("tenant") or "default"}):
            ks, vs, plen = extract([int(t) for t in obj["prompt"]],
                                   namespace=ns)
        if plen < 1:
            return _kv.pack_payload({"ok": 0, "plen": 0, "bytes": 0})
        bundle = _kv.pack_kv_bundle(
            ks, vs, meta={"key": key, "plen": int(plen),
                          "prefix_only": True, "namespace": ns})
        sent = 0
        target = obj.get("decode_endpoint")
        if target:
            scope = _tc.trace_scope(rctx[0]) if rctx is not None else None
            try:
                if scope is not None:
                    scope.__enter__()
                self._peer(target).kv_put(0, key, bundle)
            finally:
                if scope is not None:
                    scope.__exit__(None, None, None)
            _M_HANDOFF_BYTES.inc(len(bundle))
            sent = len(bundle)
        return _kv.pack_payload({"ok": 1, "plen": int(plen),
                                 "bytes": sent})

    def _inflight(self):
        """Live (non-terminal) streams this worker still owns — the
        figure the drain orchestrator waits to hit zero."""
        return sum(1 for h in self._requests.values() if not h.done())

    def _h_health(self, body, aux, reqid, rctx):
        """OP_HEALTH: the router's suspicion heartbeat. A
        readonly THIN PROJECTION of one registry snapshot plus live
        loop state — decode-step p99, queue depth, last-step age, drain
        flag, in-flight count. Answering it is deliberately cheap and
        lock-free on the decode path: a worker whose STEP loop is
        wedged still answers (the growing `last_step_age_s` is the
        signal), while a worker whose RPC plane is gray answers slowly
        (the heartbeat RTT is the signal)."""
        snap = _metrics.registry().snapshot()
        flat = _metrics.flatten_snapshot(snap)
        out = {"role": self.role, "endpoint": self.endpoint,
               "version": self.version,
               "draining": bool(self.draining),
               "queue_depth": int(flat.get("serving_queue_depth", 0)),
               "decode_step_p99_s": _hist_p99(
                   snap, "serving_decode_step_seconds"),
               "inflight": self._inflight()}
        if self.role == "decode":
            out["last_step_age_s"] = round(
                time.monotonic() - self._last_step_at, 6)
        return _kv.pack_payload(out)

    def _h_drain(self, body, aux, reqid, rctx):
        """OP_DRAIN: admission-stop for zero-drop rolling
        restarts. `enter=True` stops admitting (SUBMIT answers an
        in-band "draining" error the router re-routes on; in-flight
        streams keep decoding), `enter=False` reinstates, `enter`
        absent/None is a pure status query. Idempotent by construction:
        re-asserting the current state changes nothing."""
        obj, _ = _kv.unpack_payload(body)
        enter = obj.get("enter")
        if enter is not None:
            self.draining = bool(enter)
            if self.scheduler is not None:
                with self._lock:
                    self.scheduler.set_draining(bool(enter))
        return _kv.pack_payload({"ok": 1, "draining": bool(self.draining),
                                 "inflight": self._inflight()})

    def _h_swap(self, body, aux, reqid, rctx):
        obj, _ = _kv.unpack_payload(body)
        version = obj.get("version")
        params = load_checkpoint_params(obj["path"])
        if self.scheduler is not None:
            ev = self.scheduler.schedule_weight_swap(params, version)
            # the loop applies it between decode steps (idle included)
            if not ev.wait(timeout=float(obj.get("apply_timeout_s", 30))):
                raise TimeoutError("weight swap not applied in time")
            result = dict(getattr(ev, "swap_result", None)
                          or self.scheduler.last_swap or {})
        else:
            with self._lock:
                try:
                    n = self.engine.swap_params(params)
                except Exception as e:                   # noqa: BLE001
                    result = {"ok": False, "version": version,
                              "error": f"{type(e).__name__}: {e}"}
                else:
                    result = {"ok": True, "version": version, "params": n}
        if result.get("ok"):
            self.version = version if version is not None else self.version
            _M_MODEL_VERSION.set(float(self.version))
        return _kv.pack_payload(result)

    def _parallel_shape(self):
        """{"tp", "pp", "devices": {shard: device}} of the engine."""
        ecfg = self.engine.config
        shards = getattr(self.engine, "kv_shard_report", None)
        devices = {name: rec["device"] for name, rec in shards().items()} \
            if shards is not None else \
            {"engine": str(getattr(self.engine, "device", "cpu"))}
        return {"tp": int(getattr(ecfg, "tp", 1)),
                "pp": int(getattr(ecfg, "pp", 1)), "devices": devices}

    def _h_stat(self, body, aux, reqid, rctx):
        """The hand-picked health/placement signals — wire shape
        unchanged, but every serving figure is now a THIN PROJECTION of
        ONE metrics-registry snapshot: the same snapshot
        OP_METRICS ships whole, so STAT can never drift from what the
        fleet federation sees. Engine-derived fields (KV budget, trace
        counters, block occupancy) stay direct reads of live engine
        state — they are not bookkeeping, they ARE the state. The
        registry is process-global, matching the one-process-per-worker
        deployment shape (module docstring); tests hosting several
        workers in one process share these figures."""
        flat = _metrics.flatten_snapshot(_metrics.registry().snapshot())
        out = {"role": self.role, "version": self.version,
               "endpoint": self.endpoint,
               "kv_memory_tokens": getattr(self.engine,
                                           "kv_memory_tokens", 0),
               "kv_usable_tokens": getattr(self.engine,
                                           "kv_usable_tokens", 0),
               "handoff_bytes": int(flat.get(
                   "serving_kv_handoff_bytes_total", 0)),
               # the engine's parallel shape, and the device of each of
               # its shards (shards that share a card name it alike)
               "parallel": self._parallel_shape(),
               # CUDA-graph captures per executable: the port's answer to
               # the JAX engines' trace counts; and the paged-attention
               # kernel launches the engine made (a field of the port's)
               "trace_counts": _jsonable(self.engine.trace_counts),
               "kernel_launches": int(getattr(self.engine,
                                              "kernel_launches", 0))}
        pool = getattr(self.engine, "block_pool", None)
        if pool is not None:
            out["blocks_in_use"] = pool.in_use
            out["blocks_total"] = pool.capacity
        pp_stats = getattr(self.engine, "pp_stats", None)
        if pp_stats is not None:
            out["pp_stats"] = _jsonable(pp_stats())
        if self.scheduler is not None:
            # keep the historical `requests` key set (zero-filled), with
            # VALUES read from the registry's serving_* counters — which
            # now carry tenant labels, so the projection SUMS
            # across the tenant dimension: STAT stays the tenant-blind
            # health view, OP_METRICS ships the full labelsets
            requests = dict.fromkeys(self.scheduler.counts, 0)
            for key, v in flat.items():
                fam = key.split("{", 1)[0]
                if fam == "serving_tokens_total":
                    requests["serving.tokens"] += int(v)
                elif fam == "serving_preempted_total":
                    requests["serving.preempted"] += int(v)
                elif fam == "serving_requests_total":
                    m = re.search(r"status=([^,}]+)", key)
                    if m:
                        k = f"serving.{m.group(1)}"
                        requests[k] = requests.get(k, 0) + int(v)
            out.update({
                "queue_depth": int(flat.get("serving_queue_depth", 0)),
                "active_slots": int(round(
                    flat.get("serving_slot_occupancy", 0.0)
                    * self.engine.slots)),
                "requests": requests,
                "tokens_generated": requests["serving.tokens"],
                "model_version": self.scheduler.model_version})
        return _kv.pack_payload(out)

    def _h_metrics(self, body, aux, reqid, rctx):
        """OP_METRICS: the worker's FULL registry snapshot — the fleet
        federation input (observability/fleet.py). Genuinely read-only:
        polling it, retrying it, or dropping the reply changes nothing
        on the worker."""
        return _kv.pack_payload({
            "role": self.role, "version": self.version,
            "endpoint": self.endpoint,
            "snapshot": _metrics.registry().snapshot()})

    def _h_dump(self, body, aux, reqid, rctx):
        """OP_DUMP: write this process's flight-recorder postmortem and
        ship the document back — the router files it into the fleet
        postmortem bundle on a sustained SLO breach. Retry-safe: every
        dump is self-contained and retention-bounded."""
        obj, _ = _kv.unpack_payload(body)
        path = _fr.get().dump(obj.get("reason") or "fleet OP_DUMP")
        with open(path) as f:
            doc = json.load(f)
        return _kv.pack_payload({"role": self.role, "path": path,
                                 "postmortem": doc})

    @staticmethod
    def _trim(cache, cap=_DONE_CACHE_CAP):
        while len(cache) > cap:
            cache.pop(next(iter(cache)))


def _hist_p99(snap, name):
    """Approximate p99 from a registry-snapshot histogram: the upper
    bound of the first cumulative bucket covering 99% of observations
    (the same estimator tools/metrics_report.py grades with). None when
    the family is absent or empty."""
    for fam in snap.get("metrics", ()):
        if fam.get("name") != name or fam.get("type") != "histogram":
            continue
        total, merged = 0, {}
        for s in fam.get("samples", ()):
            total += int(s.get("count", 0))
            for le, c in (s.get("buckets") or {}).items():
                merged[le] = merged.get(le, 0) + int(c)
        if total <= 0:
            return None
        target = 0.99 * total
        bounds = sorted(merged, key=lambda le: float("inf")
                        if le == "+Inf" else float(le))
        for le in bounds:
            if merged[le] >= target:
                return None if le == "+Inf" else float(le)
    return None


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def save_swap_checkpoint(state_dict, path):
    """Commit `state_dict` as a hot-swap source checkpoint (the
    train->serve edge of the online-learning loop): the shared
    ckpt_commit protocol, so workers only ever load a verified commit."""
    save_state_dict(state_dict, path)
    return _ckpt.verify_dir(path) is not None
