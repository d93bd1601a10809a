"""Iteration-level (continuous) batching over a GenerationEngine: the SLO
tier.

Counterpart of `paddle_tpu/serving/scheduler.py`:

  submit() -> bounded admission queue (QueueFullError past the cap,
              LoadShedError past the shed watermark for sheddable
              priority classes, deadline expiry while queued -> TIMEOUT)
  step()   -> apply queued weight swaps, retire finished slots (eos /
              max_new_tokens / deadline), refill free slots from the
              queue by (priority, arrival), grow paged slots' block
              tables — preempting a victim under allocation pressure —
              then advance every occupied slot one token, or one
              speculative round (`engine.decode_many`) of 1..gamma+1
              tokens
  drain()  -> stop admitting, run until in-flight work finishes

SLO classes: every request carries a priority class (interactive=0 <
standard=1 < batch=2) and optionally a deadline (`timeout_s`). The queue
serves the best (priority, arrival) first; admission sheds sheddable
classes past a queue watermark or when the block pool runs dry
(`decisions.replay_shed`); a deadline passing while queued or while
running ends the request TIMEOUT, a running one keeping its partial
stream. Under allocation pressure the scheduler preempts the worst
(priority, deadline slack) occupant (`decisions.replay_victim`), frees its
blocks and requeues it recompute-style: prompt + tokens so far become its
restart prompt, so its delivered stream continues unchanged
(bit-identically under greedy decoding).

Containment: an engine exception in a decode step fails only the requests
in flight (terminal ERROR, `handle.error` carries the cause), every slot
is quarantined but one probe slot, and the next successful step reopens
them all; a failed prefill fails only the request being placed, under the
same protocol. The queue and the step loop are untouched. A decode
failure in the step after a weight swap counts its requests in
`serving_swap_dropped_requests_total`. `serving_decode_failures_total`
counts every contained failure, so a caller that injected none can hold
it at 0 and a kernel or device fault never turns silently into ERROR
statuses. `cancel()` drives one request terminal wherever it is.

Staged placement: a request may arrive with its prefill already computed
elsewhere (`submit(staged_kv=...)`, a KV bundle the engine adopts instead
of prefilling) or with a prefix chain shipped from another engine
(`submit(staged_prefix=...)`, restored into the local prefix cache before
the request's own prefill). A bundle that cannot be used degrades to a
local prefill; preemption drops it.

Observability (the reference's families, records and spans, schemas
unchanged): the serving counters and histograms in the port's metrics
registry; with `ServingConfig(metrics_path=)` a JSONL stream of one `run`
record, one `step` record a step, and per terminal request a `request`
summary and a `paddle_tpu.reqtimeline.v1` timeline (queue, kv_restore,
prefill or adopt, decode phases, whose durations sum to the request's
end-to-end time); and every admit, shed, place, preempt, quarantine and
swap decision as a `paddle_tpu.decisions.v1` record whose inputs replay
to its outcome. `tools/serve_report.py` and `tools/metrics_report.py`
grade these artifacts as they grade the JAX package's. A decode step's
tokens are counted with one labelled `inc` per tenant, the same totals as
the reference's per-token count.

Tenancy (`Scheduler(tenancy=TenancyConfig)`): each tenant's token bucket
gates admission ahead of the shed rule (`RateLimitedError`, status SHED,
`serving_rate_limited_total{tenant}` and a replayable `rate_limit`
decision record), its namespace's resident-block quota arms the prefix
cache's protected eviction, and its namespace keys its requests' prefix
blocks; placement binds the slot to the request's adapter row (its
`adapter_id`, else its tenant's, else base). `schedule_adapter_swap`
replaces one tenant's adapter between decode steps
(`serving_adapter_swaps_total{status}`, the `serving::adapter_swap`
span, a `swap` decision record); a refused swap keeps the old adapter
serving. A prefill that restored its chain from the KV tiers (or from a
shipped prefix) marks its request `tier_hit` with the restore's seconds.

KV ledger: when the engine attached one (`engine.kv_ledger`), every
engine call that can touch the block pool runs under
`kvledger.attribution(request_id, tenant, origin)` (origins prefill,
adopt, kv_restore, decode_grow, retire, preempt, cancel, error), a
`LedgerReconciler` holds the ledger against the pool, the prefix cache
and the tier store at every step boundary (refreshing the
`serving_kv_blocks` / `serving_kv_bytes` gauges), and the step's ledger
events go into the serving JSONL as `kvledger` records ahead of the
`step` record that closed them.

Device profile: `capture_decode_steps(steps, out_dir)` arms a one-shot
`observability.deviceprof` capture of the next `steps` decode steps,
fired in a healthy window only (after a successful decode step, no slot
quarantined, no failure contained); its summary lands on
`last_capture`, and a decode failure while it is armed or in flight is
reported, never silent.
"""
import collections
import itertools
import json
import threading
import time

import numpy as np

from ..core.device import resolve_device
from ..observability import decisions as _dec
from ..observability import kvledger as _kvl
from ..observability import metrics as _metrics
from ..observability import reqtimeline as _rt
from ..observability import tracecontext as _tc
from ..profiler import RecordEvent, TracerEventType
from .blocks import BlockAllocError
from .engine import _engine_kind as _config_kind

__all__ = ["ServingConfig", "Scheduler", "Request", "RequestHandle",
           "QueueFullError", "LoadShedError", "RateLimitedError",
           "PRIORITIES"]

QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
TIMEOUT = "TIMEOUT"
REJECTED = "REJECTED"
ERROR = "ERROR"
SHED = "SHED"
TERMINAL = (DONE, TIMEOUT, REJECTED, ERROR, SHED)

# SLO priority classes: lower is better. Admission shedding applies to
# classes >= ServingConfig.shed_priority; preemption victims are picked
# worst class first, most deadline slack first within a class.
PRIORITIES = {"interactive": 0, "standard": 1, "batch": 2}

# the per-instance `Scheduler.counts` keys (the reference's); the registry
# families below are the unified surface
_COUNTERS = ("serving.admitted", "serving.completed", "serving.rejected",
             "serving.timeout", "serving.tokens", "serving.error",
             "serving.shed", "serving.preempted")

_M_REQUESTS = _metrics.counter(
    "serving_requests_total",
    "Serving requests by terminal/admission status and tenant",
    labelnames=("status", "tenant"))
_M_TOKENS = _metrics.counter(
    "serving_tokens_total", "Tokens emitted by the serving engine",
    labelnames=("tenant",))
_M_QUEUE_DEPTH = _metrics.gauge(
    "serving_queue_depth", "Admission-queue depth after the last step")
_M_OCCUPANCY = _metrics.gauge(
    "serving_slot_occupancy",
    "Fraction of decode slots occupied after the last step")
_M_TTFT = _metrics.histogram(
    "serving_ttft_seconds", "Time to first token per completed request",
    labelnames=("tenant",))
_M_DECODE_SECONDS = _metrics.histogram(
    "serving_decode_step_seconds", "Wall time of one engine decode step")
_M_REQ_DECODE = _metrics.histogram(
    "serving_request_decode_seconds",
    "Per-request decode wall time (first token -> terminal), the "
    "per-tenant decode-latency companion of the tenant-agnostic "
    "per-step histogram", labelnames=("tenant",))
_M_DECODE_FAILURES = _metrics.counter(
    "serving_decode_failures_total",
    "Engine decode/prefill calls that raised; each fails only the "
    "affected requests")
_M_SHED = _metrics.counter(
    "serving_shed_total",
    "Requests load-shed at admission (queue/pool watermark), by tenant "
    "— per-tenant growth is failure-class in tools/metrics_report.py",
    labelnames=("tenant",))
_M_PREEMPTED = _metrics.counter(
    "serving_preempted_total",
    "Preemptions under allocation pressure (victim requeued or "
    "errored), by the victim's tenant", labelnames=("tenant",))
_M_SPEC_PROPOSED = _metrics.counter(
    "serving_spec_proposed_total",
    "Draft tokens proposed to the speculative verifier (occupied "
    "slots), labeled by the engine kind that proposed them",
    labelnames=("engine",))
_M_SPEC_ACCEPTED = _metrics.counter(
    "serving_spec_accepted_total",
    "Draft tokens the speculative verifier accepted (occupied slots), "
    "labeled by engine kind like serving_spec_proposed_total",
    labelnames=("engine",))
_M_ADOPTED = _metrics.counter(
    "serving_kv_adopted_total",
    "Requests placed from a handed-off KV bundle instead of a local "
    "prefill")
_M_SWAPS = _metrics.counter(
    "serving_weight_swaps_total",
    "Weight hot-swaps applied between decode steps, by outcome",
    labelnames=("status",))
_M_SWAP_DROPPED = _metrics.counter(
    "serving_swap_dropped_requests_total",
    "Requests failed by a decode step in a swap's probation window — "
    "zero by construction; any growth is a hot-swap that poisoned the "
    "engine (failure-class in tools/metrics_report.py)")
_M_MODEL_VERSION = _metrics.gauge(
    "serving_model_version",
    "Model version the engine is currently serving (flips on hot-swap)")
_M_RATE_LIMITED = _metrics.counter(
    "serving_rate_limited_total",
    "Requests denied at admission by their tenant's token bucket — "
    "per-tenant growth is failure-class in tools/metrics_report.py",
    labelnames=("tenant",))
_M_ADAPTER_SWAPS = _metrics.counter(
    "serving_adapter_swaps_total",
    "Per-tenant LoRA adapter hot-swaps applied between decode steps, "
    "by outcome (a failed swap leaves the tenant's OLD adapter serving)",
    labelnames=("status",))


class QueueFullError(RuntimeError):
    """Admission queue at capacity (or draining): retry later."""


class LoadShedError(QueueFullError):
    """Request shed at admission by the SLO watermark: the scheduler chose
    to fail this (sheddable-class) request fast rather than queue it past
    its useful life. Terminal status SHED."""


class RateLimitedError(QueueFullError):
    """Request denied at admission by its tenant's token bucket: its cost
    (prompt + max_new tokens) exceeds what the bucket holds now. Terminal
    status SHED with the request's `rate_limited` flag set; a
    QueueFullError, so backpressure handlers keep working."""


def _engine_kind(engine):
    """The engine's kind ("dense", "paged", "spec", "tp", "pp",
    "spec_pp", from its config): labels the spec counters and the run
    record. An engine whose config is not an EngineConfig is classified by
    what it does."""
    try:
        return _config_kind(engine.config)
    except (AttributeError, TypeError):
        pass
    if hasattr(engine, "decode_many"):
        return "spec"
    if hasattr(engine, "block_pool"):
        return "paged"
    return "dense"


class ServingConfig:
    def __init__(self, max_queue=64, default_max_new_tokens=32,
                 default_timeout_s=None, metrics_path=None,
                 shed_watermark=None, shed_priority=2,
                 shed_pool_free=None):
        self.max_queue = int(max_queue)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.default_timeout_s = default_timeout_s
        self.metrics_path = metrics_path
        # load shedding: None disables. shed_watermark is a queue-depth
        # threshold, shed_pool_free a block-pool free-fraction floor;
        # classes >= shed_priority are sheddable.
        self.shed_watermark = None if shed_watermark is None \
            else int(shed_watermark)
        self.shed_priority = int(shed_priority)
        self.shed_pool_free = None if shed_pool_free is None \
            else float(shed_pool_free)


class Request:
    _ids = itertools.count()

    def __init__(self, prompt, max_new_tokens, deadline, submitted_at,
                 priority=1, rng_seed=None, rng_gen=0, tenant=None,
                 cohort=None):
        self.id = next(Request._ids)
        self.prompt = list(prompt)        # the original prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline          # absolute clock value or None
        self.submitted_at = submitted_at
        self.priority = int(priority)
        # attribution labels: metrics, decision and timeline records only;
        # the engine never sees them
        self.tenant = str(tenant) if tenant else _dec.DEFAULT_TENANT
        self.cohort = str(cohort) if cohort else None
        self._m_tokens = _M_TOKENS.labels(tenant=self.tenant)
        self.rng_seed = rng_seed
        self.rng_gen = int(rng_gen)
        self.status = QUEUED
        self.tokens = []                  # generated tokens, stream order
        self.error = None                 # cause string for status ERROR
        self.slot = None
        self.preempted = 0                # times evicted and requeued
        self.prefix_hit = False           # prefill reused cached blocks
        self.adopted = False              # placed from a staged KV bundle
        self.prefix_namespace = None      # prefix-cache namespace
        self.adapter_id = None            # the LoRA adapter it decodes under
        self.rate_limited = False         # denied by its token bucket
        self._staged = None               # (ks, vs, plen, first[, rng])
        self._staged_prefix = None        # (ks, vs, plen, namespace)
        self.kv_restored_tokens = 0       # tokens a staged prefix restored
        self.tier_hit = False             # its prefill restored tiered or
                                          # shipped KV
        self.restore_s = 0.0              # seconds the restore took
        self.spec_proposed = 0            # draft tokens proposed for us
        self.spec_accepted = 0            # ... and accepted by verify
        self._exec_prompt = None          # restart prompt after preemption
        self.first_token_at = None
        self.finished_at = None
        self._done = threading.Event()
        # the end-to-end phase timeline opens its queue segment at
        # submission, so segment durations sum to finished - submitted
        self.trail = _rt.PhaseTrail()
        self.trail.begin(_rt.PH_QUEUE, submitted_at)
        self.trace_id = _tc.current_trace_id()

    @property
    def exec_prompt(self):
        """What prefill runs: the prompt, or after a preemption prompt +
        everything generated so far."""
        return self._exec_prompt if self._exec_prompt is not None \
            else self.prompt

    def finished(self, eos_token_id):
        """The stop rule: max_new_tokens reached or eos emitted."""
        return (len(self.tokens) >= self.max_new_tokens
                or (eos_token_id is not None and bool(self.tokens)
                    and self.tokens[-1] == eos_token_id))


class RequestHandle:
    """Caller-facing view of one request: an append-only token stream and
    a terminal status."""

    def __init__(self, req):
        self._req = req

    @property
    def request_id(self):
        return self._req.id

    @property
    def status(self):
        return self._req.status

    @property
    def tokens(self):
        return list(self._req.tokens)

    @property
    def error(self):
        """The engine failure that ended this request (status ERROR)."""
        return self._req.error

    @property
    def priority(self):
        return self._req.priority

    @property
    def tenant(self):
        return self._req.tenant

    @property
    def cohort(self):
        return self._req.cohort

    @property
    def rate_limited(self):
        """Denied at admission by its tenant's token bucket (status SHED)."""
        return self._req.rate_limited

    @property
    def adapter_id(self):
        """The LoRA adapter this request decoded under (None: base)."""
        return self._req.adapter_id

    @property
    def prefix_namespace(self):
        """The prefix-cache namespace the request's blocks live in."""
        return self._req.prefix_namespace

    @property
    def preempted(self):
        return self._req.preempted

    @property
    def prefix_hit(self):
        return self._req.prefix_hit

    @property
    def spec_proposed(self):
        """Draft tokens proposed for this request (speculative engines)."""
        return self._req.spec_proposed

    @property
    def spec_accepted(self):
        return self._req.spec_accepted

    @property
    def adopted(self):
        """Placed by adopting its staged KV bundle (no local prefill)."""
        return self._req.adopted

    @property
    def kv_restored_tokens(self):
        """Prefix tokens its staged prefix chain restored (0 if none)."""
        return self._req.kv_restored_tokens

    @property
    def phases(self):
        """The request's closed phase segments so far, t0 relative to its
        submission (`PhaseTrail.rel()`)."""
        return self._req.trail.rel(self._req.submitted_at)

    def done(self):
        return self._req.status in TERMINAL

    def result(self, timeout=None):
        """Block until terminal; returns the token list (TIMEOUT and ERROR
        requests return their partial stream)."""
        if not self._req._done.wait(timeout):
            raise TimeoutError(f"request {self._req.id} still "
                               f"{self._req.status}")
        return self.tokens

    @property
    def ttft_s(self):
        r = self._req
        if r.first_token_at is None:
            return None
        return r.first_token_at - r.submitted_at


class Scheduler:
    """Continuous batching over `engine`. `device` (default "cuda") must
    be the engine's device: without CUDA it raises unless "cpu" is
    passed, like every entry point of the port. `tenancy` (a
    `tenancy.TenancyConfig`) arms the token buckets, the namespace quotas
    and the tenants' namespaces; None is the scheduler without tenancy."""

    def __init__(self, engine, config=None, clock=time.monotonic,
                 device="cuda", tenancy=None, **kwargs):
        dev = resolve_device(device)
        if engine.device != dev:
            raise ValueError(f"engine runs on {engine.device}, scheduler "
                             f"device is {dev}")
        self.engine = engine
        self.config = config or ServingConfig(**kwargs)
        self._tenancy = tenancy
        self._buckets = tenancy.buckets(clock) if tenancy is not None \
            else {}
        cache = getattr(engine, "prefix_cache", None)
        if tenancy is not None and cache is not None:
            cache.set_quotas(tenancy.quotas())
        self._engine_kind = _engine_kind(engine)
        self._m_spec = None       # the spec counters' children, on first use
        self._clock = clock
        self._queue = collections.deque()
        self._slots = [None] * engine.slots   # Request or None
        self._quarantined = set()             # slots held out after a failure
        self._decode_failures = 0
        self._draining = False
        self._steps = 0
        self._tokens = 0                      # every token delivered
        self._decode_tokens = 0               # ... of them by decode steps
        self._decode_steps = 0
        self._decode_time_s = 0.0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._adopted = 0
        self._capture = None                  # armed decode-step capture
        self.last_capture = None              # finalize() summary block
        self._pending_swaps = collections.deque()   # armed hot-swaps
        self._pending_adapter_swaps = collections.deque()
        self.last_adapter_swap = None
        self._swap_probation = False          # first step after a swap
        self.last_swap = None                 # apply_pending_swap summary
        self.model_version = None
        self._completed = []
        # decisions.v1 records, newest last; ring-bounded (the JSONL keeps
        # the full history)
        self._decisions = collections.deque(maxlen=4096)
        self.counts = dict.fromkeys(_COUNTERS, 0)
        # the KV ledger's watchdog, when the engine attached a ledger
        ledger = getattr(engine, "kv_ledger", None)
        pool = getattr(engine, "block_pool", None)
        self._kv_reconciler = (
            _kvl.LedgerReconciler(ledger, pool,
                                  getattr(engine, "prefix_cache", None),
                                  tier_store=getattr(engine, "kv_tiers",
                                                     None))
            if ledger is not None and pool is not None else None)
        self._kv_events_written = 0
        self._metrics_f = (open(self.config.metrics_path, "a")
                           if self.config.metrics_path else None)
        self._write_run_record()

    def _kv_attr(self, req, origin):
        """The attribution scope of one engine call that touches the block
        pool (a shared no-op context without a ledger)."""
        if self._kv_reconciler is None:
            return _kvl.NULL_CTX
        return _kvl.attribution(
            request_id=req.id if req is not None else None,
            tenant=req.tenant if req is not None else None,
            origin=origin)

    def _write_line(self, rec):
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def _write_run_record(self):
        """One `run` header record: the engine kind and its KV/weight
        dtypes (and gamma for a speculative engine)."""
        if not self._metrics_f:
            return
        cfg = self.engine.config
        rec = {"kind": "run", "engine": self._engine_kind,
               "kv_dtype": getattr(cfg, "kv_dtype", "float32"),
               "weight_dtype": getattr(cfg, "weight_dtype", "float32")}
        # the tensor/pipeline-parallel shape: serve_report labels the run
        # and renders the per-stage column of a pp engine
        tp, pp = getattr(cfg, "tp", 1), getattr(cfg, "pp", 1)
        if tp != 1 or pp != 1:
            rec["tp"], rec["pp"] = int(tp), int(pp)
        gamma = getattr(cfg, "gamma", None)
        if gamma is not None:
            rec["gamma"] = int(gamma)
        self._write_line(rec)

    # -- the decision audit log ----------------------------------------------
    def _decide(self, action, req, inputs, outcome, tenant=None):
        """Append one decisions.v1 record (in memory and to the serving
        JSONL); its inputs reproduce the outcome through the replay rules
        of `observability.decisions`, the code that just made it. `tenant`
        labels a decision with no request (an adapter swap)."""
        rec = _dec.build_record(
            action, inputs, outcome, "scheduler", self._clock(),
            request_id=getattr(req, "id", None),
            tenant=tenant if tenant is not None
            else getattr(req, "tenant", None),
            cohort=getattr(req, "cohort", None),
            trace_id=getattr(req, "trace_id", None))
        self._decisions.append(rec)
        if self._metrics_f:
            self._write_line(rec)
        return rec

    def decision_records(self):
        """Every decisions.v1 record emitted so far (the last 4096)."""
        return list(self._decisions)

    def _pool_free_fraction(self):
        """Allocatable fraction of the block pool (prefix-cache-held
        blocks count as free: they evict on demand), or None without a
        pool. The pool-free shed rule's input."""
        pool = getattr(self.engine, "block_pool", None)
        if pool is None or pool.capacity <= 0:
            return None
        cache = getattr(self.engine, "prefix_cache", None)
        free = pool.available + (cache.evictable()
                                 if cache is not None else 0)
        return free / pool.capacity

    # -- admission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, timeout_s=None,
               priority="standard", staged_kv=None, rng_seed=None,
               rng_gen=0, tenant=None, cohort=None, adapter_id=None,
               prefix_namespace=None, staged_prefix=None):
        """Queue one request; returns its RequestHandle.

        `timeout_s` (default `config.default_timeout_s`) sets a deadline:
        past it a queued request ends TIMEOUT with no tokens and a running
        one TIMEOUT with its partial stream. A sheddable class (>=
        `shed_priority`) is refused with LoadShedError (status SHED) when
        the queue holds `shed_watermark` requests or the pool's free
        fraction is below `shed_pool_free`. `rng_seed` pins the sampler
        stream (None derives one from the engine seed and the request
        id). `tenant`/`cohort` label the request in metrics, decision and
        timeline records only.

        `staged_kv=(ks, vs, plen, first_token[, rng])` places the request
        from a KV bundle another engine prefilled (`engine.adopt_kv`)
        instead of a local prefill. `prompt` must still be the full
        prompt: it is what a preemption recomputes, and the bundle is kept
        only when `plen == len(prompt)` (and the engine can adopt). The
        optional 5th element is a v3 bundle's (seed, gen) sampler state.
        `staged_prefix=(ks, vs, plen, namespace)` is a prefix chain
        shipped from another engine: at placement it is restored into the
        local prefix cache (`engine.restore_prefix`, the `kv_restore`
        phase) so the request's own prefill matches it; a restore that
        fails restores nothing. `prefix_namespace` keys the request's
        prefix-cache blocks (default: its tenant's namespace under a
        tenancy config) and `adapter_id` names the adapter it decodes
        under (default: its tenant's, when the engine's bank holds one).
        With a tenancy config the tenant's token bucket runs before the
        shed rule: a request costing more tokens (prompt + max_new) than
        the bucket holds raises RateLimitedError, ticks
        `serving_rate_limited_total{tenant}` and leaves a replayable
        `rate_limit` decision record."""
        prompt = [int(t) for t in prompt]
        now = self._clock()
        max_new = self.config.default_max_new_tokens \
            if max_new_tokens is None else int(max_new_tokens)
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        prio = PRIORITIES.get(priority, priority)
        if not isinstance(prio, int):
            raise ValueError(f"unknown priority {priority!r}; want one of "
                             f"{sorted(PRIORITIES)} or an int class")
        timeout = timeout_s if timeout_s is not None \
            else self.config.default_timeout_s
        req = Request(prompt, max_new,
                      now + timeout if timeout is not None else None, now,
                      priority=prio, rng_seed=rng_seed, rng_gen=rng_gen,
                      tenant=tenant, cohort=cohort)
        if req.rng_seed is None:
            req.rng_seed = (self.engine.config.seed * 1000003
                            + req.id * 7919 + 1) & 0x7FFFFFFF
        req.adapter_id = str(adapter_id) if adapter_id else None
        req.prefix_namespace = prefix_namespace if prefix_namespace \
            is not None else (self._tenancy.namespace_of(req.tenant)
                              if self._tenancy is not None else None)
        handle = RequestHandle(req)
        if self._draining:
            self._finish(req, REJECTED, "serving.rejected")
            raise QueueFullError("scheduler is draining")
        if len(self._queue) >= self.config.max_queue:
            self._finish(req, REJECTED, "serving.rejected")
            raise QueueFullError(
                f"admission queue full ({self.config.max_queue})")
        if not prompt:
            self._finish(req, REJECTED, "serving.rejected")
            raise ValueError("empty prompt")
        if len(prompt) > self.engine.max_prompt_len or \
                len(prompt) + max_new > self.engine.config.max_len:
            self._finish(req, REJECTED, "serving.rejected")
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds the engine limits (max prompt "
                f"{self.engine.max_prompt_len}, cache max_len "
                f"{self.engine.config.max_len})")
        # the tenant's token bucket, ahead of the shed rule: a budget
        # denial is the tenant's own contract, not system pressure. The
        # verdict is decisions.replay_rate_limit over the recorded inputs
        bucket = self._buckets.get(req.tenant)
        if bucket is not None:
            cost = len(prompt) + max_new
            rl_inputs = {"tenant": req.tenant, "cost": cost,
                         "tokens_available": bucket.available(),
                         "rate_per_s": bucket.rate,
                         "burst": bucket.burst}
            rl_why = _dec.replay_rate_limit(rl_inputs)
            if rl_why:
                req.rate_limited = True
                _M_RATE_LIMITED.labels(tenant=req.tenant).inc()
                self._decide("rate_limit", req, rl_inputs,
                             {"reason": rl_why})
                self._finish(req, SHED, "serving.shed")
                raise RateLimitedError(
                    f"rate limited (tenant {req.tenant}): {rl_why}")
            bucket.take(cost)
        shed_inputs = self._shed_inputs(prio)
        shed_why = _dec.replay_shed(shed_inputs)
        if shed_why:
            _M_SHED.labels(tenant=req.tenant).inc()
            self._decide("shed", req, shed_inputs, {"reason": shed_why})
            self._finish(req, SHED, "serving.shed")
            raise LoadShedError(
                f"load shed (priority class {prio}): {shed_why}")
        if staged_kv is not None and hasattr(self.engine, "adopt_kv") \
                and int(staged_kv[2]) == len(prompt):
            req._staged = staged_kv
        if staged_prefix is not None \
                and hasattr(self.engine, "restore_prefix"):
            req._staged_prefix = staged_prefix
        self._queue.append(req)
        self._decide("admit", req,
                     dict(shed_inputs, max_queue=self.config.max_queue,
                          staged=req._staged is not None),
                     {"admitted": True,
                      "queued_behind": len(self._queue) - 1})
        self._count("serving.admitted", req)
        return handle

    def _shed_inputs(self, prio):
        """The load-shed rule's inputs; the verdict is
        `decisions.replay_shed(inputs)`, the rule every shed record
        replays under. The pool scan is paid only when the pool-free rule
        is armed."""
        c = self.config
        return {"priority": prio, "shed_priority": c.shed_priority,
                "queue_depth": len(self._queue),
                "shed_watermark": c.shed_watermark,
                "pool_free_fraction": self._pool_free_fraction()
                if c.shed_pool_free is not None else None,
                "shed_pool_free": c.shed_pool_free}

    # -- weight hot-swap ------------------------------------------------------
    def schedule_weight_swap(self, params, version=None):
        """Arm a weight hot-swap: `params` ({name: tensor or array})
        replaces the engine's serving weights at the top of the next step,
        between decode steps, so every token is computed under one weight
        set. Swaps armed back to back apply in arrival order. Returns a
        threading.Event set once the swap was applied or refused; its
        `swap_result` holds that swap's outcome (`last_swap` holds the
        latest). A refused swap (validation, or the `serving.weight_swap`
        fault site) keeps the old weights serving."""
        ev = threading.Event()
        self._pending_swaps.append({"params": params, "version": version,
                                    "event": ev})
        return ev

    def apply_pending_swap(self):
        """Apply every armed swap now, in arrival order (step() calls it
        first). Returns True when at least one swap was processed."""
        applied = False
        while self._pending_swaps:
            swap = self._pending_swaps.popleft()
            applied = True
            with RecordEvent("serving::weight_swap",
                             TracerEventType.UserDefined,
                             {"version": swap["version"],
                              "inflight": self.active_slots()}):
                try:
                    n = self.engine.swap_params(swap["params"])
                except Exception as e:                   # noqa: BLE001
                    _M_SWAPS.labels(status="failed").inc()
                    self.last_swap = {
                        "ok": False, "version": swap["version"],
                        "error": f"{type(e).__name__}: {e}"}
                else:
                    _M_SWAPS.labels(status="ok").inc()
                    if swap["version"] is not None:
                        self.model_version = swap["version"]
                        _M_MODEL_VERSION.set(float(swap["version"]))
                    # probation: requests a decode failure kills in the
                    # very next step count as swap-dropped
                    self._swap_probation = True
                    self.last_swap = {"ok": True,
                                      "version": swap["version"],
                                      "params": n,
                                      "inflight": self.active_slots()}
            self._decide("swap", None,
                         {"version": swap["version"],
                          "inflight": self.active_slots()},
                         dict(self.last_swap))
            swap["event"].swap_result = dict(self.last_swap)
            swap["event"].set()
        return applied

    # -- per-tenant adapter hot-swap -------------------------------------------
    def schedule_adapter_swap(self, tenant, state):
        """Arm a per-tenant LoRA adapter swap: `state` (a
        `tenancy.AdapterState`, e.g. `AdapterRegistry.resolve`'s) replaces
        `tenant`'s adapter at the top of the next step, between decode
        steps, so every token is computed under one adapter version. A
        refused swap (the bank's validation, or the `serving.adapter_swap`
        site) keeps the tenant's old adapter serving and every other
        tenant untouched; base weights are never involved. Returns a
        threading.Event set once applied or refused; the outcome is in
        `last_adapter_swap`, the event's `swap_result` and
        `serving_adapter_swaps_total{status}`."""
        ev = threading.Event()
        self._pending_adapter_swaps.append(
            {"tenant": str(tenant), "state": state, "event": ev})
        return ev

    def apply_pending_adapter_swap(self):
        """Apply every armed adapter swap now, in arrival order (step()
        calls it after the weight swaps). Returns True when at least one
        was processed."""
        applied = False
        while self._pending_adapter_swaps:
            swap = self._pending_adapter_swaps.popleft()
            applied = True
            with RecordEvent("serving::adapter_swap",
                             TracerEventType.UserDefined,
                             {"tenant": swap["tenant"],
                              "inflight": self.active_slots()}):
                try:
                    idx = self.engine.swap_adapter(swap["tenant"],
                                                   swap["state"])
                except Exception as e:                   # noqa: BLE001
                    _M_ADAPTER_SWAPS.labels(status="failed").inc()
                    self.last_adapter_swap = {
                        "ok": False, "tenant": swap["tenant"],
                        "error": f"{type(e).__name__}: {e}"}
                else:
                    _M_ADAPTER_SWAPS.labels(status="ok").inc()
                    self.last_adapter_swap = {
                        "ok": True, "tenant": swap["tenant"], "slot": idx,
                        "inflight": self.active_slots()}
            self._decide("swap", None,
                         {"kind": "adapter", "tenant": swap["tenant"],
                          "inflight": self.active_slots()},
                         dict(self.last_adapter_swap),
                         tenant=swap["tenant"])
            swap["event"].swap_result = dict(self.last_adapter_swap)
            swap["event"].set()
        return applied

    # -- the device profile of decode steps -----------------------------------
    def capture_decode_steps(self, steps=1, out_dir="./serving_trace"):
        """Arm a one-shot device-profile capture (observability.deviceprof)
        spanning the next `steps` decode steps, fired only in a HEALTHY
        window: at least one decode step has already succeeded (a capture
        that spans the first step would record the graph's capture, not
        serving) and no slot is quarantined by a failure. Artifacts land
        under `out_dir` (the raw trace, the deviceprof.v1 JSONL and the
        join report); the armed/capturing/reported state rides the
        flight-recorder annotations. Returns the controller; the parsed
        summary block is on `last_capture` after the window closes. The
        capture runs on the engine's device."""
        from ..observability import deviceprof
        ctrl = deviceprof.OneShotCapture(out_dir, label="serving",
                                         device=self.engine.device)
        self._capture = {"ctrl": ctrl, "steps": max(int(steps), 1),
                         "remaining": max(int(steps), 1), "wall_s": 0.0}
        return ctrl

    def _capture_healthy(self):
        return (self._decode_time_s > 0.0 and not self._quarantined
                and self._decode_failures == 0)

    def _capture_step_done(self, dt):
        """One successful decode step closed while a capture is in
        flight: count it, and close + report the window when the last
        captured step retires."""
        cap = self._capture
        if cap is None or cap["ctrl"].state != "capturing":
            return
        cap["wall_s"] += dt
        cap["remaining"] -= 1
        if cap["remaining"] > 0:
            return
        ctrl = cap["ctrl"]
        ctrl.stop()
        done = cap["steps"] - cap["remaining"]
        self.last_capture = ctrl.finalize(
            steps=max(done, 1),
            wall_step_ms=1000.0 * cap["wall_s"] / max(done, 1))
        self._capture = None

    def _capture_abort(self, why):
        """A decode failure while a capture is pending: mid-window, close
        it and report the artifacts marked `aborted_by` (no gauges: the
        window is known-sick); still armed, mark the controller failed so
        the flight-recorder annotation and `last_capture` carry the
        reason."""
        cap = self._capture
        if cap is None:
            return
        ctrl = cap["ctrl"]
        if ctrl.state == "capturing":
            ctrl.stop()
            done = max(cap["steps"] - cap["remaining"], 1)
            self.last_capture = ctrl.finalize(
                steps=done,
                wall_step_ms=(1000.0 * cap["wall_s"] / done)
                if cap["wall_s"] else None,
                aborted_by=why)
        else:
            ctrl.abort(why)
            self.last_capture = {"state": ctrl.state, "error": ctrl.error,
                                 "aborted_by": why}
        self._capture = None

    # -- the iteration loop ---------------------------------------------------
    def step(self):
        """One scheduling iteration. Returns True while work remains."""
        self.apply_pending_swap()
        self.apply_pending_adapter_swap()
        now = self._clock()
        self._expire_queued(now)
        self._retire(now)
        self._refill(now)
        self._grow_paged_slots()
        active = [r for r in self._slots if r is not None]
        if active:
            cap = self._capture
            if cap is not None and cap["ctrl"].armed \
                    and self._capture_healthy() \
                    and not cap["ctrl"].start():
                # the trace could not open (e.g. another capture is
                # active): report the dead controller instead of leaving
                # it armed forever
                self.last_capture = {"state": cap["ctrl"].state,
                                     "error": cap["ctrl"].error}
                self._capture = None
            t0 = self._clock()
            # a speculative engine advances each slot by a verify window
            # a round; every other engine by a 1-wide window
            decode_many = getattr(self.engine, "decode_many", None)
            try:
                if decode_many is not None:
                    toks, counts = decode_many()
                else:
                    toks = np.asarray(self.engine.decode()).reshape(-1, 1)
                    counts = np.ones((toks.shape[0],), np.int32)
            except Exception as e:                       # noqa: BLE001
                self._capture_abort(f"decode failure: "
                                    f"{type(e).__name__}: {str(e)[:120]}")
                self._on_decode_failure(e)
            else:
                dt = self._clock() - t0
                self._capture_step_done(dt)
                self._decode_time_s += dt
                self._decode_steps += 1
                _M_DECODE_SECONDS.observe(dt)
                self._emit(toks, counts)
                # a healthy step is the reprobe proof: reopen every
                # quarantined slot (and a fresh swap leaves probation)
                self._quarantined.clear()
                self._swap_probation = False
        self._steps += 1
        _M_QUEUE_DEPTH.set(len(self._queue))
        _M_OCCUPANCY.set(self.active_slots() / max(self.engine.slots, 1))
        # the ledger's step boundary: a leak is caught within the step it
        # happened in, and the step's events precede its step record
        if self._kv_reconciler is not None:
            self._kv_reconciler.check()
            self._write_kvledger_records()
        self._write_step_record(now, len(active))
        return bool(self._queue or any(s is not None for s in self._slots))

    def _emit(self, toks, counts):
        """Append each slot's emitted run, cut where the one-token loop
        would have stopped (eos / max_new_tokens); the step's tokens are
        counted with one labelled inc per tenant."""
        proposed = toks.shape[1] - 1             # gamma for spec, else 0
        eos = self.engine.config.eos_token_id
        step_proposed = step_accepted = 0
        by_tenant = {}                           # tokens child -> count
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if proposed:
                accepted = int(counts[slot]) - 1
                req.spec_proposed += proposed
                req.spec_accepted += accepted
                step_proposed += proposed
                step_accepted += accepted
            n = 0
            for j in range(int(counts[slot])):
                req.tokens.append(int(toks[slot, j]))
                n += 1
                if req.finished(eos):
                    break
            by_tenant[req._m_tokens] = by_tenant.get(req._m_tokens, 0) + n
        for child, n in by_tenant.items():
            child.inc(n)
            self.counts["serving.tokens"] += n
            self._tokens += n
            self._decode_tokens += n
        if proposed:
            if self._m_spec is None:
                self._m_spec = (
                    _M_SPEC_PROPOSED.labels(engine=self._engine_kind),
                    _M_SPEC_ACCEPTED.labels(engine=self._engine_kind))
            self._spec_proposed += step_proposed
            self._spec_accepted += step_accepted
            self._m_spec[0].inc(step_proposed)
            self._m_spec[1].inc(step_accepted)

    def active_slots(self):
        """Occupied decode slots right now."""
        return sum(1 for s in self._slots if s is not None)

    def drain(self, max_steps=100000):
        """Stop admitting, finish what is in flight, close the JSONL."""
        self._draining = True
        self.run_until_idle(max_steps)
        self.close()

    def set_draining(self, draining=True):
        """Toggle admission stop without the blocking loop of `drain`:
        in-flight work keeps decoding on the normal step cadence, and
        `submit` raises QueueFullError("scheduler is draining")."""
        self._draining = bool(draining)

    @property
    def draining(self):
        return self._draining

    def cancel(self, handle, status=None, counter=None):
        """Cancel one request wherever it is, queued (removed from the
        queue) or running (slot reset, its blocks back to the pool), and
        drive it terminal (default SHED, counted as a shed; TIMEOUT and
        ERROR count as such). Returns True when the request was live and
        is now terminal, False when it had already finished."""
        req = getattr(handle, "_req", handle)
        if req.status not in (QUEUED, RUNNING):
            return False
        status = SHED if status is None else status
        if counter is None:
            counter = {TIMEOUT: "serving.timeout",
                       ERROR: "serving.error"}.get(status, "serving.shed")
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        for slot, r in enumerate(self._slots):
            if r is req:
                try:
                    with self._kv_attr(req, "cancel"):
                        self.engine.reset_slot(slot)
                except Exception:                        # noqa: BLE001
                    pass          # a broken engine must not block cancel
                self._slots[slot] = None
                req.slot = None
        self._finish(req, status, counter)
        return True

    def run_until_idle(self, max_steps=100000):
        for _ in range(max_steps):
            if not self.step():
                return

    def close(self):
        """Close the serving JSONL (the scheduler keeps serving)."""
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None

    # -- containment ----------------------------------------------------------
    def _fail_engine_request(self, slot, req, cause):
        """Terminal ERROR for one request after an engine failure: slot
        reset (a broken engine must not block cleanup), cause attached."""
        try:
            with self._kv_attr(req, "error"):
                self.engine.reset_slot(slot)
        except Exception:                                # noqa: BLE001
            pass
        self._slots[slot] = None
        req.error = cause
        self._finish(req, ERROR, "serving.error")

    def _quarantine_all_but_probe(self):
        """Every slot quarantined (free ones too, or a half-empty engine
        would refill a whole batch into the next failing step); one probe
        slot rejoins at once, the next successful step releases the
        rest."""
        self._quarantined = set(range(self.engine.slots))
        self._quarantined.discard(min(self._quarantined))

    def _quarantine_outcome(self, failed):
        return {"quarantined": sorted(self._quarantined),
                "probe_slot": min(set(range(self.engine.slots))
                                  - self._quarantined, default=None),
                "failed_requests": failed}

    def _on_decode_failure(self, exc):
        """Contain a decode-step exception: only the in-flight requests
        fail, the queue and the step loop are untouched."""
        self._decode_failures += 1
        _M_DECODE_FAILURES.inc()
        if self._swap_probation:
            # the first decode step after a hot-swap failed: the swap took
            # these requests down
            _M_SWAP_DROPPED.inc(self.active_slots())
            self._swap_probation = False
        cause = f"{type(exc).__name__}: {exc}"
        failed = [{"slot": s, "request_id": r.id, "tenant": r.tenant}
                  for s, r in enumerate(self._slots) if r is not None]
        with RecordEvent("serving::decode_failure",
                         TracerEventType.UserDefined,
                         {"error": cause[:200],
                          "failures": self._decode_failures}):
            for slot, req in enumerate(self._slots):
                if req is not None:
                    self._fail_engine_request(slot, req, cause)
        self._quarantine_all_but_probe()
        self._decide("quarantine", None,
                     {"error": cause[:200], "failed": failed,
                      "engine_slots": self.engine.slots},
                     self._quarantine_outcome(len(failed)))

    def _on_prefill_failure(self, slot, req, exc):
        """A prefill exception fails only the request being placed, under
        the decode failure's quarantine protocol."""
        self._decode_failures += 1
        _M_DECODE_FAILURES.inc()
        cause = f"{type(exc).__name__}: {exc}"
        with RecordEvent("serving::prefill_failure",
                         TracerEventType.UserDefined,
                         {"slot": slot, "request": req.id,
                          "tenant": req.tenant, "error": cause[:200]}):
            self._fail_engine_request(slot, req, cause)
        self._quarantine_all_but_probe()
        self._decide("quarantine", req,
                     {"error": cause[:200],
                      "failed": [{"slot": slot, "request_id": req.id,
                                  "tenant": req.tenant}],
                      "engine_slots": self.engine.slots},
                     self._quarantine_outcome(1))

    # -- preemption -----------------------------------------------------------
    def _pick_victim(self, worse_than=None, exclude=()):
        """The preemption victim by `decisions.replay_victim` over the
        candidate table (every occupied, non-excluded slot with its
        priority and deadline slack, in slot order): worst class first,
        most slack within a class (no deadline is infinite slack), the
        earliest slot on ties; only classes strictly worse than
        `worse_than` when given. Returns (victim slot or None,
        candidates)."""
        now = self._clock()
        cands = [{"slot": slot, "request_id": req.id, "tenant": req.tenant,
                  "priority": req.priority,
                  "deadline_slack_s": (None if req.deadline is None
                                       else req.deadline - now)}
                 for slot, req in enumerate(self._slots)
                 if req is not None and slot not in exclude]
        best = _dec.replay_victim(cands, worse_than=worse_than)
        return (None if best is None else best["slot"]), cands

    def _preempt(self, slot, reason, worse_than=None, candidates=None):
        """Evict `slot`'s request, freeing its blocks, and requeue it with
        prompt + tokens so far as its restart prompt; a victim whose
        restart no longer fits the engine fails ERROR."""
        req = self._slots[slot]
        try:
            with self._kv_attr(req, "preempt"):
                self.engine.reset_slot(slot)
        except Exception:                                # noqa: BLE001
            pass
        self._slots[slot] = None
        req.slot = None
        req.preempted += 1
        self._count("serving.preempted", req)
        with RecordEvent("serving::preempt", TracerEventType.UserDefined,
                         {"slot": slot, "request": req.id,
                          "priority": req.priority, "tenant": req.tenant,
                          "tokens": len(req.tokens), "reason": reason}):
            pass
        remaining = req.max_new_tokens - len(req.tokens)
        resume = req.prompt + req.tokens
        fits = (len(resume) <= self.engine.max_prompt_len
                and len(resume) + remaining <= self.engine.config.max_len)
        disposition = "done" if remaining < 1 \
            else ("requeued" if fits else "error")
        self._decide(
            "preempt", req,
            {"reason": reason, "worse_than": worse_than,
             "candidates": candidates
             if candidates is not None else [{
                 "slot": slot, "request_id": req.id,
                 "tenant": req.tenant, "priority": req.priority,
                 "deadline_slack_s": None}],
             "queue_depth": len(self._queue),
             "pool_free_fraction": self._pool_free_fraction()
             if self.config.shed_pool_free is not None else None},
            {"victim_slot": slot, "victim_request_id": req.id,
             "victim_tenant": req.tenant, "disposition": disposition,
             "tokens_delivered": len(req.tokens)})
        if remaining < 1:                  # raced its own completion
            self._finish(req, DONE, "serving.completed")
            return
        if not fits:
            req.error = (f"preempted ({reason}) and the restart prompt "
                         f"({len(resume)} tokens) exceeds the engine "
                         f"limits")
            self._finish(req, ERROR, "serving.error")
            return
        req._exec_prompt = resume
        req._staged = None                 # evicted KV is gone: recompute
        req.status = QUEUED
        req.trail.begin(_rt.PH_QUEUE, self._clock())
        self._queue.append(req)            # keeps its arrival order

    def _grow_paged_slots(self):
        """Before the step every occupied slot must own the block its next
        token lands in. Pressure preempts among the growing request's
        class and worse, the growing slot included, so a strictly better
        class is never evicted to feed a worse one."""
        ensure = getattr(self.engine, "ensure_slot_capacity", None)
        if ensure is None:
            return
        for slot in range(len(self._slots)):
            req = self._slots[slot]
            if req is None:
                continue
            for _ in range(len(self._slots) + 1):
                if self._slots[slot] is None:
                    break                   # preempted itself below
                try:
                    with self._kv_attr(req, "decode_grow"):
                        ensure(slot)
                    break
                except BlockAllocError:
                    victim, cands = self._pick_victim(
                        worse_than=req.priority - 1)
                    if victim is None:      # unreachable: slot qualifies
                        victim, cands = slot, None
                    self._preempt(victim, "allocation pressure",
                                  worse_than=req.priority - 1,
                                  candidates=cands)
                    if victim == slot:
                        break

    # -- phases ---------------------------------------------------------------
    def _expire_queued(self, now):
        kept = collections.deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self._finish(req, TIMEOUT, "serving.timeout")
            else:
                kept.append(req)
        self._queue = kept

    def _retire(self, now):
        eos = self.engine.config.eos_token_id
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            finished = req.finished(eos)
            timed_out = req.deadline is not None and now > req.deadline
            if finished or timed_out:
                with RecordEvent("serving::retire",
                                 TracerEventType.UserDefined,
                                 {"slot": slot, "request": req.id,
                                  "tenant": req.tenant,
                                  "tokens": len(req.tokens),
                                  "timeout": timed_out}):
                    with self._kv_attr(req, "retire"):
                        self.engine.reset_slot(slot)
                self._slots[slot] = None
                self._finish(req, TIMEOUT if timed_out else DONE,
                             "serving.timeout" if timed_out
                             else "serving.completed")

    def _pop_next(self, now):
        """Best queued request by (priority class, arrival), finishing
        expired ones along the way."""
        while self._queue:
            best = min(self._queue, key=lambda r: (r.priority, r.id))
            self._queue.remove(best)
            if best.deadline is not None and now > best.deadline:
                self._finish(best, TIMEOUT, "serving.timeout")
                continue
            return best
        return None

    def _refill(self, now):
        for slot in range(len(self._slots)):
            if self._slots[slot] is not None or slot in self._quarantined:
                continue
            # a request that completes at prefill retires at once and
            # frees the slot for the next one
            while self._slots[slot] is None \
                    and slot not in self._quarantined:
                req = self._pop_next(now)
                if req is None:
                    return
                outcome = self._try_place(slot, req)
                if outcome == "stop":
                    return
                if outcome == "failed":
                    break

    def _try_place(self, slot, req):
        """Prefill `req` into `slot`. Allocation pressure preempts a
        strictly worse-class victim and retries; with none the request is
        requeued and refill stops for this step ("stop"). Any other
        placement exception engages the quarantine protocol ("failed").
        Returns "placed" on success."""
        for _ in range(len(self._slots) + 1):
            try:
                first = self._place_once(slot, req)
            except BlockAllocError:
                victim, cands = self._pick_victim(
                    worse_than=req.priority, exclude=(slot,))
                if victim is None:
                    req.trail.begin(_rt.PH_QUEUE, self._clock())
                    self._queue.append(req)     # retry next step
                    return "stop"
                self._preempt(victim, "admission pressure",
                              worse_than=req.priority, candidates=cands)
                continue
            except Exception as e:               # noqa: BLE001
                self._on_prefill_failure(slot, req, e)
                return "failed"
            break
        else:
            req.trail.begin(_rt.PH_QUEUE, self._clock())
            self._queue.append(req)
            return "stop"
        req.slot = slot
        req.status = RUNNING
        if req.first_token_at is None:
            req.first_token_at = self._clock()
        req.trail.begin(_rt.PH_DECODE, self._clock())
        stats = getattr(self.engine, "last_prefill_stats", None) or {}
        if stats.get("prefix_hit_tokens", 0) > 0:
            req.prefix_hit = True
        if stats.get("tier_promoted_blocks", 0) > 0:
            req.tier_hit = True
            req.restore_s += stats.get("tier_restore_s", 0.0)
        self._decide("place", req,
                     {"slot": slot, "queue_depth": len(self._queue),
                      "priority": req.priority,
                      "preempted": req.preempted,
                      "staged": req.adopted},
                     {"placed": True, "slot": slot,
                      "adopted": req.adopted,
                      "prefix_hit": req.prefix_hit})
        req.tokens.append(first)
        self._count_token(req)
        if req.finished(self.engine.config.eos_token_id):
            with self._kv_attr(req, "retire"):
                self.engine.reset_slot(slot)
            self._finish(req, DONE, "serving.completed")
        else:
            self._slots[slot] = req
        return "placed"

    def _place_once(self, slot, req):
        """One placement attempt: adopt the staged KV bundle when the
        request carries one, else (after restoring a staged prefix chain)
        a local prefill. A bundle that fails adoption for any reason but
        allocation pressure is dropped and the attempt falls back to a
        local prefill in place; BlockAllocError escapes (the caller
        preempts)."""
        self._bind_slot_tenancy(slot, req)
        staged = req._staged
        if staged is None:
            self._restore_staged_prefix(req)
            req.trail.begin(_rt.PH_PREFILL, self._clock())
            return self._prefill(slot, req)
        req.trail.begin(_rt.PH_ADOPT, self._clock())
        try:
            # an rng-less (v1/v2) bundle arms the request's own stream at
            # the generation index after the adopted first token
            rng = staged[4] if len(staged) > 4 else \
                (req.rng_seed, req.rng_gen + 1)
            with self._kv_attr(req, "adopt"):
                first = self.engine.adopt_kv(slot, *staged[:4], rng=rng)
        except BlockAllocError:
            raise
        except Exception as e:                           # noqa: BLE001
            req._staged = None
            with RecordEvent("serving::adopt_fallback",
                             TracerEventType.UserDefined,
                             {"request": req.id,
                              "error": f"{type(e).__name__}: "
                                       f"{str(e)[:160]}"}):
                pass
            # the failed adoption stays visible as its own segment
            req.trail.begin(_rt.PH_PREFILL, self._clock())
            return self._prefill(slot, req)
        req._staged = None
        req.adopted = True
        self._adopted += 1
        _M_ADOPTED.inc()
        return first

    def _bind_slot_tenancy(self, slot, req):
        """Bind the slot to the request's adapter before placement: its
        `adapter_id`'s bank row, else its tenant's, else row 0 (base). An
        engine without a bank skips it."""
        bank = getattr(self.engine, "adapter_bank", None)
        if bank is None:
            return
        aid = req.adapter_id if req.adapter_id is not None else req.tenant
        idx = bank.slot_of(aid)
        self.engine.set_slot_adapter(slot, idx)
        if idx and req.adapter_id is None:
            req.adapter_id = aid

    def _prefill(self, slot, req):
        """Local prefill with the request's sampler state at this
        placement: its next token is generation index base + tokens
        already delivered."""
        kwargs = {} if req.prefix_namespace is None else \
            {"namespace": req.prefix_namespace}
        with self._kv_attr(req, "prefill"):
            return self.engine.prefill(
                slot, req.exec_prompt,
                rng=(req.rng_seed, req.rng_gen + len(req.tokens)), **kwargs)

    def _restore_staged_prefix(self, req):
        """Register a shipped prefix chain in the local prefix cache, once,
        as the request's `kv_restore` phase: the bundle is consumed
        whatever happens, and a restore that fails for any reason
        restores 0 tokens (the prefill that follows recomputes). The
        chain is cache-owned, so a preempted retry still matches it."""
        sp = req._staged_prefix
        if sp is None:
            return
        req._staged_prefix = None
        req.trail.begin(_rt.PH_KV_RESTORE, self._clock())
        t0 = time.perf_counter()
        try:
            with self._kv_attr(req, "kv_restore"):
                req.kv_restored_tokens = int(self.engine.restore_prefix(
                    req.exec_prompt, sp[0], sp[1], sp[2], namespace=sp[3]))
            if req.kv_restored_tokens > 0:
                req.tier_hit = True
                req.restore_s += time.perf_counter() - t0
        except Exception as e:                           # noqa: BLE001
            with RecordEvent("serving::kv_restore_fallback",
                             TracerEventType.UserDefined,
                             {"request": req.id,
                              "error": f"{type(e).__name__}: "
                                       f"{str(e)[:160]}"}):
                pass
            req.kv_restored_tokens = 0

    def _finish(self, req, status, counter):
        req.status = status
        req.finished_at = self._clock()
        req.trail.close(req.finished_at)
        self._count(counter, req)
        if req.first_token_at is not None:
            _M_TTFT.labels(tenant=req.tenant).observe(
                req.first_token_at - req.submitted_at)
            _M_REQ_DECODE.labels(tenant=req.tenant).observe(
                req.finished_at - req.first_token_at)
        if status in (DONE, TIMEOUT, ERROR, SHED):
            self._completed.append(req)
            self._write_request_record(req)
            self._write_timeline_record(req)
        req._done.set()

    def _count(self, name, req):
        """One request event: the registry family (labelled by the
        request's tenant) and the `counts` mirror."""
        if name == "serving.preempted":
            _M_PREEMPTED.labels(tenant=req.tenant).inc()
        else:
            _M_REQUESTS.labels(status=name.split(".", 1)[1],
                               tenant=req.tenant).inc()
        self.counts[name] += 1

    def _count_token(self, req):
        """The first token, delivered at placement."""
        req._m_tokens.inc()
        self.counts["serving.tokens"] += 1
        self._tokens += 1

    # -- metrics --------------------------------------------------------------
    def metrics(self):
        """The reference's counters and rates since construction, plus the
        port's own: `decode_tokens` and `decode_steps` (tokens and calls of
        decode steps alone, prefill tokens excluded), `decode_step_ms`
        (host clock around `engine.decode()`, which returns host tokens,
        so the device work is inside the window; with a speculative engine
        a step is one round), `adopted` (placements from staged KV
        bundles), `prefix_hits` and `kernel_launches`.
        `decode_tokens_per_s` is the reference's: every delivered token,
        prefill's first included, over decode time (`decode_tokens` over
        the same time is the decode steps' own rate). `spec_*` appear
        once a speculative round has proposed tokens."""
        ttfts = [r.first_token_at - r.submitted_at for r in self._completed
                 if r.first_token_at is not None]
        out = {
            "steps": self._steps,
            "queue_depth": len(self._queue),
            "slot_occupancy": self.active_slots() / max(self.engine.slots, 1),
            "tokens_generated": self._tokens,
            "decode_tokens_per_s": (self._tokens / self._decode_time_s
                                    if self._decode_time_s > 0 else 0.0),
            "ttft_s_mean": sum(ttfts) / len(ttfts) if ttfts else None,
            "requests": dict(self.counts),
            "decode_tokens": self._decode_tokens,
            "decode_steps": self._decode_steps,
            "decode_step_ms": (1e3 * self._decode_time_s / self._decode_steps
                               if self._decode_steps else None),
            "adopted": self._adopted,
            "kernel_launches": getattr(self.engine, "kernel_launches", 0),
        }
        if self._spec_proposed:
            out["spec_proposed"] = self._spec_proposed
            out["spec_accepted"] = self._spec_accepted
            out["spec_acceptance_rate"] = (self._spec_accepted
                                           / self._spec_proposed)
        pool = getattr(self.engine, "block_pool", None)
        if pool is not None:
            out["blocks_in_use"] = pool.in_use
            out["blocks_total"] = pool.capacity
            pc = getattr(self.engine, "prefix_cache", None)
            out["prefix_cache_blocks"] = len(pc) if pc is not None else 0
            out["prefix_hits"] = pc.hits if pc is not None else 0
        return out

    # -- the serving JSONL ----------------------------------------------------
    def _write_kvledger_records(self):
        """The ledger events emitted since the last step, as `kvledger`
        records of the serving JSONL (what `tools/serve_report.py`'s
        residency table and an offline replay read)."""
        if not self._metrics_f or self._kv_reconciler is None:
            return
        events = self._kv_reconciler.ledger.events
        if self._kv_events_written >= len(events):
            return
        for ev in events[self._kv_events_written:]:
            self._metrics_f.write(
                json.dumps({"kind": "kvledger", **ev}) + "\n")
        self._kv_events_written = len(events)
        self._metrics_f.flush()

    def _write_step_record(self, now, active):
        if not self._metrics_f:
            return
        rec = {"kind": "step", "step": self._steps, "t": now,
               "queue_depth": len(self._queue), "active_slots": active,
               "tokens_generated": self._tokens}
        pp_stats = getattr(self.engine, "pp_stats", None)
        if pp_stats is not None:
            st = pp_stats()
            rec["pp_bubble_fraction"] = round(st["bubble_fraction"], 6)
            rec["pp_stage_busy"] = [round(b, 6) for b in st["stage_busy"]]
        self._write_line(rec)

    def _build_timeline(self, req):
        """One reqtimeline.v1 record for a terminal request."""
        return _rt.build_record(
            req.status, req.submitted_at, req.finished_at,
            req.trail.rel(req.submitted_at), request_id=req.id,
            tokens=len(req.tokens),
            ttft_s=(req.first_token_at - req.submitted_at
                    if req.first_token_at is not None else None),
            priority=req.priority, preempted=req.preempted,
            adopted=req.adopted, trace_id=req.trace_id,
            tenant=req.tenant, cohort=req.cohort)

    def timeline_records(self):
        """reqtimeline.v1 records of every terminal request so far."""
        return [self._build_timeline(r) for r in self._completed]

    def _write_timeline_record(self, req):
        if self._metrics_f:
            self._write_line(self._build_timeline(req))

    def _write_request_record(self, req):
        if not self._metrics_f:
            return
        decode_s = (req.finished_at - req.first_token_at
                    if req.first_token_at else None)
        self._write_line({
            "kind": "request", "request_id": req.id, "status": req.status,
            "tenant": req.tenant,
            **({"cohort": req.cohort} if req.cohort else {}),
            **({"adapter_id": req.adapter_id} if req.adapter_id else {}),
            **({"prefix_namespace": str(req.prefix_namespace)}
               if req.prefix_namespace is not None else {}),
            **({"rate_limited": True} if req.rate_limited else {}),
            **({"tier_hit": True,
                "restore_ms": round(req.restore_s * 1e3, 3)}
               if req.tier_hit else {}),
            "prompt_len": len(req.prompt), "tokens": len(req.tokens),
            "priority": req.priority, "preempted": req.preempted,
            "prefix_hit": req.prefix_hit, "adopted": req.adopted,
            "spec_proposed": req.spec_proposed,
            "spec_accepted": req.spec_accepted,
            "ttft_s": (req.first_token_at - req.submitted_at
                       if req.first_token_at else None),
            "decode_s": decode_s})
