"""KV-memory attribution plane: the block lifecycle ledger and its watchdog.

Counterpart of `paddle_tpu/observability/kvledger.py`, copied: the schema
(`paddle_tpu.kvledger.v1`), the event vocabulary, the family names
(`serving_kv_blocks{tenant,kind}`, `serving_kv_bytes{tenant,kind}`,
`serving_kv_ledger_divergence_total{invariant}`) and the `PTN_KV_LEDGER`
switch (on unless set to 0, off or false) are unchanged, so
`tools/serve_report.py` replays the port's ledger records as it replays
the JAX package's.

Event vocabulary (each event carries block ids, request id, tenant and
origin site, read from the attribution context when it is emitted):

  alloc         BlockPool.alloc handed out fresh blocks (refcount 1)
  ref           one reference taken on an allocated block
  unref         one reference dropped
  free          the last reference dropped: the block went back to the
                free list (emitted after its `unref`)
  share         a prefix-cache match put cached blocks into a request's
                table row (its `ref`s ride alongside; `tokens` counts the
                prefill work the reuse saved)
  cache_insert  the prefix cache took its own reference on a block
  cache_evict   the prefix cache dropped an entry under pressure
  tier_demote   an evicted chain entry left the pool for a colder tier:
                carries `key` (the chain key), `tier` ("host"|"disk"),
                `owner` (the chain's namespace) and, from an int8 host
                tier, `sat` (the requantized codes' saturated fraction).
                The pool side still emits its own unref/free: tier events
                track the cold copy, so the reconciler proves that no
                block leaked across tiers
  tier_promote  a tiered entry was written back into the pool (the
                pool-side alloc and cache_insert events ride alongside)
  tier_drop     a tiered entry was discarded (capacity, a torn spill or
                restore, a corrupt record, invalidation), with `reason`

Attribution: the pool and the prefix cache know nothing of requests or
tenants. The scheduler wraps every engine call that can touch the pool in
`attribution(request_id=..., tenant=..., origin=...)` (thread-local), and
the prefix cache refines the origin with `origin_scope("prefix_cache.*")`
so the shadow model classifies each holder: `private` (the request
allocated the block), `shared` (it co-owns a cached chain through
`match`), `cached` (the prefix cache's own reference).

`LedgerReconciler.check()` runs at every scheduler step boundary and
holds the shadow model against the real pool, prefix cache and tier
store: refcounts, the free list, the cached set, orphaned chain tails,
`evictable()`, tier residency and the event stream's own consistency.
A divergence latches the counter, a flight-recorder annotation and (once)
a postmortem bundle.

The ledger only observes: it is host bookkeeping that never touches a
pool tensor or a captured graph, so token streams and capture counts are
the same with it on or off. Disabled (`disable()` or `PTN_KV_LEDGER=0`,
read when an engine is built), the pool and cache pay one `is None`
check per operation.
"""
import contextlib
import os
import threading

from . import flight_recorder as _fr
from . import metrics as _metrics

__all__ = ["SCHEMA", "EVENTS", "KINDS", "INVARIANTS", "KVLedger",
           "ShadowPool", "LedgerReconciler", "attribution",
           "origin_scope", "current_attribution", "replay_events",
           "enabled", "enable", "disable"]

SCHEMA = "paddle_tpu.kvledger.v1"
EVENTS = ("alloc", "ref", "unref", "free", "share", "cache_insert",
          "cache_evict", "tier_demote", "tier_promote", "tier_drop")
KINDS = ("private", "shared", "cached", "host", "disk")
INVARIANTS = ("event_stream", "refcounts", "free_list", "cached_set",
              "orphan_chain", "evictable", "tier_residency")
DEFAULT_TENANT = "default"

_G_BLOCKS = _metrics.gauge(
    "serving_kv_blocks",
    "Resident KV blocks attributed per tenant and ownership kind "
    "(private|shared|cached), from the kvledger shadow model",
    labelnames=("tenant", "kind"))
_G_BYTES = _metrics.gauge(
    "serving_kv_bytes",
    "Resident KV bytes per tenant and ownership kind, priced from the "
    "engine's pool dtype (block_bytes x serving_kv_blocks)",
    labelnames=("tenant", "kind"))
_C_DIVERGENCE = _metrics.counter(
    "serving_kv_ledger_divergence_total",
    "Ledger-vs-pool invariant violations caught by LedgerReconciler "
    "(failure-class: any growth means a leak, a double free, or a "
    "corrupted prefix chain)",
    labelnames=("invariant",))

_enabled = os.environ.get("PTN_KV_LEDGER", "1").lower() \
    not in ("0", "off", "false")


def enabled():
    """Whether engines attach a ledger at construction. Checked once,
    when `_alloc_host_state` runs — flipping it later affects only
    engines built afterwards."""
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


# ------------------------------------------------- attribution context

_ctx = threading.local()

#: shared reusable null context for callers on the disabled path
NULL_CTX = contextlib.nullcontext()


def current_attribution():
    """The innermost attribution frame ({'request_id','tenant','origin'})
    or None outside any scope."""
    return getattr(_ctx, "cur", None)


class attribution:
    """Label every ledger event emitted inside the scope. The scheduler
    wraps engine calls (prefill/adopt/reset/grow) in this; nesting
    replaces the frame, restoring the outer one on exit. (A class rather
    than a generator context manager: the scheduler opens one per slot
    and step, so its cost is host time a step.)"""

    __slots__ = ("_frame", "_prev")

    def __init__(self, request_id=None, tenant=None, origin=None):
        self._frame = {"request_id": request_id, "tenant": tenant,
                       "origin": origin}
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_ctx, "cur", None)
        _ctx.cur = self._frame

    def __exit__(self, *exc):
        _ctx.cur = self._prev
        return False


class origin_scope:
    """Refine only the `origin` of the current frame (PrefixCache wraps
    its own pool calls so `ref`s classify as shared/cached, not
    private), preserving request/tenant attribution."""

    __slots__ = ("_origin", "_prev")

    def __init__(self, origin):
        self._origin = origin
        self._prev = None

    def __enter__(self):
        prev = self._prev = getattr(_ctx, "cur", None)
        base = prev or {"request_id": None, "tenant": None}
        _ctx.cur = {"request_id": base.get("request_id"),
                    "tenant": base.get("tenant"), "origin": self._origin}

    def __exit__(self, *exc):
        _ctx.cur = self._prev
        return False


# ---------------------------------------------------- the shadow model

def _holder_kind(origin):
    """Ownership kind of a reference, from the origin that took it."""
    if origin == "prefix_cache.match":
        return "shared"
    if origin == "prefix_cache.insert":
        return "cached"
    return "private"


class ShadowPool:
    """Event-stream replica of a BlockPool: refcounts, the allocated
    set, per-block holder attribution, and the cached-block ownership
    map — everything the reconciler compares against the real allocator
    and everything the residency gauges aggregate. Impossible
    transitions (ref of a free block, unref below zero, double alloc)
    are recorded in `errors` instead of raising: the shadow must keep
    tracking a diverged pool so the reconciler can describe the damage.

    Stdlib-only on purpose (plain-list refcounts): every observability
    module imports without torch, so offline tools can replay a ledger
    stream on any host.

    The port keeps the (tenant, kind) residency counts as the holders
    change, so `tenant_kind_blocks()` (read by the reconciler at every
    step) costs the number of pairs, not the number of blocks; the
    counts equal the reference's recount over `holders`."""

    _MAX_ERRORS = 32

    def __init__(self, num_blocks):
        self.num_blocks = int(num_blocks)
        self.refs = [0] * self.num_blocks
        self.allocated = set()       # block ids with a live allocation
        self.holders = {}            # block -> [(tenant, kind, req_id)]
        self.cached = {}             # block -> inserting tenant
        self.tiered = {}             # chain key -> (owner tenant, tier)
        self.errors = []             # event-stream self-inconsistencies
        self.applied = 0
        self._pairs = {}             # (tenant, kind) -> blocks holding it
        self._universe = frozenset(range(1, self.num_blocks))

    def _err(self, msg):
        if len(self.errors) < self._MAX_ERRORS:
            self.errors.append(msg)

    def _gain(self, hs, h):
        """Append holder `h` to a block's list `hs`; its (tenant, kind)
        pair counts the block once."""
        if not any(x[0] == h[0] and x[1] == h[1] for x in hs):
            self._pairs[h[:2]] = self._pairs.get(h[:2], 0) + 1
        hs.append(h)

    def _lose(self, hs, i):
        """Remove holder `i` of a block's list `hs`."""
        h = hs.pop(i)
        if not any(x[0] == h[0] and x[1] == h[1] for x in hs):
            self._uncount(h[:2])

    def _uncount(self, pair):
        n = self._pairs[pair] - 1
        if n:
            self._pairs[pair] = n
        else:
            del self._pairs[pair]

    def _forget(self, hs):
        """Uncount every pair of a block whose holder list goes."""
        for pair in {(h[0], h[1]) for h in hs}:
            self._uncount(pair)

    def _drop_holder(self, b, tenant, rid, origin):
        hs = self.holders.get(b)
        if not hs:
            return
        if origin == "prefix_cache.evict":
            # the cache's own reference, whoever inserted it
            for i, h in enumerate(hs):
                if h[1] == "cached":
                    self._lose(hs, i)
                    return
        preds = (
            lambda h: rid is not None and h[2] == rid
            and h[1] != "cached",
            lambda h: h[0] == tenant and h[1] == "shared",
            lambda h: h[0] == tenant and h[1] == "private",
            lambda h: True,
        )
        for pred in preds:
            for i, h in enumerate(hs):
                if pred(h):
                    self._lose(hs, i)
                    return

    def apply(self, ev):
        kind = ev["event"]
        tenant = ev.get("tenant") or DEFAULT_TENANT
        rid = ev.get("request_id")
        origin = ev.get("origin")
        if kind in ("tier_demote", "tier_promote", "tier_drop"):
            # tier events are keyed by prefix-chain entry, not block id:
            # the HBM side's alloc/unref/free events cover the pool, so
            # a tier event only moves the COLD copy's residency record
            key = ev.get("key")
            if key is None:
                self._err(f"seq {ev.get('seq')}: {kind} without a key")
            elif kind == "tier_demote":
                self.tiered[key] = (ev.get("owner") or tenant,
                                    ev.get("tier"))
            else:
                if key not in self.tiered:
                    self._err(f"seq {ev.get('seq')}: {kind} of "
                              f"untiered key {key}")
                self.tiered.pop(key, None)
            self.applied += 1
            return
        for b in ev.get("blocks", ()):
            b = int(b)
            if not 0 < b < self.num_blocks:
                self._err(f"seq {ev.get('seq')}: block {b} out of "
                          f"range for pool of {self.num_blocks}")
                continue
            if kind == "alloc":
                if b in self.allocated:
                    self._err(f"seq {ev.get('seq')}: double alloc of "
                              f"block {b}")
                self.allocated.add(b)
                self.refs[b] = 1
                self._forget(self.holders.get(b, ()))
                self.holders[b] = []
                self._gain(self.holders[b], (tenant, "private", rid))
            elif kind == "ref":
                if b not in self.allocated or self.refs[b] < 1:
                    self._err(f"seq {ev.get('seq')}: ref of free "
                              f"block {b}")
                self.refs[b] += 1
                self._gain(self.holders.setdefault(b, []),
                           (tenant, _holder_kind(origin), rid))
            elif kind == "unref":
                if self.refs[b] < 1:
                    self._err(f"seq {ev.get('seq')}: unref of free "
                              f"block {b}")
                else:
                    self.refs[b] -= 1
                self._drop_holder(b, tenant, rid, origin)
            elif kind == "free":
                if self.refs[b] != 0:
                    self._err(f"seq {ev.get('seq')}: free of block {b} "
                              f"with {int(self.refs[b])} refs")
                self.allocated.discard(b)
                self._forget(self.holders.pop(b, ()))
            elif kind == "cache_insert":
                self.cached[b] = tenant
            elif kind == "cache_evict":
                self.cached.pop(b, None)
            # share: attribution metadata only — its refs ride alongside
        self.applied += 1

    # -- aggregation views --------------------------------------------------
    def free_set(self):
        """Block ids the shadow believes sit on the free list."""
        return set(self._universe - self.allocated)

    def tenant_kind_blocks(self):
        """{(tenant, kind): distinct resident blocks} — a block counts
        once per (tenant, kind) pair holding it, so two same-tenant
        sharers of one block read as one shared block."""
        out = dict(self._pairs)
        # cold tiers: one entry == one block-sized record, so
        # serving_kv_blocks{tenant,kind=host|disk} counts demoted blocks
        for owner, tier in self.tiered.values():
            if tier in ("host", "disk"):
                tk = (owner or DEFAULT_TENANT, tier)
                out[tk] = out.get(tk, 0) + 1
        return out

    def tenant_resident_totals(self):
        """{tenant: distinct resident blocks of any kind}: the
        per-step residency sample a load generator reads."""
        out = {}
        for b, hs in self.holders.items():
            for t in {h[0] for h in hs}:
                out[t] = out.get(t, 0) + 1
        return out


def replay_events(events, num_blocks):
    """Replay a serialized kvledger.v1 stream (e.g. parsed back from a
    serving JSONL) into a fresh ShadowPool — the offline half of the
    reconciler, and what an end-of-run audit reconstructs the pool
    from."""
    shadow = ShadowPool(num_blocks)
    for ev in events:
        shadow.apply(ev)
    return shadow


# ------------------------------------------------------------ the ledger

class KVLedger:
    """Append-only kvledger.v1 event log + live shadow model for ONE
    BlockPool. The paged engine builds and attaches it in `_alloc_state`,
    the host half its speculative subclass shares, so both engine kinds
    are covered by the same instrumentation points.

    The event list is unbounded by design: the reconciler's acceptance
    contract is an exact replay of the FULL stream (a bounded ring
    could not prove a leak absent). Long-lived workers that only need
    the live invariants can `compact()` at a reconciled boundary."""

    def __init__(self, num_blocks, block_bytes=0):
        self.num_blocks = int(num_blocks)
        self.block_bytes = int(block_bytes)
        self.events = []
        self.shadow = ShadowPool(self.num_blocks)
        self._seq = 0
        self._exported = set()       # (tenant, kind) keys last exported

    def __len__(self):
        return len(self.events)

    def _emit(self, event, block_ids, **extra):
        ctx = current_attribution() or {}
        ev = {"schema": SCHEMA, "seq": self._seq, "event": event,
              "blocks": [int(b) for b in block_ids],
              "request_id": ctx.get("request_id"),
              "tenant": ctx.get("tenant") or DEFAULT_TENANT,
              "origin": ctx.get("origin")}
        if extra:
            ev.update(extra)
        self._seq += 1
        self.events.append(ev)
        self.shadow.apply(ev)
        return ev

    # BlockPool hooks (ground truth: every refcount transition)
    def pool_alloc(self, block_ids):
        self._emit("alloc", block_ids)

    def pool_ref(self, block_id):
        self._emit("ref", (block_id,))

    def pool_unref(self, block_id):
        self._emit("unref", (block_id,))

    def pool_free(self, block_id):
        self._emit("free", (block_id,))

    # PrefixCache hooks (semantic layer: who shares whose chains)
    def cache_share(self, block_ids, tokens):
        self._emit("share", block_ids, tokens=int(tokens))

    def cache_insert(self, block_ids):
        self._emit("cache_insert", block_ids)

    def cache_evict(self, block_ids):
        self._emit("cache_evict", block_ids)

    # TieredBlockStore hooks (residency across the cold tiers)
    def tier_demote(self, block_ids, key, tier, owner, sat=None):
        # `sat`: int8 requant code-saturation fraction of the
        # demoted block — None when the host tier stores float32
        ev = {"key": str(key), "tier": str(tier), "owner": str(owner)}
        if sat is not None:
            ev["sat"] = round(float(sat), 6)
        self._emit("tier_demote", block_ids, **ev)

    def tier_promote(self, block_ids, key, tier, owner):
        self._emit("tier_promote", block_ids, key=str(key),
                   tier=str(tier), owner=str(owner))

    def tier_drop(self, key, tier, owner, reason=None):
        ev = {"key": str(key), "tier": str(tier), "owner": str(owner)}
        if reason is not None:
            ev["reason"] = str(reason)
        self._emit("tier_drop", (), **ev)

    def compact(self):
        """Drop the serialized history (the live shadow keeps its
        state). Only safe at a reconciled boundary; replay from the
        remaining stream is no longer an alloc-from-empty replay."""
        self.events = []

    def export_gauges(self):
        """Publish serving_kv_blocks/bytes{tenant,kind} from the shadow,
        zeroing (tenant, kind) series that went non-resident so a stale
        child can never read as live HBM."""
        counts = self.shadow.tenant_kind_blocks()
        for t, k in self._exported - set(counts):
            _G_BLOCKS.labels(tenant=t, kind=k).set(0)
            _G_BYTES.labels(tenant=t, kind=k).set(0)
        for (t, k), n in counts.items():
            _G_BLOCKS.labels(tenant=t, kind=k).set(n)
            _G_BYTES.labels(tenant=t, kind=k).set(n * self.block_bytes)
        self._exported = set(counts)


# -------------------------------------------------------- the reconciler

class LedgerReconciler:
    """Continuous invariant checker: at every scheduler-step boundary,
    compare the ledger's shadow model against the REAL free list,
    refcounts, and prefix-cache structure. A clean pool passes every
    check for free; any divergence is latched (counter + flight-recorder
    annotation + one postmortem bundle) and keeps being counted each
    step it persists — a leak does not heal by being old."""

    def __init__(self, ledger, pool, cache=None, tier_store=None):
        self.ledger = ledger
        self.pool = pool
        self.cache = cache
        self.tier_store = tier_store
        self.divergences = []        # latched messages, newest-last
        self._dumped = False
        self.last_postmortem = None
        # prime every invariant's series at zero so a later increment is
        # a DELTA from a clean baseline, not a first sight that
        # metrics_report --compare could mistake for schema churn
        for inv in INVARIANTS:
            _C_DIVERGENCE.labels(invariant=inv).inc(0)

    def _diffs(self):
        """[(invariant, message)] — one entry per violated invariant."""
        out = []
        shadow = self.ledger.shadow
        pool = self.pool
        if shadow.errors:
            out.append(("event_stream",
                        f"{len(shadow.errors)} impossible transitions "
                        f"in the event stream; first: "
                        f"{shadow.errors[0]}"))
        real_refs = pool._refs.tolist() if hasattr(pool._refs, "tolist") \
            else [int(r) for r in pool._refs]
        if shadow.refs != real_refs:
            bad = [b for b in range(shadow.num_blocks)
                   if shadow.refs[b] != real_refs[b]][:8]
            out.append(("refcounts", "refcount mismatch at blocks " +
                        ", ".join(f"{b} (ledger {shadow.refs[b]} vs "
                                  f"pool {real_refs[b]})" for b in bad)))
        real_free = set(pool._free)          # the pool keeps python ints
        shadow_free = shadow.free_set()
        if real_free != shadow_free:
            leaked = sorted(shadow_free - real_free)
            phantom = sorted(real_free - shadow_free)
            parts = []
            if leaked:
                parts.append(f"blocks {leaked[:8]} freed in the ledger "
                             f"but missing from the pool free list "
                             f"(leaked)")
            if phantom:
                parts.append(f"blocks {phantom[:8]} on the free list "
                             f"the ledger still sees allocated "
                             f"(double free)")
            out.append(("free_list", "; ".join(parts)))
        cache = self.cache
        if cache is not None:
            real_cached = set(map(int, cache._entries.values()))
            led_cached = set(shadow.cached)
            if real_cached != led_cached:
                out.append(("cached_set",
                            f"cache holds blocks "
                            f"{sorted(real_cached - led_cached)[:8]} the"
                            f" ledger missed; ledger holds "
                            f"{sorted(led_cached - real_cached)[:8]} "
                            f"the cache dropped"))
            orphans = [k for k, parent in cache._parent.items()
                       if parent is not None
                       and parent not in cache._entries]
            if orphans:
                out.append(("orphan_chain",
                            f"{len(orphans)} cached entries whose chain "
                            f"parent was evicted (unmatchable tails)"))
            want = sum(1 for b in led_cached if shadow.refs[b] == 1)
            got = cache.evictable()
            if want != got:
                out.append(("evictable",
                            f"cache.evictable()={got} but the ledger "
                            f"counts {want} cache-only blocks"))
        store = self.tier_store
        if store is not None:
            # the shadow's {key: tier} map must equal the live
            # tier store's residency — a demote the ledger missed (or a
            # dropped entry it still counts) is a cross-tier leak
            real_tiers = {str(k): str(t)
                          for k, t in store.residency().items()}
            led_tiers = {str(k): str(t)
                         for k, (_own, t) in shadow.tiered.items()}
            if real_tiers != led_tiers:
                ghost = sorted(set(led_tiers) - set(real_tiers))
                unseen = sorted(set(real_tiers) - set(led_tiers))
                moved = sorted(k for k in set(led_tiers) & set(real_tiers)
                               if led_tiers[k] != real_tiers[k])
                out.append(("tier_residency",
                            f"{len(ghost)} ledger-only tier entries "
                            f"(dropped without tier_drop), {len(unseen)} "
                            f"store-only (demoted without tier_demote), "
                            f"{len(moved)} on the wrong tier"))
        return out

    def check(self):
        """Run every invariant; returns the (possibly empty) list of
        divergence messages found THIS call. Also refreshes the
        per-tenant residency gauges — the reconciler is the step-boundary
        hook, so the gauges track live occupancy at step granularity."""
        diffs = self._diffs()
        self.ledger.export_gauges()
        if not diffs:
            return []
        msgs = [f"{inv}: {msg}" for inv, msg in diffs]
        for inv, _ in diffs:
            _C_DIVERGENCE.labels(invariant=inv).inc()
        self.divergences.extend(msgs)
        _fr.annotate("serving.kv_ledger_divergence",
                     {"invariants": [inv for inv, _ in diffs],
                      "first": msgs[0][:200],
                      "events": len(self.ledger.events)})
        if not self._dumped:
            self._dumped = True
            try:
                self.last_postmortem = _fr.dump_postmortem(
                    "kv ledger divergence: " + msgs[0][:160])
            except Exception:                            # noqa: BLE001
                self.last_postmortem = None
        return msgs
