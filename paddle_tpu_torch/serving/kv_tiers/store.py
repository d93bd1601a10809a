"""TieredBlockStore: the host and disk tiers one engine owns.

Counterpart of `paddle_tpu/serving/kv_tiers/store.py`, with its metric
families under the same names. The store sits behind the prefix cache:
eviction calls `demote` instead of only freeing the block, and `match`
calls `promote_run` when its walk over the device pool breaks on a key a
colder tier still holds. Device I/O goes through the engine's callbacks:
`read_block(blk) -> {"arrays": {name: np.ndarray}, "quant": bool}` (one
block's pool-native slabs copied to the host) and
`write_blocks(blks, [arrays])` (a whole promoted run written in place
into the pools), so promotion and demotion never allocate a pool or
capture a graph, and the captured decode and prefill graphs keep
reading the KV they restore.

Fault sites: `serving.kv_spill` fires per tier write (truncate tears the
spill: the entry is lost and a later match recomputes);
`serving.kv_restore` fires per restore attempt on a resident key
(truncate feeds the sha256 check a torn payload; raise is a failed
read). Either way the result is a miss and a recompute, never wrong KV,
and `serving_kv_tier_corrupt_total` counts failed verifications.

Ledger contract (`attach_ledger`): `tier_demote` when an entry gains cold
residency (or moves from host to disk; an int8 host tier adds the
requantized codes' saturated fraction `sat`), `tier_promote` when it goes
back into the pool, `tier_drop` with its `reason` when it is discarded.
The reconciler's `tier_residency` invariant holds the ledger's
{key: tier} map against `residency()` at every scheduler step. A
promoted run is written by the batched writer before its events: the
pool's `alloc` for the whole run, then one `tier_promote` per entry, then
the prefix cache's `cache_insert`s, the reference's order.
"""
import time

from ...observability import faults as _faults
from ...observability import metrics as _metrics
from .disk import DiskTier
from .host import HostTier

__all__ = ["TieredBlockStore", "corrupt_counter"]

_C_HITS = _metrics.counter(
    "serving_kv_tier_hits_total",
    "Tier lookups that found a restorable entry, per tier",
    labelnames=("tier",))
_C_MISSES = _metrics.counter(
    "serving_kv_tier_misses_total",
    "Tier lookups that found nothing (or found corruption), per tier",
    labelnames=("tier",))
_C_DEMOTE = _metrics.counter(
    "serving_kv_tier_demote_total",
    "Blocks demoted into a tier (HBM->host, host->disk)",
    labelnames=("tier",))
_C_PROMOTE = _metrics.counter(
    "serving_kv_tier_promote_total",
    "Blocks promoted back into HBM, per source tier",
    labelnames=("tier",))
_C_DROP = _metrics.counter(
    "serving_kv_tier_drop_total",
    "Tiered blocks discarded (capacity, torn spill, corrupt restore)",
    labelnames=("tier",))
_C_CORRUPT = _metrics.counter(
    "serving_kv_tier_corrupt_total",
    "Tier restores that failed verification (torn payload, sha256 "
    "mismatch) — failure-class: the chain degraded to recompute")
_G_BLOCKS = _metrics.gauge(
    "serving_kv_tier_blocks", "Blocks resident per cold tier",
    labelnames=("tier",))
_H_RESTORE = _metrics.histogram(
    "serving_kv_restore_seconds",
    "Wall seconds per block promoted from a cold tier back into HBM "
    "(fetch + verify + device write)")

_OWNER_DEFAULT = "default"


def corrupt_counter():
    """The failure-class corrupt-restore counter, shared by the tiers and
    the engine's cross-engine prefix restore, so a torn restore is as
    visible to the `tools/metrics_report.py --compare` failure gate as a
    torn tier restore."""
    return _C_CORRUPT


class TieredBlockStore:
    def __init__(self, read_block, write_blocks, host_blocks=64,
                 host_dtype="float32", disk_dir=None, disk_blocks=256,
                 disk_compact_threshold=0.5):
        self._read = read_block
        self._write_many = write_blocks
        self.host = HostTier(host_blocks, host_dtype)
        self.disk = None
        if disk_dir is not None:
            self.disk = DiskTier(disk_dir, disk_blocks,
                                 disk_compact_threshold)
        self._ledger = None
        self._export()

    def attach_ledger(self, ledger):
        self._ledger = ledger
        # a recovered disk log predates this process's event stream: its
        # residency is announced so the shadow model starts consistent
        if self.disk is not None:
            for key in self.disk.keys():
                header = self.disk.header(key) or {}
                ledger.tier_demote((), key, "disk",
                                   self._owner(header.get("ns")))

    @staticmethod
    def _owner(ns):
        return ns if ns is not None else _OWNER_DEFAULT

    def _export(self):
        _G_BLOCKS.labels(tier="host").set(len(self.host))
        _G_BLOCKS.labels(tier="disk").set(
            len(self.disk) if self.disk is not None else 0)

    # -- residency -----------------------------------------------------------
    def __contains__(self, key):
        return key in self.host or \
            (self.disk is not None and key in self.disk)

    def residency(self):
        """{key: "host" | "disk"} over every tiered entry."""
        out = {key: "disk" for key in
               (self.disk.keys() if self.disk is not None else ())}
        for key in self.host.keys():
            out[key] = "host"
        return out

    # -- demote (the prefix cache's eviction hook) ---------------------------
    def demote(self, key, namespace, parent, blk):
        """Copy block `blk`'s KV (still allocated while the eviction hook
        runs) into the host tier; True when the chain entry gained cold
        residency. Host overflow cascades the coldest entries to disk, or
        drops them."""
        owner = self._owner(namespace)
        rec = {"ns": namespace, "parent": parent}
        rec.update(self._read(blk))
        spec = _faults.fire("serving.kv_spill")
        if spec is not None and spec.mode == "truncate":
            # a torn host spill: never stored, so the chain is lost (a
            # later match misses and recomputes), never corrupt
            _C_DROP.labels(tier="host").inc()
            self._export()
            return False
        self.host.put(key, rec)
        _C_DEMOTE.labels(tier="host").inc()
        if self._ledger is not None:
            self._ledger.tier_demote((int(blk),), key, "host", owner,
                                     sat=self.host.last_put_saturation)
        self._spill_overflow()
        self._export()
        return True

    def _spill_overflow(self):
        """Move the host tier's entries beyond capacity to disk (raw: a
        requantized record ships its codes as they are), or drop them
        when there is no disk tier or the spill tears."""
        for key, raw in self.host.overflow():
            owner = self._owner(raw.get("ns"))
            if self.disk is None:
                _C_DROP.labels(tier="host").inc()
                if self._ledger is not None:
                    self._ledger.tier_drop(key, "host", owner,
                                           reason="capacity")
                continue
            spec = _faults.fire("serving.kv_spill")
            torn = spec is not None and spec.mode == "truncate"
            if self.disk.put(key, raw, torn=torn):
                _C_DEMOTE.labels(tier="disk").inc()
                if self._ledger is not None:
                    self._ledger.tier_demote((), key, "disk", owner)
                for dkey, header in self.disk.enforce_capacity():
                    _C_DROP.labels(tier="disk").inc()
                    if self._ledger is not None:
                        self._ledger.tier_drop(
                            dkey, "disk", self._owner(header.get("ns")),
                            reason="capacity")
            else:
                _C_DROP.labels(tier="host").inc()
                if self._ledger is not None:
                    self._ledger.tier_drop(key, "host", owner,
                                           reason="torn spill")

    # -- restore -------------------------------------------------------------
    def _fetch(self, key):
        """(record, tier) for a resident key after firing the restore
        fault site and verifying the content; (None, None) on a miss, a
        torn read, a raise or a sha mismatch, each already counted."""
        in_host = key in self.host
        in_disk = self.disk is not None and key in self.disk
        if not in_host and not in_disk:
            return None, None
        tier = "host" if in_host else "disk"
        try:
            spec = _faults.fire("serving.kv_restore")
        except Exception:                                    # noqa: BLE001
            # a failed restore read: a miss, not an error
            _C_MISSES.labels(tier=tier).inc()
            return None, None
        torn = spec is not None and spec.mode == "truncate"
        if in_host:
            if torn:
                # a torn host read: drop the entry, count the corruption,
                # and let the prefill recompute
                raw = self.host.raw(key)
                owner = self._owner((raw or {}).get("ns"))
                self.host.drop(key)
                _C_CORRUPT.inc()
                _C_DROP.labels(tier="host").inc()
                _C_MISSES.labels(tier="host").inc()
                if self._ledger is not None:
                    self._ledger.tier_drop(key, "host", owner,
                                           reason="torn restore")
                self._export()
                return None, None
            rec = self.host.get(key)
            _C_HITS.labels(tier="host").inc()
            return rec, "host"
        # the owner from the index header before the read: a corrupt
        # restore drops the entry, its namespace with it
        header = self.disk.header(key) or {}
        rec, corrupt = self.disk.get(key, torn=torn)
        if rec is None:
            _C_MISSES.labels(tier="disk").inc()
            if corrupt or torn:
                _C_CORRUPT.inc()
                _C_DROP.labels(tier="disk").inc()
                if self._ledger is not None:
                    self._ledger.tier_drop(
                        key, "disk", self._owner(header.get("ns")),
                        reason="corrupt restore")
                self._export()
            return None, None
        _C_HITS.labels(tier="disk").inc()
        # a record an int8 host tier spilled still carries its /q8 and /s8
        # pairs: pool-native arrays before the engine's writer reads them
        return HostTier._decode(rec), "disk"

    def peek(self, key):
        """The verified record without promotion (the export path ships a
        chain's tiered continuation to a peer; the entry stays here)."""
        rec, _tier = self._fetch(key)
        return rec

    def promote(self, key, alloc):
        """Promote one block: fetch and verify, `alloc()` a device block
        (a block id, or None under pressure), write it, drop the tiered
        copy. Returns (blk, record), or None with nothing moved."""
        out = self.promote_run([key], lambda n: (
            None if (blk := alloc()) is None else [blk]))
        if not out:
            return None
        return out[0][1], out[0][2]

    def promote_run(self, keys, alloc_run):
        """Promote a contiguous chain run: fetch and verify every record
        first (stopping at the first miss or corruption, each counted by
        `_fetch`), allocate that many device blocks in one call
        (`alloc_run(n) -> [block id] or None`), and write the whole run in
        place with the engine's batched writer. Returns [(key, block id,
        record)] in chain order ([] when nothing was restorable or the
        allocation was refused; unwritten entries stay tiered)."""
        t0 = time.perf_counter()
        runs = []
        for key in keys:
            rec, tier = self._fetch(key)
            if rec is None:
                break
            runs.append((key, rec, tier))
        if not runs:
            return []
        blks = alloc_run(len(runs))
        if blks is None:
            return []
        blks = [int(b) for b in blks]
        self._write_many(blks, [rec["arrays"] for _, rec, _ in runs])
        dt = (time.perf_counter() - t0) / len(runs)
        out = []
        for blk, (key, rec, tier) in zip(blks, runs):
            (self.host if tier == "host" else self.disk).drop(key)
            _C_PROMOTE.labels(tier=tier).inc()
            _H_RESTORE.observe(dt)
            if self._ledger is not None:
                self._ledger.tier_promote((blk,), key, tier,
                                          self._owner(rec.get("ns")))
            out.append((key, blk, rec))
        self._export()
        return out

    # -- invalidation --------------------------------------------------------
    def discard(self, key, reason="invalidated"):
        """Drop `key` from whichever tier holds it (a namespace flush, an
        explicit invalidation); the ledger's `tier_drop` carries
        `reason`."""
        dropped = False
        for tier, store in (("host", self.host), ("disk", self.disk)):
            if store is None or key not in store:
                continue
            raw = store.raw(key) if tier == "host" else None
            owner = self._owner((raw or {}).get("ns"))
            store.drop(key)
            _C_DROP.labels(tier=tier).inc()
            if self._ledger is not None:
                self._ledger.tier_drop(key, tier, owner, reason=reason)
            dropped = True
        self._export()
        return dropped

    # -- report taps ---------------------------------------------------------
    def stats(self):
        sat = self.host.saturation_stats()
        return {
            "host_blocks": len(self.host),
            "disk_blocks": len(self.disk) if self.disk is not None else 0,
            "disk_dead_fraction": round(self.disk.dead_fraction(), 4)
            if self.disk is not None else 0.0,
            "host_requant_saturation": {
                "samples": sat["samples"],
                "mean": round(sat["mean"], 4),
                "max": round(sat["max"], 4),
            },
        }
