"""Shared prefix cache: hash-addressed KV blocks, refcounted, copy-on-write
safe.

Counterpart of `paddle_tpu/serving/prefix_cache.py`, with its hit, miss,
resident-block and eviction families, its KV tiers, its namespace quotas
and its KV ledger hooks (`attach_ledger`: `share`, `cache_insert` and
`cache_evict` events, and the pool calls it makes under
`origin_scope("prefix_cache.match" | ".promote" | ".insert" | ".evict")`
so the ledger classifies each holder). Block k of a
prompt is keyed by the hash of the whole token prefix
`prompt[:(k+1)*block_size]`, so two prompts share block k iff they agree
on every token up to its end; a namespace salts the hash first, so
chains of two namespaces never share a block.

  * `match(prompt)` returns the longest cached chain covering a strict
    prefix of the prompt (at least one token is left to run through the
    model), taking one pool reference per block for the caller's table.
  * `probe(prompt)` measures that chain, tiered continuations included,
    without side effects.
  * Shared blocks are never written: sharing is full-block granular, so a
    request's writable region starts at its first private block.
  * `insert(prompt, row, upto)` registers a request's fully written blocks
    after its prefill, one cache-owned reference each;
    `register_block(key, blk, ...)` registers a block the caller allocated
    and filled itself (a restored prefix), its allocation reference
    becoming the cache's.
  * `evict(n, requester=None)` frees least-recently-used leaf entries
    nobody else holds: first in the requester's own namespace, then in
    namespaces that are not protected by a quota they sit within.

KV tiers: `attach_tier` plugs a `kv_tiers.TieredBlockStore` under the
cache. Eviction then demotes instead of only freeing (the entry's KV is
copied into the host tier, cascading to disk, before the block goes back
to the pool), and `match` promotes: where the walk over the pool breaks
on a key a colder tier holds, the run of tiered continuation blocks is
allocated, written back in place and registered cache-owned, so the
match continues through it. A `reserve` headroom hint keeps a promotion
from eating the blocks the caller's suffix prefill is about to allocate.
Demoted entries leave the cache, so quotas meter the device pool only:
an over-quota namespace spills instead of losing its chain.
"""
import hashlib
import time

import numpy as np

from ..observability import kvledger as _kvl
from ..observability import metrics as _metrics
from .blocks import GARBAGE_BLOCK, BlockAllocError

__all__ = ["PrefixCache", "prefix_key", "DEFAULT_NAMESPACE"]

_M_HITS = _metrics.counter(
    "serving_prefix_cache_hits_total",
    "Prefill lookups that reused at least one cached prefix block")
_M_MISSES = _metrics.counter(
    "serving_prefix_cache_misses_total",
    "Prefill lookups that reused no cached prefix block")
_M_BLOCKS = _metrics.gauge(
    "serving_prefix_cache_blocks", "KV blocks resident in the prefix cache")
_M_EVICTED = _metrics.counter(
    "serving_prefix_cache_evicted_total",
    "Prefix blocks evicted back to the pool under allocation pressure")
_M_NS_EVICTED = _metrics.counter(
    "serving_prefix_ns_evicted_total",
    "Prefix blocks evicted per namespace under allocation pressure",
    labelnames=("namespace",))

# the namespace label of un-namespaced entries (the tenant label of
# unlabeled traffic in the decision records)
DEFAULT_NAMESPACE = "default"


def prefix_key(tokens, namespace=None):
    """Stable content hash of a token prefix (the chain key), the same
    bytes the JAX package hashes. A non-None `namespace` salts the hash
    first (its UTF-8 bytes and a NUL); None keeps the un-namespaced keys."""
    h = hashlib.sha1()
    if namespace is not None:
        h.update(str(namespace).encode("utf-8") + b"\x00")
    for t in tokens:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


class PrefixCache:
    def __init__(self, pool, block_size):
        self.pool = pool
        self.block_size = int(block_size)
        self._entries = {}        # key -> block id
        self._lru = {}            # key -> last-use sequence number
        self._parent = {}         # key -> chain-parent key (None at k=0)
        self._children = {}       # key -> cached direct children count
        self._ns = {}             # key -> namespace it was hashed in
        self._seq = 0
        self._resident = {}       # namespace -> resident entry count
        self._quotas = {}         # namespace -> quota (blocks)
        self._ns_evicted = {}     # namespace label -> evicted count
        self._tier = None         # kv_tiers.TieredBlockStore or None
        self._ledger = None       # observability.kvledger.KVLedger or None
        # the last match's promotion figures (the engine's prefill stats)
        self.last_tier_stats = {"promoted_blocks": 0, "restore_s": 0.0}
        self.hits = 0             # prefill lookups that reused a block
        self.misses = 0

    def attach_tier(self, store):
        self._tier = store

    def attach_ledger(self, ledger):
        self._ledger = ledger

    # -- namespace quotas -------------------------------------------------------
    def set_quota(self, namespace, blocks):
        """Cap and protect `namespace`: while its resident entries stay
        <= `blocks`, no other namespace's pressure evicts them (its own
        requests still can). None removes the quota."""
        if blocks is None:
            self._quotas.pop(namespace, None)
        else:
            self._quotas[namespace] = int(blocks)

    def set_quotas(self, quotas):
        for ns, blocks in dict(quotas or {}).items():
            self.set_quota(ns, blocks)

    def resident(self, namespace):
        """Resident prefix entries owned by `namespace`."""
        return self._resident.get(namespace, 0)

    def namespace_residents(self):
        """{namespace label: resident entries} (None -> "default")."""
        return {(ns if ns is not None else DEFAULT_NAMESPACE): n
                for ns, n in self._resident.items() if n}

    def namespace_evictions(self):
        """{namespace label: blocks evicted} since construction."""
        return dict(self._ns_evicted)

    def _protected(self, namespace):
        """True while `namespace` holds a quota and sits within it."""
        quota = self._quotas.get(namespace)
        return quota is not None and \
            self._resident.get(namespace, 0) <= quota

    def __len__(self):
        return len(self._entries)

    def evictable(self):
        """Blocks reclaimable on demand (only the cache holds them): the
        free capacity a pool probe (the shed_pool_free rule) must count."""
        if not self._entries:
            return 0
        blks = np.fromiter(self._entries.values(), np.int64,
                           len(self._entries))
        return int(np.count_nonzero(self.pool._refs[blks] == 1))

    def _touch(self, key):
        self._seq += 1
        self._lru[key] = self._seq

    # -- lookup -----------------------------------------------------------------
    def match(self, prompt, record=True, namespace=None, reserve=0):
        """Longest cached chain covering a strict prefix of `prompt` (in
        `namespace`). Returns (block_ids, n_tokens) with one pool reference
        taken per block; n_tokens is a multiple of block_size and <=
        len(prompt)-1. With a tier store attached, a break in the walk
        promotes the tiered continuation back into the pool (block k only
        while the pool keeps `reserve - k` blocks for the caller's own
        allocation, `reserve` being its whole need). record=False leaves
        the hit/miss counts to `record_lookup`, for callers whose
        placement may fail and retry."""
        bs = self.block_size
        usable = (len(prompt) - 1) // bs
        ids = []
        prev_key = None
        for k in range(usable):
            key = prefix_key(prompt[:(k + 1) * bs], namespace)
            blk = self._entries.get(key)
            if blk is None:
                break
            ids.append(blk)
            self._touch(key)
            prev_key = key
        self.last_tier_stats = {"promoted_blocks": 0, "restore_s": 0.0}
        if self._tier is not None and len(ids) < usable:
            # eviction is leaf first, so the tiered part of a chain is a
            # contiguous suffix of the walk: one batched write restores it
            t0 = time.perf_counter()
            promoted = self._promote_run(prompt, len(ids), usable,
                                         namespace, prev_key, reserve)
            for key, blk in promoted:
                ids.append(blk)
                self._touch(key)
            if promoted:
                self.last_tier_stats = {
                    "promoted_blocks": len(promoted),
                    "restore_s": time.perf_counter() - t0}
        if ids and self._ledger is not None:
            with _kvl.origin_scope("prefix_cache.match"):
                for b in ids:
                    self.pool.ref(b)
            self._ledger.cache_share(ids, len(ids) * bs)
        else:
            for b in ids:
                self.pool.ref(b)
        if record:
            self.record_lookup(bool(ids))
        return ids, len(ids) * bs

    def probe(self, prompt, namespace=None):
        """Tokens of `prompt`'s longest servable chain, the cached entries
        and the tiered continuations, with no side effect: no pool
        reference, no LRU touch, no promotion, no count."""
        bs = self.block_size
        n = 0
        for k in range((len(prompt) - 1) // bs):
            key = prefix_key(prompt[:(k + 1) * bs], namespace)
            if key not in self._entries and \
                    (self._tier is None or key not in self._tier):
                break
            n += 1
        return n * bs

    def _promote_run(self, prompt, k0, usable, namespace, parent, reserve):
        """Promote the contiguous tiered continuation of `prompt`'s chain
        (blocks k0..usable) in one batched write. Block k0 + j is allowed
        while the pool, net of the run's earlier promotions, keeps
        max(reserve - (k0 + j), 1) blocks. Each allocation's reference
        becomes the cache's own. Returns [(key, block id)] in chain
        order."""
        bs = self.block_size
        keys = []
        for k in range(k0, usable):
            key = prefix_key(prompt[:(k + 1) * bs], namespace)
            if key not in self._tier:
                break
            keys.append(key)
        avail = self.pool.available
        m = 0
        for j in range(len(keys)):
            if avail - j < max(int(reserve) - (k0 + j), 1):
                break
            m += 1
        if not m:
            return []

        def alloc_run(n):
            try:
                if self._ledger is not None:
                    with _kvl.origin_scope("prefix_cache.promote"):
                        return list(self.pool.alloc(n))
                return list(self.pool.alloc(n))
            except BlockAllocError:
                return None

        out = []
        for key, blk, _ in self._tier.promote_run(keys[:m], alloc_run):
            self.register_block(key, blk, namespace, parent)
            parent = key
            out.append((key, blk))
        return out

    def register_block(self, key, blk, namespace, parent):
        """Register an allocated block (refcount 1, held by nobody else)
        as the entry `key` under chain parent `parent`: the allocation's
        own reference becomes the cache's (a `cache_insert` for the
        ledger). `namespace` is the one `key` was hashed in."""
        if self._ledger is not None:
            self._ledger.cache_insert((int(blk),))
        self._entries[key] = int(blk)
        self._ns[key] = namespace
        self._resident[namespace] = self._resident.get(namespace, 0) + 1
        self._parent[key] = parent
        if parent is not None:
            self._children[parent] = self._children.get(parent, 0) + 1
        self._touch(key)
        _M_BLOCKS.set(len(self._entries))

    def record_lookup(self, hit):
        """Count one prefill lookup as a hit or a miss."""
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        (_M_HITS if hit else _M_MISSES).inc()

    # -- registration -----------------------------------------------------------
    def insert(self, prompt, table_row, upto_tokens, namespace=None):
        """Register the fully written blocks of `prompt` (logical blocks
        wholly below upto_tokens) from the request's table row, keyed in
        `namespace`. A chain already cached keeps its block; new entries
        take one reference."""
        bs = self.block_size
        prev_key = None
        for k in range(int(upto_tokens) // bs):
            blk = int(table_row[k])
            if blk == GARBAGE_BLOCK:
                continue
            key = prefix_key(prompt[:(k + 1) * bs], namespace)
            if key in self._entries:
                self._touch(key)
                prev_key = key
                continue
            if self._ledger is not None:
                with _kvl.origin_scope("prefix_cache.insert"):
                    self.pool.ref(blk)
            else:
                self.pool.ref(blk)
            self.register_block(key, blk, namespace, prev_key)
            prev_key = key

    # -- eviction ---------------------------------------------------------------
    def evict(self, n_blocks, requester=None):
        """Free up to n_blocks least-recently-used entries only the cache
        references, leaves first (an evicted head would orphan its
        still-resident tail). Pass 1 drains the requester's own namespace;
        pass 2 reaches into the others but skips a namespace that holds a
        quota and sits within it (checked again at every eviction, so an
        over-quota namespace drains down to its quota). With no requester
        and no quotas every entry is eligible. Returns how many blocks
        went back to the pool."""
        if n_blocks <= 0:
            return 0
        freed = self._evict_pass(n_blocks, lambda ns: ns == requester)
        if freed < n_blocks:
            freed += self._evict_pass(
                n_blocks - freed,
                lambda ns: ns != requester and not self._protected(ns))
        if freed:
            _M_EVICTED.inc(freed)
            _M_BLOCKS.set(len(self._entries))
        return freed

    def _evict_pass(self, n_blocks, eligible):
        """One LRU leaf-first sweep over the entries whose namespace
        passes `eligible` (asked again per eviction: residents move)."""
        freed = 0
        progress = True
        while freed < n_blocks and progress:
            progress = False
            for key in sorted(self._lru, key=self._lru.get):
                if freed >= n_blocks:
                    break
                ns = self._ns.get(key)
                if not eligible(ns):
                    continue
                blk = self._entries.get(key)
                if blk is None or self.pool.refcount(blk) != 1 \
                        or self._children.get(key, 0) > 0:
                    continue
                if self._tier is not None:
                    # demote instead of only freeing: the block's KV is
                    # copied out while it is still allocated (a torn spill
                    # skips the copy: lost, never corrupt)
                    self._tier.demote(key, ns, self._parent.get(key), blk)
                if self._ledger is not None:
                    # cache_evict before the unref: a replay never sees
                    # the cache holding a freed block
                    self._ledger.cache_evict((blk,))
                    with _kvl.origin_scope("prefix_cache.evict"):
                        self.pool.unref(blk)
                else:
                    self.pool.unref(blk)
                parent = self._parent.pop(key, None)
                if parent is not None and parent in self._children:
                    self._children[parent] -= 1
                    if self._children[parent] <= 0:
                        del self._children[parent]
                self._children.pop(key, None)
                del self._entries[key]
                del self._lru[key]
                self._ns.pop(key, None)
                self._resident[ns] = self._resident.get(ns, 1) - 1
                label = ns if ns is not None else DEFAULT_NAMESPACE
                self._ns_evicted[label] = self._ns_evicted.get(label, 0) + 1
                _M_NS_EVICTED.labels(namespace=label).inc()
                freed += 1
                progress = True   # a freed leaf may expose its parent
        return freed
