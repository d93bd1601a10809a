"""Shared prefix cache: hash-addressed KV blocks, refcounted, copy-on-write
safe.

Counterpart of `paddle_tpu/serving/prefix_cache.py`, with its hit, miss,
resident-block and eviction families, without the KV tiers, the ledger
and the namespace quotas. Block k of a prompt is keyed by the
hash of the whole token prefix `prompt[:(k+1)*block_size]`, so two prompts
share block k iff they agree on every token up to its end; a namespace
salts the hash first, so chains of two namespaces never share a block.

  * `match(prompt)` returns the longest cached chain covering a strict
    prefix of the prompt (at least one token is left to run through the
    model), taking one pool reference per block for the caller's table.
  * `probe(prompt)` measures that chain without side effects.
  * Shared blocks are never written: sharing is full-block granular, so a
    request's writable region starts at its first private block.
  * `insert(prompt, row, upto)` registers a request's fully written blocks
    after its prefill, one cache-owned reference each;
    `register_block(key, blk, ...)` registers a block the caller allocated
    and filled itself (a restored prefix), its allocation reference
    becoming the cache's.
  * `evict(n)` frees least-recently-used leaf entries nobody else holds.
"""
import hashlib

from ..observability import metrics as _metrics
from .blocks import GARBAGE_BLOCK

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
        self.hits = 0             # prefill lookups that reused a block
        self.misses = 0

    def __len__(self):
        return len(self._entries)

    def evictable(self):
        """Blocks reclaimable on demand (only the cache holds them): the
        free capacity a pool probe (the shed_pool_free rule) must count."""
        return sum(1 for blk in self._entries.values()
                   if self.pool.refcount(blk) == 1)

    def _touch(self, key):
        self._seq += 1
        self._lru[key] = self._seq

    def match(self, prompt, record=True, namespace=None):
        """Longest cached chain covering a strict prefix of `prompt` (in
        `namespace`). Returns (block_ids, n_tokens) with one pool reference
        taken per block; n_tokens is a multiple of block_size and <=
        len(prompt)-1. record=False leaves the hit/miss counts to
        `record_lookup`, for callers whose placement may fail and retry."""
        bs = self.block_size
        ids = []
        for k in range((len(prompt) - 1) // bs):
            key = prefix_key(prompt[:(k + 1) * bs], namespace)
            blk = self._entries.get(key)
            if blk is None:
                break
            ids.append(blk)
            self._touch(key)
        for b in ids:
            self.pool.ref(b)
        if record:
            self.record_lookup(bool(ids))
        return ids, len(ids) * bs

    def probe(self, prompt, namespace=None):
        """Tokens of `prompt`'s longest cached chain, with no side effect:
        no pool reference, no LRU touch, no count."""
        bs = self.block_size
        n = 0
        for k in range((len(prompt) - 1) // bs):
            if prefix_key(prompt[:(k + 1) * bs], namespace) not in \
                    self._entries:
                break
            n += 1
        return n * bs

    def register_block(self, key, blk, namespace, parent):
        """Register an allocated block (refcount 1, held by nobody else)
        as the entry `key` under chain parent `parent`: the allocation's
        own reference becomes the cache's. `namespace` is the one `key`
        was hashed in."""
        self._entries[key] = int(blk)
        self._ns[key] = namespace
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
            self.pool.ref(blk)
            self._entries[key] = blk
            self._ns[key] = namespace
            self._parent[key] = prev_key
            if prev_key is not None:
                self._children[prev_key] = \
                    self._children.get(prev_key, 0) + 1
            self._touch(key)
            prev_key = key
        _M_BLOCKS.set(len(self._entries))

    def evict(self, n_blocks):
        """Free up to n_blocks least-recently-used entries that only the
        cache references, leaves first (an evicted head would orphan its
        still-resident tail). Returns how many blocks went back."""
        freed = 0
        progress = True
        while freed < n_blocks and progress:
            progress = False
            for key in sorted(self._lru, key=self._lru.get):
                if freed >= n_blocks:
                    break
                blk = self._entries[key]
                if self.pool.refcount(blk) != 1 \
                        or self._children.get(key, 0) > 0:
                    continue
                self.pool.unref(blk)
                parent = self._parent.pop(key)
                if parent is not None:
                    self._children[parent] -= 1
                    if self._children[parent] <= 0:
                        del self._children[parent]
                self._children.pop(key, None)
                del self._entries[key]
                del self._lru[key]
                ns = self._ns.pop(key, None)
                _M_NS_EVICTED.labels(namespace=DEFAULT_NAMESPACE if ns is None
                                     else ns).inc()
                freed += 1
                progress = True   # a freed leaf may expose its parent
        if freed:
            _M_EVICTED.inc(freed)
            _M_BLOCKS.set(len(self._entries))
        return freed
