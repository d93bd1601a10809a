"""Paged KV memory: a pool of fixed-size blocks plus block-table attention.

Counterpart of `paddle_tpu/serving/blocks.py`, with its pool gauges, its
`serving.block_alloc` and `serving.kv_ledger_leak` fault sites and its KV
ledger hooks (`BlockPool.attach_ledger`: every refcount transition is
mirrored into an `observability.kvledger.KVLedger`). K/V
live in per-layer pools
`[num_blocks, block_size, heads, head_dim]`; each slot owns an int32 block
table mapping logical block -> physical block id. Block 0 is the reserved
garbage block: unallocated table entries point at it, so stray writes from
right-padded prefill tails land there and masked reads of it stay
invisible.

Writes update the pools in place (the JAX package rebuilds them
functionally); every function that writes returns the pools it wrote so a
caller reads the same way in both packages.

Two attention paths over the same pools:
  * `attend` / `attend_quant` gather the slot's blocks into the dense view
    and run `kv_cache.attend` — the plain version;
  * `attend_kernel` / `attend_kernel_quant` walk the block table inside the
    hand-written CUDA kernel (`ops/paged_attention.py`).
`attention_impl(...)` scopes which one `GPTAttention` runs.
"""
import collections
import contextlib
import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..observability import faults as _faults
from ..observability import metrics as _metrics
from . import kv_cache as kvc

__all__ = ["BlockAllocError", "BlockPool", "PagedLayerKV",
           "QuantPagedLayerKV", "PagedDecodeCache", "alloc_pools",
           "alloc_quant_pools", "write", "quant_write", "gather",
           "gather_quant", "dequant", "dequant_codes", "quantize_codes",
           "attend", "attend_quant", "attend_kernel", "attend_kernel_quant",
           "attention_impl", "current_attention_impl", "blocks_for_tokens",
           "GARBAGE_BLOCK", "QMAX"]

GARBAGE_BLOCK = 0

# int8 symmetric range: codes in [-127, 127], dequant = code * (scale/QMAX)
QMAX = 127.0

_M_POOL_TOTAL = _metrics.gauge(
    "serving_block_pool_blocks_total",
    "Allocatable KV blocks in the live engine's pool (garbage block "
    "excluded)")
_M_POOL_IN_USE = _metrics.gauge(
    "serving_block_pool_blocks_in_use",
    "KV blocks currently referenced (request tables + prefix cache)")


class BlockAllocError(RuntimeError):
    """Block pool exhausted: the scheduler's cue to evict prefix-cache
    entries or preempt a request."""


PagedLayerKV = collections.namedtuple("PagedLayerKV", ["k", "v"])

# int8 pools plus per-block per-head f32 scales [num_blocks, heads]; a
# block's scale row is part of its identity (shared and freed with it).
QuantPagedLayerKV = collections.namedtuple(
    "QuantPagedLayerKV", ["k", "v", "k_scale", "v_scale"])

# Whole-model paged cache: `layers` tuple of (Quant)PagedLayerKV, `tables`
# int32 [slots, max_blocks], `pos` int32 [slots], and `valid` (int32 [S] or
# None): how many of a write's T tokens are real (bucket-padded prefill).
PagedDecodeCache = collections.namedtuple(
    "PagedDecodeCache", ["layers", "tables", "pos", "valid"],
    defaults=(None,))


def blocks_for_tokens(n_tokens, block_size):
    """Logical blocks needed to hold n_tokens."""
    return -(-int(n_tokens) // int(block_size))


def alloc_pools(num_layers, num_blocks, block_size, num_heads, head_dim,
                dtype=torch.float32, device=None):
    """Zeroed K/V pools for a whole model: one PagedLayerKV per layer, on
    `device` (None: the card, as every entry point of the port)."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, num_heads, head_dim)
    return tuple(PagedLayerKV(torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(num_layers))


def alloc_quant_pools(num_layers, num_blocks, block_size, num_heads,
                      head_dim, device=None):
    """Zeroed int8 K/V pools + per-block per-head f32 scales, on `device`
    (None: the card)."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, num_heads, head_dim)
    sshape = (num_blocks, num_heads)

    def z(sh, dt):
        return torch.zeros(sh, dtype=dt, device=device)
    return tuple(QuantPagedLayerKV(z(shape, torch.int8), z(shape, torch.int8),
                                   z(sshape, torch.float32),
                                   z(sshape, torch.float32))
                 for _ in range(num_layers))


def _positions(pos, T):
    """[S, T] int64 logical positions pos + 0..T-1."""
    return pos.to(torch.int64)[:, None] + \
        torch.arange(T, device=pos.device)[None, :]


def write(pool, new, tables, pos):
    """Scatter `new` [S, T, h, d] into `pool` [N, bs, h, d] at logical
    positions pos + 0..T-1 of each slot, through `tables` [S, nb], in
    place. Positions past the table land in the garbage block. Returns
    pool."""
    bs = pool.shape[1]
    nb = tables.shape[1]
    positions = _positions(pos, new.shape[1])
    lb = positions // bs
    off = positions % bs
    phys = torch.gather(tables.to(torch.int64), 1, lb.clamp(max=nb - 1))
    phys = torch.where(lb < nb, phys, torch.full_like(phys, GARBAGE_BLOCK))
    pool[phys, off] = new.to(pool.dtype)
    return pool


def dequant(codes, scale):
    """int8 block codes [..., bs, h, d] against per-block per-head scales
    [..., h]: `code * (scale / QMAX)`."""
    return dequant_codes(codes, scale[..., None, :, None])


def dequant_codes(codes, scale_b):
    """The canonical dequant over a broadcast-ready scale:
    `code * (scale / QMAX)`. The multiplication order is part of the
    contract: the kernel computes the identical expression."""
    return codes.to(torch.float32) * (scale_b / QMAX)


def quantize_codes(x, scale_b):
    """The canonical quantize over a broadcast-ready positive scale:
    round-half-even and clip to int8 codes."""
    q = torch.clamp(torch.round(x / scale_b * QMAX), -QMAX, QMAX)
    return q.to(torch.int8)


def _quantize(x, scale):
    """x [..., bs, h, d] f32 -> int8 codes against per-head scales [..., h]
    (zero-scale blocks quantize to 0)."""
    return quantize_codes(x, torch.clamp(scale, min=1e-30)[..., None, :,
                                                           None])


def quant_write(pool, scale, new, tables, pos, valid=None):
    """The quantizing `write`: scatter float `new` [S, T, h, d] into the
    int8 `pool` [N, bs, h, d] and its `scale` [N, h], in place; returns
    (pool, scale).

    Every block the new tokens land in is dequantized, its resident
    positions (< pos) kept, the new tokens overlaid, everything at or past
    pos + valid zeroed (`valid` [S] defaults to T: bucket padding must
    neither ride the abs-max scale nor leave nonzero codes), and the block
    requantized against its new per-head abs-max. Fully written earlier
    blocks are never touched, which keeps shared prefix blocks immutable."""
    S, T = new.shape[0], new.shape[1]
    bs = pool.shape[1]
    nb = tables.shape[1]
    dev = pool.device
    pos = pos.to(torch.int64)
    tables = tables.to(torch.int64)
    # blocks one slot's T-token write can touch, at most
    nblk = (T + bs - 2) // bs + 1
    base = torch.div(pos, bs, rounding_mode="floor")             # [S]
    tlb = base[:, None] + torch.arange(nblk, device=dev)[None, :]
    phys = torch.gather(tables, 1, tlb.clamp(max=nb - 1))
    phys = torch.where(tlb < nb, phys, torch.full_like(phys, GARBAGE_BLOCK))
    f = dequant(pool[phys], scale[phys])           # [S, nblk, bs, h, d]
    gpos = tlb[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
    positions = _positions(pos, T)
    bidx = torch.div(positions, bs, rounding_mode="floor") - base[:, None]
    off = positions % bs
    sidx = torch.arange(S, device=dev)[:, None].expand(S, T)
    f[sidx, bidx, off] = new.to(torch.float32)
    n_real = torch.full((S,), T, dtype=torch.int64, device=dev) \
        if valid is None else torch.clamp(valid.to(torch.int64), max=T)
    keep = gpos < (pos + n_real)[:, None, None]
    f = f.masked_fill(~keep[..., None, None], 0.0)
    s_new = torch.amax(f.abs(), dim=(2, 4))                  # [S, nblk, h]
    # duplicate phys entries (overflow into the garbage block) scatter in
    # an unspecified order: garbage only, as in `write`
    pool[phys] = _quantize(f, s_new)
    scale[phys] = s_new
    return pool, scale


def gather(pool, tables):
    """Each slot's contiguous [S, nb * bs, h, d] view through its table."""
    S, nb = tables.shape
    g = pool[tables.to(torch.int64)]                 # [S, nb, bs, h, d]
    return g.reshape(S, nb * pool.shape[1], pool.shape[2], pool.shape[3])


def gather_quant(pool, scales, tables):
    """Dequantizing `gather` of an int8 pool: the dense f32 view."""
    S, nb = tables.shape
    t = tables.to(torch.int64)
    f = dequant(pool[t], scales[t])
    return f.reshape(S, nb * pool.shape[1], pool.shape[2], pool.shape[3])


def attend(q, k_pool, v_pool, tables, pos, scale=None):
    """Plain block-table attention: gather the dense view, then the exact
    masked math of `kv_cache.attend`."""
    return kvc.attend(q, gather(k_pool, tables), gather(v_pool, tables),
                      pos, scale)


def attend_quant(q, k_pool, v_pool, k_scale, v_scale, tables, pos,
                 scale=None):
    """Plain quantized block-table attention over the dequantized view."""
    return kvc.attend(q, gather_quant(k_pool, k_scale, tables),
                      gather_quant(v_pool, v_scale, tables), pos, scale)


def attend_kernel(q, k_pool, v_pool, tables, pos, scale=None):
    """Block-table attention in the CUDA kernel (the table is walked in the
    kernel; no dense view). Same masking as `attend`, online-softmax
    numerics: float-equal, not bit-equal."""
    from ..ops.paged_attention import paged_attention
    return paged_attention(q, k_pool, v_pool, tables, pos, scale=scale)


def attend_kernel_quant(q, k_pool, v_pool, k_scale, v_scale, tables, pos,
                        scale=None):
    """Quantized block-table attention with in-kernel dequant."""
    from ..ops.paged_attention import paged_attention
    return paged_attention(q, k_pool, v_pool, tables, pos, scale=scale,
                           k_scale=k_scale, v_scale=v_scale, qmax=QMAX)


# Which attend GPTAttention runs over paged caches: "gather" (plain) or
# "kernel". The engines wrap every forward in `attention_impl(...)`. The
# scope is per thread: a serving worker runs forwards on its step loop
# and on its RPC handler threads, and workers hosted in one process run
# theirs concurrently, so one thread's exit must not change another's
# forward.
_ATTEND = threading.local()


def current_attention_impl():
    return getattr(_ATTEND, "impl", "gather")


@contextlib.contextmanager
def attention_impl(impl):
    """Scope the paged-attend implementation for forwards this thread
    runs inside."""
    if impl not in ("gather", "kernel"):
        raise ValueError(f"unknown paged attention impl {impl!r} "
                         f"(want 'gather' or 'kernel')")
    prev = current_attention_impl()
    _ATTEND.impl = impl
    try:
        yield
    finally:
        _ATTEND.impl = prev


class BlockPool:
    """Host-side refcounted allocator over physical block ids
    1..num_blocks-1 (0 is the garbage block). A block returns to the free
    list when its last reference drops; the prefix cache holds one
    reference per cached block and each request's table row one per
    entry, so shared blocks are never written."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (one is reserved "
                             "as the garbage block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, GARBAGE_BLOCK, -1))
        self._refs = np.zeros((self.num_blocks,), np.int32)
        # the KV ledger the engine attaches (None: off, one `is None`
        # check per operation)
        self._ledger = None
        self._export()

    def attach_ledger(self, ledger):
        self._ledger = ledger

    @property
    def capacity(self):
        """Allocatable blocks (garbage block excluded)."""
        return self.num_blocks - 1

    @property
    def available(self):
        return len(self._free)

    @property
    def in_use(self):
        return self.capacity - len(self._free)

    def refcount(self, block_id):
        return int(self._refs[block_id])

    def _export(self):
        _M_POOL_TOTAL.set(self.capacity)
        _M_POOL_IN_USE.set(self.in_use)

    def alloc(self, n=1):
        """Allocate n blocks, all or nothing; raises BlockAllocError.
        `serving.block_alloc` fires first: armed with exc=BlockAllocError
        it simulates exhaustion, its default raise a failed prefill."""
        _faults.fire("serving.block_alloc")
        if n > len(self._free):
            raise BlockAllocError(
                f"block pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.capacity}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        if self._ledger is not None:
            self._ledger.pool_alloc(out)
        self._export()
        return out

    def ref(self, block_id):
        """One more reference on an allocated block (prefix sharing)."""
        if block_id == GARBAGE_BLOCK or self._refs[block_id] < 1:
            raise ValueError(f"ref of unallocated block {block_id}")
        self._refs[block_id] += 1
        if self._ledger is not None:
            self._ledger.pool_ref(block_id)

    def unref(self, block_id):
        """Drop one reference; the block is freed at zero. The
        `serving.kv_ledger_leak` site fires when a last reference drops:
        in truncate mode the block is not put back on the free list while
        the ledger records its free (a leak the reconciler catches within
        one scheduler step)."""
        if block_id == GARBAGE_BLOCK:
            return
        if self._refs[block_id] < 1:
            raise ValueError(f"unref of free block {block_id}")
        self._refs[block_id] -= 1
        if self._ledger is not None:
            self._ledger.pool_unref(block_id)
        if self._refs[block_id] == 0:
            if self._ledger is not None:
                self._ledger.pool_free(block_id)
            spec = _faults.fire("serving.kv_ledger_leak")
            if spec is None or spec.mode != "truncate":
                self._free.append(int(block_id))
        self._export()
