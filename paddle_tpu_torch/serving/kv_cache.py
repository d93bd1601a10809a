"""Preallocated dense KV cache: `[slots, max_len, heads, head_dim]` per
layer, written at per-slot positions.

Counterpart of `paddle_tpu/serving/kv_cache.py`. PyTorch runs eagerly, so
the buffers are updated in place (`write` returns the same tensor) rather
than rebuilt functionally; the masking contract of `attend` is the JAX
one, detail for detail, because the paged kernel is held against it.
"""
import collections

import torch

from ..core.device import resolve_device

__all__ = ["LayerKV", "DecodeCache", "alloc_kv", "alloc_cache", "write",
           "attend", "MASK_VALUE"]

# One layer's key/value buffers: [slots, max_len, heads, head_dim].
LayerKV = collections.namedtuple("LayerKV", ["k", "v"])

# Whole-model cache: `layers` tuple of LayerKV, `pos` int32 [slots] tokens
# already written per slot.
DecodeCache = collections.namedtuple("DecodeCache", ["layers", "pos"])

# Finite large-negative mask fill. The dtype minimum is not safe: softmax
# subtracts the row max, and min minus a positive max overflows to -inf;
# an all-masked row of -inf becomes NaN.
MASK_VALUE = -1e30


def alloc_kv(slots, max_len, num_heads, head_dim, dtype=torch.float32,
             device=None):
    """Zeros for one layer's K/V pair, on `device` (None: the card, as
    every entry point of the port)."""
    device = resolve_device(device)
    shape = (slots, max_len, num_heads, head_dim)
    return LayerKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def alloc_cache(num_layers, slots, max_len, num_heads, head_dim,
                dtype=torch.float32, device=None):
    """Zeros for a whole model: num_layers LayerKV buffers + pos=0, on
    `device` (None: the card)."""
    device = resolve_device(device)
    layers = tuple(alloc_kv(slots, max_len, num_heads, head_dim, dtype,
                            device) for _ in range(num_layers))
    return DecodeCache(layers, torch.zeros((slots,), dtype=torch.int32,
                                           device=device))


def write(buf, new, pos):
    """Write `new` [S, T, h, d] into `buf` [S, L, h, d] at per-slot start
    positions `pos` [S], in place. Starts are clamped into bounds the way
    `lax.dynamic_update_slice` clamps them (start <= L - T). Returns buf."""
    S, T = new.shape[0], new.shape[1]
    L = buf.shape[1]
    start = pos.to(torch.int64).clamp(0, L - T)
    idx = start[:, None] + torch.arange(T, device=buf.device)[None, :]
    rows = torch.arange(S, device=buf.device)[:, None].expand(S, T)
    buf[rows, idx] = new.to(buf.dtype)
    return buf


def attend(q, k_buf, v_buf, pos, scale=None):
    """Masked attention of `q` [S, T, h, d] against the buffers
    [S, L, h, d], where the T query tokens sit at positions pos..pos+T-1.
    Key j is visible to query i iff j <= pos + i.

    Padded-region hygiene, as in the JAX reference: masked scores take the
    finite -1e30; probabilities off the mask are exact zeros; value rows
    no query of this call can see are zeroed with a select (the paged
    pool's garbage block may hold inf/NaN and 0 * inf is NaN); rows with no
    visible key emit exact zeros."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    L = k_buf.shape[1]
    T = q.shape[1]
    dev = q.device
    limit = pos.to(torch.int64)[:, None] + torch.arange(T, device=dev)
    cols = torch.arange(L, device=dev)
    visible = cols[None, None, :] <= limit[:, :, None]          # [S, T, L]
    scores = torch.einsum("sthd,slhd->shtl", q, k_buf) * scale
    scores = scores.masked_fill(~visible[:, None], MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    # exact zeros off the mask: extra gathered-but-masked positions of the
    # paged view contribute exactly nothing
    probs = probs.masked_fill(~visible[:, None], 0.0)
    # a zero probability is not enough against inf/NaN in V: select zeros
    # for the rows no query of this call can ever see
    ever_visible = cols[None, :] <= limit[:, -1:]                # [S, L]
    v_buf = v_buf.masked_fill(~ever_visible[:, :, None, None], 0.0)
    out = torch.einsum("shtl,slhd->sthd", probs, v_buf)
    any_visible = visible.any(dim=-1)                            # [S, T]
    return out.masked_fill(~any_visible[:, :, None, None], 0.0)
