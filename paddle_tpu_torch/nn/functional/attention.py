"""Attention functionals (counterpart of
`paddle_tpu/nn/functional/attention.py`): the kernel route of the `nn`
surface.

`scaled_dot_product_attention` takes (B, S, H, D). The reference sends it
to its Pallas flash kernels wherever `_use_pallas`
(`paddle_tpu/ops/flash_attention.py`) says so on its accelerator, and to
the dense XLA attention `_ref_attention_bhsd` everywhere else. The port
decides by the same rule, a pure function of shapes and device
(`sdpa_route`), before anything launches:

  * "kernel": a CUDA tensor with Sq == Sk, S % 128 == 0 and D in
    (64, 128, 256) runs `flash_attention_bhsd`, whose forward, dQ and
    dK/dV are the hand-written CUDA kernels, built for every input the
    rule sends there (head dims 64, 128 and 256 in f32, bf16 and
    float16); a failure raises from the wrapper's own checks and never
    runs the dense attention on the card;
  * "plain": everything else runs `reference_attention_bhsd`, the port of
    `_ref_attention_bhsd`, where the reference runs it too: cross-length
    attention (a decode `Cache` whose keys have grown), S not a multiple
    of 128, another head dim, and every CPU tensor, as the reference runs
    off the TPU.

`sdpa_routes` counts every call by route. A failure on the kernel route
raises; nothing is caught and nothing falls back.

Masks broadcast: a [B, 1, 1, S] key-padding or an [S, S] causal mask goes
to the kernel wrapper as it is, which expands it to (B|1, H|1, S, S),
never per head. The two routes treat a fully masked query row as the
reference's two routes do (ROADMAP C.15): the kernel zeroes it (scores
clamp at -1e30, a row with no live key is zero); the plain route zeroes
only NaN rows, so with a finite mask such a row is the mean of V.

The dropout seed is drawn from the CPU generator of `core.random` (one
int32, as the reference draws it from its key stream) as a 0-d int64 CPU
tensor: the kernel ops read it on the host (a draw on the card would
cost a host sync per call), and inside a traced program (`jit`) the draw
is a node of the program, so every run draws a fresh seed, as the
reference threads a fresh key into each call of a jitted program. Given
the seed, both routes keep the same elements (`dropout_keep`, the TPU
kernel's hash bit for bit).

`sdpa_route` is decided when the program is traced: a program traced on
the CPU holds the plain attention, one traced on the card the kernel.
"""
import numpy as np
import torch

from ...core.random import generator
from ...core.tensor import apply_op
from ...ops import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "sparse_attention",
           "sdpa_route", "sdpa_routes"]

sdpa_routes = {"kernel": 0, "plain": 0}

_PALLAS_HEAD_DIMS = (64, 128, 256)     # `_use_pallas`'s head dims
_INT32_MAX = np.iinfo(np.int32).max


def sdpa_route(q_shape, k_shape, device):
    """'kernel' or 'plain' for (B, S, H, D) query and key shapes: the
    reference's `_use_pallas` rule, on CUDA."""
    Sq, D = q_shape[1], q_shape[3]
    return "kernel" if (torch.device(device).type == "cuda"
                        and Sq == k_shape[1] and Sq % 128 == 0
                        and D in _PALLAS_HEAD_DIMS) else "plain"


def _dropout_seed():
    return torch.randint(0, _INT32_MAX, (), dtype=torch.int64,
                         generator=generator(torch.device("cpu")))


def _attend(route, q, k, v, mask, causal, scale, rate, seed):
    """Attention over torch tensors (B, S, H, D) on the given route."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if route == "kernel":
        out = _fa.flash_attention_bhsd(qt, kt, vt, causal=causal,
                                       scale=scale, mask=mask,
                                       dropout_rate=rate, dropout_seed=seed)
    else:
        out = _fa.reference_attention_bhsd(qt, kt, vt, causal=causal,
                                           scale=scale, mask=mask,
                                           dropout_rate=rate,
                                           dropout_seed=seed)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """(B, S, H, D) attention; k / v may have fewer heads (GQA). The
    mask is additive (a bool mask adds 1 / 0, as in the reference)."""
    D = query.shape[-1]
    scale = 1.0 / (D ** 0.5)
    rate = float(dropout_p) if training else 0.0
    seed = _dropout_seed() if rate > 0.0 else None
    route = sdpa_route(query.shape, key.shape, query._data.device)
    sdpa_routes[route] += 1

    def fn(q, k, v, *rest):
        return _attend(route, q, k, v, rest[0] if rest else None, is_causal,
                       scale, rate, seed)

    args = (query, key, value) if attn_mask is None \
        else (query, key, value, attn_mask)
    return apply_op(fn, *args, name="scaled_dot_product_attention")


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """CSR-restricted attention over (B, H, S, D): sparse_csr_offset
    (B, H, S+1) and sparse_csr_columns (B, H, nnz) name, for each query
    row, the key columns it may attend to. As in the reference, the
    pattern is expanded to a dense mask and the attention is dense; a row
    with no allowed key is zero."""
    has_kpm = key_padding_mask is not None
    has_am = attn_mask is not None

    def fn(q, k, v, off, cols, *rest):
        B, H, S, D = q.shape
        nnz = cols.shape[-1]
        off = off.reshape(B * H, S + 1).to(torch.int64)
        cols = cols.reshape(B * H, nnz).to(torch.int64)
        ar = torch.arange(nnz, device=q.device).expand(B * H, nnz)
        rows = torch.searchsorted(off, ar.contiguous(), right=True) - 1
        bh = torch.arange(B * H, device=q.device)[:, None].expand(B * H, nnz)
        allowed = torch.zeros((B * H, S, S), dtype=torch.bool,
                              device=q.device)
        allowed = allowed.index_put((bh, rows, cols),
                                    torch.ones((), dtype=torch.bool,
                                               device=q.device))
        allowed = allowed.reshape(B, H, S, S)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (1.0 / D ** 0.5)
        rest = list(rest)
        if has_kpm:
            kpm = rest.pop(0)                  # (B, S); 0 => masked key
            allowed = allowed & (kpm != 0)[:, None, None, :]
        if has_am:
            am = rest.pop(0)                   # (S, S); 0 => masked
            allowed = allowed & (am != 0)[None, None]
        s = s.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(s, -1)
        p = torch.where(torch.isnan(p), 0.0, p).to(q.dtype)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)

    args = [query, key, value, sparse_csr_offset, sparse_csr_columns]
    if has_kpm:
        args.append(key_padding_mask)
    if has_am:
        args.append(attn_mask)
    return apply_op(fn, *args, name="sparse_attention")
