"""Sequence-parallel attention: the port of
`paddle_tpu/parallel/ring_attention.py`.

Both functions take the ranks of one sequence-parallel group at once, as
lists in the order of their index on the axis (one controller drives every
rank; `collectives.py`): rank i holds q, k and v of shape
(B, H, S_loc, D) for the sequence rows [i * S_loc, (i + 1) * S_loc).

  * `ring_attention`: blockwise attention with online-softmax
    accumulation in float32; the K/V blocks travel round the ring by
    `ppermute`, so a rank never holds more than S_loc keys. Causality uses
    global positions (the block a rank holds at step t came from rank
    (i - t) mod n), with the JAX function's guards for rows that see no
    key yet. The JAX ring is `jnp` code, not a Pallas kernel, so this is
    plain PyTorch.
  * `ulysses_attention`: one all-to-all turns the sequence shards into
    head shards (q, k and v ride it together, interleaved per destination
    rank as [q_r | k_r | v_r] so that a concatenation does not scramble
    them), full-length attention runs on `heads / n` heads a rank (the
    flash kernels by default), and one all-to-all restores the sequence
    shards.

Both also run with the group split over processes: the caller passes the
members it drives, their indices on the axis (`index`), the group's size
and the exchange that moves values between members (`shift` for the
ring: `collectives.shift_over`, send / recv of the K/V blocks;
`exchange` for Ulysses: `collectives.all_to_all_over`, one
`torch.distributed` all-to-all each way). A member computes exactly what
it computes under one controller.
"""
import math

import torch

from .collectives import all_to_all, ppermute

__all__ = ["ring_attention", "ring_attention_bshd", "ulysses_attention"]


def _block_attend(q, k, v, m, l, o, row_off, col_off, causal, scale):
    """One (q block x kv block) step of the online softmax, f32
    accumulators. q: (B,H,Sq,D); k, v: (B,H,Sk,D); m, l: (B,H,Sq);
    o: (B,H,Sq,D); row_off / col_off: global offsets of the rows / cols."""
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if causal:
        rows = row_off + torch.arange(q.shape[2], device=q.device)[:, None]
        cols = col_off + torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    # guard fully masked rows (m_new == -inf)
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.matmul(p, v.float())
    return m_new, l_new, o_new


def ring_attention(qs, ks, vs, causal=True, scale=None, index=None,
                   size=None, shift=ppermute):
    """Blockwise ring attention over one group: lists of (B, H, S_loc, D)
    in axis order -> the list of outputs in q's dtype. `index` / `size` /
    `shift`: the members' indices on the axis, the group's size and the
    ring step (default: every member, in order, moved by `ppermute`)."""
    n = len(qs) if size is None else size
    index = list(range(len(qs))) if index is None else list(index)
    B, H, S_loc, D = qs[0].shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    state = []
    for q in qs:
        state.append((torch.full((B, H, S_loc), float("-inf"),
                                 device=q.device),
                      torch.zeros((B, H, S_loc), device=q.device),
                      torch.zeros((B, H, S_loc, D), device=q.device)))
    k_cur, v_cur = list(ks), list(vs)
    for step in range(n):
        for j, my in enumerate(index):
            # the kv rank `my` holds now came from rank (my - step) mod n
            col_off = ((my - step) % n) * S_loc
            state[j] = _block_attend(qs[j].float(), k_cur[j].float(),
                                     v_cur[j], *state[j], my * S_loc,
                                     col_off, causal, scale)
        if step < n - 1:     # no trailing rotation after the last block
            k_cur, v_cur = shift(k_cur), shift(v_cur)
    return [(o / l.clamp(min=1e-30)[..., None]).to(q.dtype)
            for (_, l, o), q in zip(state, qs)]


def ring_attention_bshd(qs, ks, vs, causal=True, scale=None):
    """(B, S_loc, H, D) wrapper (paddle's MHA layout)."""
    out = ring_attention([q.transpose(1, 2) for q in qs],
                         [k.transpose(1, 2) for k in ks],
                         [v.transpose(1, 2) for v in vs], causal, scale)
    return [o.transpose(1, 2) for o in out]


def ulysses_attention(qs, ks, vs, causal=True, scale=None, attn_fn=None,
                      size=None, exchange=all_to_all):
    """Ulysses sequence parallelism over one group: lists of
    (B, H, S_loc, D) in axis order -> the list of outputs. Needs H
    divisible by the group size. `attn_fn(q, k, v)` runs the full-length
    attention on (B, H/n, S, D); the default is the flash kernels.
    `size` / `exchange(values, split_dim, concat_dim)`: the group's size
    and its all-to-all (default: every member, `all_to_all`)."""
    n = len(qs) if size is None else size
    B, H, S_loc, D = qs[0].shape
    if H % n:
        raise ValueError(f"ulysses_attention needs heads ({H}) divisible "
                         f"by the sp axis size ({n})")
    if attn_fn is None:
        from ..ops.flash_attention import flash_attention_bhsd

        def attn_fn(q, k, v):
            return flash_attention_bhsd(q, k, v, causal=causal, scale=scale)
    h_loc = H // n

    def chunks(t):                                   # (B,H,S_loc,D) ->
        return t.reshape(B, n, h_loc, S_loc, D)      # (B,n,h_loc,S_loc,D)

    qkv = [torch.cat([chunks(q), chunks(k), chunks(v)], dim=2)
           .reshape(B, 3 * H, S_loc, D) for q, k, v in zip(qs, ks, vs)]
    qkv_h = exchange(qkv, 1, 2)                          # (B, 3h_loc, S, D)
    out = [attn_fn(t[:, :h_loc], t[:, h_loc:2 * h_loc], t[:, 2 * h_loc:])
           for t in qkv_h]                               # (B, h_loc, S, D)
    return exchange(out, 2, 1)                           # (B, H, S_loc, D)
