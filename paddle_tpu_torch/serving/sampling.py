"""Token selection for generation: greedy, temperature, top-k, top-p, and
the speculative-decode accept rule.

Counterpart of `paddle_tpu/serving/sampling.py` (`select_tokens`,
`greedy_verify`). Filters
are masks over the full vocabulary, as in the JAX version. Sampling draws
from an explicit `torch.Generator`; the engines seed one per slot from the
request's (seed, generation index), so the same (seed, gen) gives the
same token. The bits are not those of `jax.random`.
"""
import torch

__all__ = ["select_tokens", "greedy_verify", "slot_generator_seed"]


def _mask_top_k(logits, k):
    """Keep the k largest logits per row, the dtype minimum elsewhere."""
    kth = torch.sort(logits, dim=-1).values[..., -int(k)][..., None]
    return logits.masked_fill(logits < kth, torch.finfo(logits.dtype).min)


def _mask_top_p(logits, p):
    """Nucleus filter: keep the smallest prefix of the probability-sorted
    vocab whose mass reaches p; the argmax is always kept."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    csum = torch.cumsum(probs, dim=-1) - probs     # mass strictly before
    n_keep = torch.clamp((csum < p).sum(-1), min=1)
    thresh = torch.gather(sorted_logits, -1, (n_keep - 1)[..., None])
    return logits.masked_fill(logits < thresh, torch.finfo(logits.dtype).min)


def select_tokens(logits, generator=None, strategy="greedy", temperature=1.0,
                  top_k=0, top_p=1.0):
    """logits [..., V] -> token ids [...] (int32).

    greedy: argmax. sampling: temperature-scaled categorical draw from
    `generator`, optionally restricted by top-k and/or top-p."""
    if strategy == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if strategy != "sampling":
        raise ValueError(f"unknown decode strategy: {strategy!r}")
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    scaled = logits.float() / max(float(temperature), 1e-6)
    if top_k and int(top_k) > 0:
        scaled = _mask_top_k(scaled, int(top_k))
    if top_p is not None and float(top_p) < 1.0:
        scaled = _mask_top_p(scaled, float(top_p))
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    picks = torch.multinomial(flat, 1, generator=generator)
    return picks.reshape(probs.shape[:-1]).to(torch.int32)


def greedy_verify(logits, window):
    """The speculative-decode accept rule, greedy case, on the device.

    `window` [S, W] is the verify input [t0, d1..d_{W-1}]: t0 the last
    committed token, d_i the draft's proposals. `logits` [S, W, V] are the
    target's logits over it; row i is its distribution for the token after
    window[i]. Draft d_{i+1} is accepted iff it equals the target's argmax
    at row i and every earlier draft was accepted; at the first mismatch
    the target's own argmax is emitted instead, and a fully accepted
    window earns the bonus token of row W-1. The emitted stream is the
    one-token greedy loop's, whatever the draft proposes.

    Returns (choices [S, W] int32, n_accepted [S] int32, last [S] int32):
    slot s emits choices[s, :n_accepted[s] + 1], and `last` (the
    correction or the bonus) is the next round's t0."""
    choices = torch.argmax(logits, dim=-1).to(torch.int32)        # [S, W]
    match = (choices[:, :-1] == window[:, 1:]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    last = torch.gather(choices, 1, n_acc[:, None].to(torch.int64))[:, 0]
    return choices, n_acc, last


def slot_generator_seed(seed, gen):
    """The 63-bit seed of the generator that draws generation index `gen`
    of a request seeded `seed`: a pure function of the pair (a splitmix64
    finalizer over both), never of the slot or the co-resident batch."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(gen) + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF
