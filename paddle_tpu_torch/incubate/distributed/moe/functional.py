"""The functional MoE core (counterpart of
`paddle_tpu/incubate/distributed/moe/functional.py`): gating, the
capacity-constrained top-k dispatch, and the expert-parallel exchange.

The (token, expert, capacity) one-hot dispatch follows the GShard
formulation; the reference reaches the same result with index scatter
kernels (moe_layer.py:106-173 prune_gate_by_capacity + global_scatter).
"""
import math

import torch
import torch.nn.functional as TF

from ....parallel import collectives as C

__all__ = ["compute_capacity", "gshard_dispatch", "moe_forward",
           "init_moe_experts"]


def compute_capacity(capacity_factor, k, num_tokens, num_experts):
    """The one place the per-expert buffer size is defined."""
    return int(math.ceil(capacity_factor * k * num_tokens / num_experts))


def gshard_dispatch(gates, k, capacity):
    """Top-k capacity-constrained routing of (T, E) softmax probabilities.

    Returns (combine (T, E, C) f32 normalized routing weights, dispatch
    (T, E, C) bool, aux_loss: E * sum(me * ce)). Tokens beyond an expert's
    capacity C are dropped (zero rows), as the reference's
    prune_gate_by_capacity drops them."""
    T, E = gates.shape
    Cap = capacity
    if k > E:
        raise ValueError(f"top-k={k} exceeds num_experts={E}")
    f32 = torch.float32
    gates = gates.to(f32)
    remaining = gates
    prev_count = torch.zeros((E,), dtype=torch.int64, device=gates.device)
    kept_weight_sum = torch.zeros((T,), dtype=f32, device=gates.device)
    aux_loss = torch.zeros((), dtype=f32, device=gates.device)
    parts = []
    for pick in range(k):
        idx = remaining.argmax(-1)
        m = TF.one_hot(idx, E).to(f32)
        w = (gates * m).sum(-1)
        if pick == 0:
            aux_loss = E * (gates.mean(0) * m.mean(0)).sum()
        pos_in_expert = m.cumsum(0) - m
        pos = (pos_in_expert * m).sum(-1).to(torch.int64)
        pos = pos + (prev_count[None, :] * m).sum(-1).to(torch.int64)
        prev_count = prev_count + m.sum(0).to(torch.int64)
        keep = pos < Cap
        w_kept = torch.where(keep, w, torch.zeros((), dtype=f32,
                                                  device=w.device))
        kept_weight_sum = kept_weight_sum + w_kept
        onehot_c = TF.one_hot(pos.clamp(0, Cap - 1), Cap).to(f32) \
            * keep[:, None].to(f32)
        parts.append((w_kept, m, onehot_c))
        remaining = remaining * (1.0 - m)
    denom = kept_weight_sum.clamp(min=1e-9)[:, None, None]
    combine = torch.zeros((T, E, Cap), dtype=f32, device=gates.device)
    for w_kept, m, onehot_c in parts:
        combine = combine + (w_kept[:, None, None] * m[:, :, None]
                             * onehot_c[:, None, :])
    combine = combine / denom
    return combine, combine > 0.0, aux_loss


def _expert_ffn(x, params, activation):
    """x: (E_local, C_total, d); params: stacked (E_local, ...) tensors."""
    h = torch.einsum("ecd,edf->ecf", x, params["w1"]) + \
        params["b1"][:, None, :]
    h = activation(h)
    return torch.einsum("ecf,efd->ecd", h, params["w2"]) + \
        params["b2"][:, None, :]


def _gelu(x):
    return TF.gelu(x, approximate="tanh")


def _route(x, gate_w, k, capacity_factor, E, jitter_noise):
    """(expert_in (E, C, d), combine (T, E, C), aux) of one rank's
    tokens."""
    T = x.shape[0]
    Cap = compute_capacity(capacity_factor, k, T, E)
    logits = torch.matmul(x.float(), gate_w.float())
    if jitter_noise is not None:
        gen, eps = jitter_noise
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        logits = logits * (1.0 - eps + 2.0 * eps * u)
    gates = torch.softmax(logits, -1)
    combine, dispatch, aux = gshard_dispatch(gates, k, Cap)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
    return expert_in, combine.to(x.dtype), aux


def moe_forward(x, gate_w, expert_params, *, k=2, capacity_factor=1.2,
                axis_name=None, num_experts=None, activation=_gelu,
                jitter_noise=None):
    """The MoE FFN over flattened tokens.

    Without `axis_name`: x (T, d), gate_w (d, E), expert_params stacked
    (E, ...) -> (out (T, d), aux_loss). With `axis_name` (a manual
    region over the ep group, one value a rank): x, gate_w and
    expert_params are lists with one entry a rank of the group (each
    rank's local (E/ep, ...) expert shard), the dispatched tokens go to
    their experts' owners and back with one list all_to_all each way (the
    reference's global_scatter / global_gather), and the result is the
    list of the ranks' (out, aux_loss)."""
    if axis_name is None:
        E = num_experts or gate_w.shape[-1]
        expert_in, combine, aux = _route(x, gate_w, k, capacity_factor, E,
                                         jitter_noise)
        out = _expert_ffn(expert_in, expert_params, activation)
        return torch.einsum("ecd,tec->td", out, combine), aux
    ep = len(x)
    E = num_experts or gate_w[0].shape[-1]
    if E % ep:
        raise ValueError(f"num_experts={E} not divisible by ep={ep}")
    routed = [_route(xi, gw, k, capacity_factor, E, jitter_noise)
              for xi, gw in zip(x, gate_w)]
    # (E, C, d) -> (E/ep, ep*C, d): my experts' tokens from every rank
    ins = C.all_to_all([r[0] for r in routed], 0, 1)
    outs = [_expert_ffn(i, p, activation) for i, p in zip(ins, expert_params)]
    outs = C.all_to_all(outs, 1, 0)
    return [(torch.einsum("ecd,tec->td", o, r[1]), r[2])
            for o, r in zip(outs, routed)]


def init_moe_experts(generator, num_experts_local, d_model, d_hidden,
                     dtype=torch.float32, device="cpu"):
    """Stacked FFN expert params: a dict of (E_local, ...) tensors drawn
    from `generator` (U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases)."""
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_hidden)

    def u(shape, s):
        r = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=device)
        return ((2 * r - 1) * s).to(dtype)
    return {"w1": u((num_experts_local, d_model, d_hidden), s1),
            "b1": torch.zeros((num_experts_local, d_hidden), dtype=dtype,
                              device=device),
            "w2": u((num_experts_local, d_hidden, d_model), s2),
            "b2": torch.zeros((num_experts_local, d_model), dtype=dtype,
                              device=device)}
