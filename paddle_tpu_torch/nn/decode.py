"""Beam-search decoding (counterpart of `paddle_tpu/nn/decode.py`):
`BeamSearchDecoder` and `dynamic_decode` over the reference's Decoder
protocol, eager on the tensors' device.

The batch is tiled to batch * beam rows; beam 0 starts at log-prob 0 and
the others at -1e9; a finished beam may only continue with <end> at no
cost; `finalize` backtraces each surviving beam through its parents. The
top-k over beam * vocab keeps `jax.lax.top_k`'s order on ties (the lower
index first) through a stable descending sort (ROADMAP C.17). Tokens,
parents and lengths are int64 (ROADMAP C.14's width map).
"""
import torch

from ..core.tensor import Tensor

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _d(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _map_state(state, fn):
    if isinstance(state, (list, tuple)):
        return type(state)(_map_state(s, fn) for s in state)
    return fn(state)


def _top_k(x, k):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (as `jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BeamSearchDecoder:
    """Wraps an RNN cell: each step embeds the previous token, advances
    the cell, projects to the vocabulary (`output_fn`) and keeps the
    `beam_size` best continuations by summed log-probability."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        """Tile batch -> batch * beam; beam 0 at log-prob 0, the others at
        -1e9."""
        states = _map_state(initial_cell_states,
                            lambda s: torch.repeat_interleave(
                                _d(s), self.beam_size, dim=0))
        some = states[0] if isinstance(states, (list, tuple)) else states
        dev = some.device
        B = some.shape[0] // self.beam_size
        tokens = torch.full((B * self.beam_size,), self.start_token,
                            dtype=torch.int64, device=dev)
        first = torch.full((self.beam_size,), -1e9, dtype=torch.float32,
                           device=dev)
        first[0] = 0.0
        log_probs = first.repeat(B)
        finished = torch.zeros((B * self.beam_size,), dtype=torch.bool,
                               device=dev)
        return tokens, (states, log_probs, finished)

    def step(self, time, tokens, beam_state):
        states, log_probs, finished = beam_state
        B = tokens.shape[0] // self.beam_size
        inp = Tensor(tokens)
        if self.embedding_fn is not None:
            inp = self.embedding_fn(inp)
        cell_in = [Tensor(s) for s in states] \
            if isinstance(states, (list, tuple)) else Tensor(states)
        out = self.cell(inp, cell_in)
        # RNN cells return (output, new_states)
        cell_out, new_states = out if isinstance(out, tuple) and \
            len(out) == 2 else (out, out)
        logits = self.output_fn(cell_out) if self.output_fn is not None \
            else cell_out
        lp_step = torch.log_softmax(_d(logits).float(), dim=-1)
        V = lp_step.shape[-1]
        # finished beams: only <end> is allowed, at zero added cost
        end_only = torch.full((V,), -1e9, dtype=torch.float32,
                              device=lp_step.device)
        end_only[self.end_token] = 0.0
        lp_step = torch.where(finished[:, None], end_only[None], lp_step)
        total = (log_probs[:, None] + lp_step).reshape(
            B, self.beam_size * V)
        top_lp, top_idx = _top_k(total, self.beam_size)
        beam_src = top_idx // V                          # the parent beam
        next_tok = (top_idx % V).reshape(-1)
        gather = (torch.arange(B, device=total.device)[:, None]
                  * self.beam_size + beam_src).reshape(-1)
        new_states = _map_state(
            new_states, lambda s: torch.index_select(_d(s), 0, gather))
        next_finished = finished[gather] | (next_tok == self.end_token)
        # the parent slot of each new beam rebuilds the sequences (stacking
        # per-slot tokens would interleave different beams' histories)
        parents = beam_src.reshape(-1)
        return (next_tok, parents,
                (new_states, top_lp.reshape(-1), next_finished),
                next_finished)

    def finalize(self, step_tokens, step_parents, final_state):
        """Backtrace each surviving beam through the parent pointers.
        step_tokens / step_parents: lists of (B * beam,) tensors in time
        order. Returns (B, beam, T) token ids."""
        B_beam = step_tokens[0].shape[0]
        beam = self.beam_size
        dev = step_tokens[0].device
        slot = torch.arange(B_beam, device=dev)          # the final slots
        base = (slot // beam) * beam
        seq = []
        for t in range(len(step_tokens) - 1, -1, -1):
            seq.append(step_tokens[t][slot])
            slot = base + step_parents[t][slot]
        ids = torch.stack(seq[::-1], dim=-1)             # (B * beam, T)
        return ids.reshape(B_beam // beam, beam, -1)


def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Run decoder.initialize, then step until every beam is finished or
    max_step_num. Returns (token ids (B, beam, T), final log-probs
    (B, beam)) and, with return_length, the lengths of the reconstructed
    paths (up to and including the first <end>)."""
    tokens, state = decoder.initialize(inits)
    beam = decoder.beam_size
    B = tokens.shape[0] // beam
    step_tokens, step_parents = [], []
    for t in range(int(max_step_num)):
        tokens, parents, state, finished = decoder.step(t, tokens, state)
        step_tokens.append(tokens)
        step_parents.append(parents)
        if bool(torch.all(finished)):
            break
    ids = decoder.finalize(step_tokens, step_parents, state)
    _, log_probs, _ = state
    out = (Tensor(ids), Tensor(log_probs.reshape(B, beam)))
    if return_length:
        T = ids.shape[-1]
        is_end = ids == decoder.end_token
        first_end = torch.argmax(is_end.to(torch.int64), dim=-1)
        lengths = torch.where(is_end.any(-1), first_end + 1,
                              torch.full_like(first_end, T))
        return out + (Tensor(lengths),)
    return out
