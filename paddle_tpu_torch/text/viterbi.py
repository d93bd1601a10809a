"""Viterbi decoding (counterpart of `paddle_tpu/text/viterbi.py`).

The forward DP and the backtrace are loops over T with one torch pass a
step on the tensors' device, with ragged lengths handled by the same
left-length masking as the reference kernel. With include_bos_eos_tag,
row N-1 of the transition matrix is the start tag and row N-2 the stop
tag. Argmax ties pick the lower tag, as `jnp.argmax` does. Paths are
int64 (ROADMAP C.14's width map).
"""
import torch

from ..core.tensor import apply_op
from ..nn import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _viterbi(potentials, trans, lengths, include_bos_eos_tag,
             start_trans=None, stop_trans=None):
    """The DP. With include_bos_eos_tag, start / stop live in rows N-1 /
    N-2 of the square `trans`; explicit `start_trans` / `stop_trans`
    vectors may be passed instead (the CRF [N+2, N] layout)."""
    B, T, N = potentials.shape
    lengths = lengths.to(potentials.device, torch.int64)
    pot = potentials.float()
    trans = trans.float()
    if include_bos_eos_tag:
        start_trans, stop_trans = trans[N - 1], trans[N - 2]
    if start_trans is not None:
        start_trans = start_trans.float()
    if stop_trans is not None:
        stop_trans = stop_trans.float()

    alpha = pot[:, 0]
    if start_trans is not None:
        alpha = alpha + start_trans[None]
    if stop_trans is not None:
        alpha = alpha + torch.where((lengths == 1)[:, None], stop_trans[None],
                                    0.0)
    left0 = lengths - 1
    left = left0
    history = []
    for t in range(1, T):
        # (B, prev N, next N): the best previous tag for each next tag
        scores = alpha[:, :, None] + trans[None]
        best, hist = scores.max(dim=1)
        live = (left > 0)[:, None]
        alpha = torch.where(live, best + pot[:, t], alpha)
        if stop_trans is not None:
            alpha = alpha + torch.where((left == 1)[:, None],
                                        stop_trans[None], 0.0)
        left = left - 1
        history.append(hist)

    best_scores, last_ids = alpha.max(dim=1)
    # backtrace: positions past a sequence's length emit 0 and hold the
    # last id until the live window is reached
    left_after = left0 - (T - 1)
    ids, left, rev_path = last_ids, left_after, []
    for hist in reversed(history):
        left = left + 1
        picked = torch.gather(hist, 1, ids[:, None])[:, 0]
        upd = torch.where(left > 0, picked, torch.zeros_like(picked))
        upd = torch.where(left == 0, ids, upd)
        ids = torch.where(left < 0, ids, upd)
        rev_path.append(upd)
    tail = torch.where(left_after >= 0, last_ids, torch.zeros_like(last_ids))
    path = torch.stack(rev_path[::-1] + [tail], dim=1)
    return best_scores, path


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """Highest-scoring tag path. potentials (B, T, N), transition (N, N),
    lengths (B,). Returns (scores (B,), paths (B, T); entries past a
    sequence's length are 0)."""
    return apply_op(
        lambda p, t, l: _viterbi(p, t, l, include_bos_eos_tag),
        potentials, transition_params, lengths)


class ViterbiDecoder(Layer):
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
