"""Grad mode and the engine's contracts over torch autograd.

Counterpart of `paddle_tpu/core/autograd.py`. The JAX package records a
tape of `jax.vjp` closures (`Node`, `_topo_from`, `run_backward`); in the
port torch's autograd is the tape, and grad mode is torch's own
(`no_grad` is `torch.no_grad`). What this module keeps of the reference
engine are its contracts that torch does not give by itself:

  * value semantics: a Tensor's in-place methods rebind its torch tensor
    instead of writing into it (`core/tensor.py`), so a view, a handed-out
    `.grad` or a saved value never changes. Torch accumulates `.grad` in
    place, so `prepare_backward` first gives a fresh buffer to every
    leaf whose `.grad` was read since (`note_grad_read`);
  * the in-place version check (reference `Node.input_versions`): an op
    recorded before an in-place change of one of its inputs raises when a
    backward reaches it. Rebinding keeps the old value intact, so the
    check is a record, not a counter: `mark_rebound` tags the old value's
    producer node with the sequence number of the first node made after
    the change, and `prepare_backward` walks the graph (only while such a
    tag or a rebound trainable leaf is alive) and raises for an edge into
    a tagged slot from a node made before the change.
"""
import weakref

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "mark_rebound", "mark_rebound_leaf", "note_grad_read",
           "prepare_backward"]

_KEY = "paddle_tpu_torch.rebound"


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool):
    torch.set_grad_enabled(bool(mode))


def no_grad():
    """paddle.no_grad(): a context manager and decorator (torch's)."""
    return torch.no_grad()


def enable_grad():
    return torch.enable_grad()


class _Rebound:
    """Tag on a node whose output slots were changed in place: a list of
    (output slot, sequence number of the first node made after)."""

    __slots__ = ("slots", "__weakref__")

    def __init__(self):
        self.slots = []


_tags = weakref.WeakSet()        # live _Rebound tags (they die with nodes)
_rebound_leaves = {}             # id -> weakref of a rebound trainable leaf
_grads_read = {}                 # id -> weakref of a leaf whose .grad was read


def _weak_entry(table, t):
    key = id(t)
    table[key] = weakref.ref(t, lambda _r, k=key: table.pop(k, None))


def mark_rebound(old, after_seq):
    """`old` (a non-leaf torch tensor) was replaced in place; nodes made
    before sequence number `after_seq` that consumed it must not be
    differentiated."""
    md = old.grad_fn.metadata
    tag = md.get(_KEY)
    if tag is None:
        tag = md[_KEY] = _Rebound()
        _tags.add(tag)
    tag.slots.append((old.output_nr, after_seq))


def mark_rebound_leaf(old):
    """`old` (a trainable leaf) was replaced under no_grad: any recorded
    use of it must not be differentiated (its gradient would land on a
    tensor no Tensor holds any more)."""
    _weak_entry(_rebound_leaves, old)


def note_grad_read(leaf):
    _weak_entry(_grads_read, leaf)


def _version_error(op, detail):
    return RuntimeError(
        f"in-place modification error in backward of op '{op}': an input "
        f"tensor was mutated after the op recorded it ({detail}); clone() "
        "the tensor before the in-place op")


def _check_versions(roots):
    stack = [r.grad_fn for r in roots if r.grad_fn is not None]
    seen = {}
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen[id(n)] = n                # keeps the wrapper (and its id) alive
        nseq = n._sequence_nr()
        for m, slot in n.next_functions:
            if m is None:
                continue
            if _rebound_leaves and type(m).__name__ == "AccumulateGrad":
                ref = _rebound_leaves.get(id(m.variable))
                if ref is not None and ref() is m.variable:
                    raise _version_error(
                        n.name(), "a trainable leaf was changed in place "
                        "under no_grad after this op used it")
                continue
            if _tags:
                tag = m.metadata.get(_KEY)
                if tag is not None:
                    for out_slot, after in tag.slots:
                        if out_slot == slot and nseq < after:
                            raise _version_error(
                                n.name(), f"tensor version moved past the "
                                f"snapshot this op took at sequence {nseq}")
            stack.append(m)


def prepare_backward(roots):
    """Run before every backward from torch tensors `roots`: the version
    check, then fresh `.grad` buffers for leaves whose grad was handed
    out (torch would add the new gradient into them in place)."""
    if _tags or _rebound_leaves:
        _check_versions(roots)
    if _grads_read:
        for ref in list(_grads_read.values()):
            leaf = ref()
            if leaf is not None and leaf.grad is not None:
                leaf.grad = leaf.grad.clone()
        _grads_read.clear()
