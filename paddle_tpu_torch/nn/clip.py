"""Gradient clipping (counterpart of `paddle_tpu/nn/clip.py`).

The eager `__call__` takes and returns (param, grad Tensor) pairs and
leaves a parameter with `need_clip=False` (or no gradient) alone;
`clip_tree` is the functional form over a tree of raw torch tensors and,
as in the reference, clips every leaf. Norms are taken in float32 and
the scaled gradient keeps its dtype.
"""
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core.tensor import _wrap

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _skip(p, g):
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


def _sumsq(g):
    return torch.sum(g.float() ** 2)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else
                (p, _wrap(torch.clamp(g._data, self.min, self.max)))
                for p, g in params_grads]

    def clip_tree(self, grads):
        return tree_map(lambda g: torch.clamp(g, self.min, self.max),
                        grads)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, g):
        norm = torch.sqrt(_sumsq(g))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g * scale).to(g.dtype)

    def __call__(self, params_grads):
        return [(p, g) if _skip(p, g) else (p, _wrap(self._clip(g._data)))
                for p, g in params_grads]

    def clip_tree(self, grads):
        return tree_map(self._clip, grads)


class ClipGradByGlobalNorm(ClipGradBase):
    """One global norm over every clipped gradient; each is scaled by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _scale(self, grads):
        global_norm = torch.sqrt(sum(_sumsq(g) for g in grads))
        return self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)

    def __call__(self, params_grads):
        live = [g._data for p, g in params_grads if not _skip(p, g)]
        if not live:
            return params_grads
        scale = self._scale(live)
        return [(p, g) if _skip(p, g) else
                (p, _wrap((g._data * scale).to(g._data.dtype)))
                for p, g in params_grads]

    def clip_tree(self, grads):
        scale = self._scale(tree_leaves(grads))
        return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place so that their joint norm
    is at most max_norm; returns the norm before clipping."""
    params = [p for p in parameters if p._data.grad is not None]
    if not params:
        return _wrap(torch.zeros(()))
    grads = [p._data.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.pow(sum(torch.sum(torch.pow(g.float().abs(),
                                                  norm_type))
                              for g in grads), 1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p, g in zip(params, grads):
        p._data.grad = (g * scale).to(g.dtype)
    return _wrap(total)
