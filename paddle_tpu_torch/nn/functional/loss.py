"""Loss functionals (counterpart of `paddle_tpu/nn/functional/loss.py`).

Every loss is written out as the reference computes it; torch's loss of
the same name is not assumed to agree (smooth_l1's delta, kl_div's zero
targets, cross_entropy's weighted mean). Hard labels are int64 (ROADMAP
C.14's width map).
"""
import math

import torch

from ...core.tensor import apply_op

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "square_error_cost", "sigmoid_focal_loss", "poisson_nll_loss",
           "gaussian_nll_loss", "teacher_student_sigmoid_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """With `weight`, the mean divides by the sum of the weights of the
    labels that are not ignored."""
    def fn(logits, lab, *w):
        if use_softmax:
            logp = torch.log_softmax(logits, axis)
        else:
            logp = torch.log(torch.clamp(logits, min=1e-30))
        if soft_label:
            return _reduce(-(lab * logp).sum(dim=axis), reduction)
        li = lab.to(torch.int64)
        if li.dim() == logp.dim():               # (N, ..., 1) hard labels
            li = li.squeeze(axis)
        mask = li != ignore_index
        safe_li = torch.where(mask, li, 0)
        loss = -torch.gather(logp, axis, safe_li.unsqueeze(axis)) \
            .squeeze(axis)
        wt = w[0][safe_li] if w else None
        if wt is not None:
            loss = loss * wt
        loss = loss * mask.to(loss.dtype)
        if reduction == "mean":
            denom = wt * mask.to(loss.dtype) if wt is not None \
                else mask.to(loss.dtype)
            return loss.sum() / torch.clamp(denom.sum(), min=1e-12)
        return _reduce(loss, reduction)

    args = [input, label] if weight is None else [input, label, weight]
    return apply_op(fn, *args, name="cross_entropy")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    loss = loss.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    def fn(logp, lab, *w):
        li = lab.to(torch.int64)
        loss = -torch.gather(logp, 1, li[:, None])[:, 0]
        if w:
            loss = loss * w[0][li]
        return _reduce(loss, reduction)
    args = [input, label] if weight is None else [input, label, weight]
    return apply_op(fn, *args, name="nll_loss")


def mse_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce(torch.square(a - b), reduction),
                    input, label, name="mse_loss")


def l1_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, b: _reduce((a - b).abs(), reduction), input,
                    label, name="l1_loss")


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    """The huber kernel: 0.5 x^2 for |x| <= delta else
    delta (|x| - 0.5 delta); torch's beta convention divides the
    quadratic branch by delta and agrees only at delta = 1."""
    def fn(a, b):
        d = (a - b).abs()
        loss = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
        return _reduce(loss, reduction)
    return apply_op(fn, input, label, name="smooth_l1_loss")


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    def fn(p, y, *w):
        p = torch.clamp(p, 1e-12, 1 - 1e-12)
        loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
        if w:
            loss = loss * w[0]
        return _reduce(loss, reduction)
    args = [input, label] if weight is None else [input, label, weight]
    return apply_op(fn, *args, name="binary_cross_entropy")


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    def fn(z, y, *extra):
        w = extra[0] if weight is not None else None
        pw = extra[-1] if pos_weight is not None else None
        if pw is None:
            loss = torch.clamp(z, min=0) - z * y + \
                torch.log1p(torch.exp(-z.abs()))
        else:
            log_w = (pw - 1) * y + 1
            loss = (1 - y) * z + log_w * (torch.log1p(torch.exp(-z.abs()))
                                          + torch.clamp(-z, min=0))
        if w is not None:
            loss = loss * w
        return _reduce(loss, reduction)
    args = [logit, label] + [t for t in (weight, pos_weight) if t is not None]
    return apply_op(fn, *args, name="binary_cross_entropy_with_logits")


def kl_div(input, label, reduction="mean", name=None):
    def fn(logp, y):
        # a target <= 0 contributes exactly 0; the inner where keeps log()
        # off non-positive values so no NaN leaks through the select
        safe_y = torch.where(y > 0, y, 1.0)
        loss = torch.where(y > 0, y * (torch.log(safe_y) - logp), 0.0)
        if reduction == "batchmean":
            return loss.sum() / logp.shape[0]
        return _reduce(loss, reduction)
    return apply_op(fn, input, label, name="kl_div")


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return apply_op(lambda a, b, y: _reduce(
        torch.clamp(-y * (a - b) + margin, min=0.0), reduction),
        input, other, label, name="margin_ranking_loss")


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    def fn(a, y):
        loss = torch.where(y == 1, a, torch.clamp(margin - a, min=0.0))
        return _reduce(loss, reduction)
    return apply_op(fn, input, label, name="hinge_embedding_loss")


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    def fn(a, b, y):
        cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1)
                                 + 1e-12)
        loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
        return _reduce(loss, reduction)
    return apply_op(fn, input1, input2, label, name="cosine_embedding_loss")


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return torch.pow(torch.pow((u - v).abs(), p).sum(-1) + epsilon,
                         1 / p)

    def fn(a, pos, neg):
        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)
    return apply_op(fn, input, positive, negative,
                    name="triplet_margin_loss")


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply_op(lambda p, y: -y * torch.log(p + epsilon)
                    - (1 - y) * torch.log(1 - p + epsilon), input, label,
                    name="log_loss")


def square_error_cost(input, label):
    return apply_op(lambda a, b: torch.square(a - b), input, label,
                    name="square_error_cost")


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    def fn(z, y, *n):
        p = torch.sigmoid(z)
        ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * torch.pow(1 - p_t, gamma) * ce
        if n:
            loss = loss / n[0]
        return _reduce(loss, reduction)
    args = [logit, label] if normalizer is None \
        else [logit, label, normalizer]
    return apply_op(fn, *args, name="sigmoid_focal_loss")


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    """log_input: exp(x) - y x; else x - y log(x + eps). `full` adds the
    Stirling term for y > 1."""
    def fn(x, y):
        if log_input:
            loss = torch.exp(x) - y * x
        else:
            loss = x - y * torch.log(x + epsilon)
        if full:
            stirling = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
            loss = loss + torch.where(y > 1, stirling, 0.0)
        return _reduce(loss, reduction)
    return apply_op(fn, input, label, name="poisson_nll_loss")


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """0.5 (log var + (x - y)^2 / var), the variance clamped at epsilon."""
    def fn(x, y, var):
        var = torch.clamp(var, min=epsilon)
        loss = 0.5 * (torch.log(var) + torch.square(x - y) / var)
        if full:
            loss = loss + 0.5 * math.log(2 * math.pi)
        return _reduce(loss, reduction)
    return apply_op(fn, input, label, variance, name="gaussian_nll_loss")


class _TeacherStudentSigmoid(torch.autograd.Function):
    """The forward is not clipped; the soft_max bounds only zero the
    gradient outside them (the reference kernel's grad)."""

    @staticmethod
    def forward(ctx, x, lab, lower, upper):
        def softplus(t):
            return torch.clamp(x, min=0) - x * t + \
                torch.log1p(torch.exp(-x.abs()))
        # click term: z = 0 for label < -1 or label in [0, 1), else 1
        z = torch.where(lab < -1.0, 0.0, torch.where(
            lab < 0.0, 1.0, torch.where(lab < 1.0, 0.0, 1.0)))
        loss = softplus(z)
        # the teacher term only where z' exists (label >= 0)
        zprime = torch.where(lab < 1.0, lab, lab - 1.0)
        loss = loss + torch.where(lab >= 0.0, softplus(zprime), 0.0)
        ctx.save_for_backward(x, lab)
        ctx.bounds = (lower, upper)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        lower, upper = ctx.bounds
        sum_val = torch.clamp(x, lower, upper)
        pred = 1.0 / (1.0 + torch.exp(-sum_val))
        base = torch.where(lab < -1.0, -pred, torch.where(
            lab < 0.0, 1.0 - pred, lab - 2.0 * pred))
        base = torch.where((sum_val >= upper) | (sum_val <= lower), 0.0, base)
        return -base * g, None, None, None


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """Distillation CTR loss: the label encodes a click z and an optional
    teacher score z' (label = -2 | -1 | z' | 1 + z'); the loss is the
    click's sigmoid CE plus, where the teacher score exists, the
    teacher's."""
    lo, up = float(soft_max_lower_bound), float(soft_max_up_bound)
    return apply_op(lambda x, y: _TeacherStudentSigmoid.apply(
        x, y.to(x.dtype), lo, up), input, label,
        name="teacher_student_sigmoid_loss")
