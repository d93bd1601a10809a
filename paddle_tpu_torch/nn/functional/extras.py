"""The rest of the functional surface (counterpart of
`paddle_tpu/nn/functional/extras.py`): rrelu, channel_shuffle, the
margin and distance losses, hsigmoid, margin cross-entropy, CTC,
affine_grid / grid_sample, 3-D adaptive pools, max_unpool, gather_tree,
edit_distance and the greedy CTC decoder.

The reference writes its sequential ops (the CTC alpha recursion, the
edit-distance rows, the beam backtrace) as `lax.scan`s; here they are
Python loops over the time axis of the same recurrences.
"""
import numpy as np
import torch
import torch.nn.functional as TF

from ...core.random import generator
from ...core.tensor import apply_op
from .conv import _adaptive_even_or_uneven
from .loss import _reduce

__all__ = ["rrelu", "channel_shuffle", "zeropad2d", "diag_embed",
           "soft_margin_loss", "multi_label_soft_margin_loss", "dice_loss",
           "pairwise_distance", "triplet_margin_with_distance_loss",
           "hsigmoid_loss", "margin_cross_entropy", "ctc_loss",
           "affine_grid", "grid_sample", "adaptive_avg_pool3d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d", "gather_tree", "edit_distance",
           "ctc_greedy_decoder"]


# ------------------------------------------------------------- activations

def rrelu(x, lower=0.125, upper=0.3333333333333333, training=True,
          name=None):
    """Randomized leaky ReLU: in training the slope is U[lower, upper] per
    element (the device generator); in eval the fixed (lower+upper)/2."""
    if not training:
        slope = (lower + upper) / 2.0
        return apply_op(lambda a: torch.where(a >= 0, a, a * slope), x,
                        name="rrelu")

    def fn(a):
        slope = torch.empty(a.shape, dtype=torch.float32, device=a.device) \
            .uniform_(lower, upper, generator=generator(a.device))
        return torch.where(a >= 0, a, a * slope.to(a.dtype))
    return apply_op(fn, x, name="rrelu")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        if data_format == "NCHW":
            N, C, H, W = a.shape
            return a.reshape(N, groups, C // groups, H, W) \
                .transpose(1, 2).reshape(N, C, H, W)
        N, H, W, C = a.shape
        return a.reshape(N, H, W, groups, C // groups) \
            .transpose(3, 4).reshape(N, H, W, C)
    return apply_op(fn, x, name="channel_shuffle")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    l, r, t, b = (padding if isinstance(padding, (list, tuple))
                  else (padding,) * 4)

    def fn(a):
        if data_format == "NCHW":
            return TF.pad(a, [l, r, t, b])
        return TF.pad(a, [0, 0, l, r, t, b])
    return apply_op(fn, x, name="zeropad2d")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    def fn(a):
        k = a.shape[-1]
        size = k + abs(offset)
        i0, j0 = (0, offset) if offset >= 0 else (-offset, 0)
        ar = torch.arange(k, device=a.device)
        out = torch.zeros(tuple(a.shape[:-1]) + (size, size), dtype=a.dtype,
                          device=a.device)
        out[..., i0 + ar, j0 + ar] = a          # a fresh tensor: no alias
        nd = out.dim()
        return torch.movedim(out, (nd - 2, nd - 1), (dim1 % nd, dim2 % nd))
    return apply_op(fn, input, name="diag_embed")


# ------------------------------------------------------------------ losses

def soft_margin_loss(input, label, reduction="mean", name=None):
    return apply_op(lambda a, y: _reduce(TF.softplus(-y.to(a.dtype) * a),
                                         reduction), input, label,
                    name="soft_margin_loss")


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    def fn(a, y, *w):
        y = y.to(a.dtype)
        per = y * TF.logsigmoid(a) + (1 - y) * TF.logsigmoid(-a)
        if w:
            per = per * w[0]
        return _reduce(-per.mean(dim=-1), reduction)
    args = (input, label) if weight is None else (input, label, weight)
    return apply_op(fn, *args, name="multi_label_soft_margin_loss")


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input: (..., C) probabilities; label: (..., 1) int."""
    def fn(p, y):
        C = p.shape[-1]
        oh = TF.one_hot(y[..., 0].to(torch.int64), C).to(p.dtype)
        red = tuple(range(1, p.dim()))
        inter = (p * oh).sum(dim=red)
        union = p.sum(dim=red) + oh.sum(dim=red)
        return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()
    return apply_op(fn, input, label, name="dice_loss")


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return apply_op(lambda a, b: torch.linalg.vector_norm(
        a - b + epsilon, ord=p, dim=-1, keepdim=keepdim), x, y,
        name="pairwise_distance")


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or pairwise_distance
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = apply_op(torch.minimum, d_neg, dist(positive, negative),
                         name="minimum")
    return apply_op(lambda dp, dn: _reduce(
        torch.clamp(dp - dn + margin, min=0.0), reduction), d_pos, d_neg,
        name="triplet_margin_with_distance_loss")


def _hsigmoid_tables(C):
    """(C, depth) internal-node rows, signs and valid flags of the default
    complete binary tree: class c's path is the heap route from node
    c + C up to the root."""
    depth = int(np.ceil(np.log2(max(C, 2))))
    nodes = np.zeros((C, depth), np.int64)
    signs = np.zeros((C, depth), np.float32)
    valid = np.zeros((C, depth), np.float32)
    for c in range(C):
        node, d = c + C, 0
        while node > 1 and d < depth:
            parent = node // 2
            nodes[c, d] = parent - 1
            signs[c, d] = 1.0 if node % 2 == 0 else -1.0     # left = +1
            valid[c, d] = 1.0
            node, d = parent, d + 1
    return nodes, signs, valid


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss: custom path_table/path_code trees are not "
            "supported; only the default complete binary tree")
    tables = _hsigmoid_tables(int(num_classes))

    def fn(x, lab, w, *b):
        nodes, signs, valid = (torch.as_tensor(t, device=x.device)
                               for t in tables)
        lab = lab.reshape(-1).to(torch.int64)
        nd, sg, vl = nodes[lab], signs[lab], valid[lab]
        logits = torch.einsum("bd,bkd->bk", x.float(), w[nd].float())
        if b:
            logits = logits + b[0][nd]
        per = -TF.logsigmoid(sg * logits) * vl
        return per.sum(dim=-1).mean()
    args = [input, label, weight] + ([bias] if bias is not None else [])
    return apply_op(fn, *args, name="hsigmoid_loss")


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """ArcFace-style margin softmax: the target logit cos(theta) becomes
    cos(m1 theta + m2) - m3, everything scaled."""
    def fn(z, y):
        y = y.reshape(-1).to(torch.int64)
        zc = torch.clamp(z.float(), -1.0, 1.0)
        marged = torch.cos(margin1 * torch.arccos(zc) + margin2) - margin3
        oh = TF.one_hot(y, z.shape[-1]).to(torch.float32)
        logp = torch.log_softmax(torch.where(oh > 0, marged, zc) * scale, -1)
        loss = _reduce(-torch.gather(logp, -1, y[:, None])[:, 0], reduction)
        if return_softmax:
            return loss, torch.exp(logp)
        return loss
    return apply_op(fn, logits, label, name="margin_cross_entropy")


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC loss: the alpha recursion of Graves et al. in the log semiring,
    batched over the (B, 2L+1) lattice, one step a time step; autograd
    gives the CTC gradient. log_probs (T, B, C) are logits (softmax is
    applied here, as paddle's warpctc does); labels (B, L) padded past
    label_lengths. "mean" divides each loss by its label length, then
    averages, as warpctc's does."""
    NEG = -1e30

    def fn(lp, lab, in_len, lab_len):
        T, B, C = lp.shape
        dev = lp.device
        lp = torch.log_softmax(lp.float(), -1)
        L = lab.shape[1]
        S = 2 * L + 1
        ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
        ext[:, 1::2] = lab.to(torch.int64)
        pos = torch.arange(S, device=dev)[None, :]
        lab_len = lab_len.reshape(-1).to(torch.int64)
        in_len = in_len.reshape(-1).to(torch.int64)
        S_b = 2 * lab_len + 1
        live = pos < S_b[:, None]
        prev2 = torch.cat([torch.full((B, 2), blank, dtype=torch.int64,
                                      device=dev), ext[:, :-2]], dim=1)
        can_skip = (pos % 2 == 1) & (ext != prev2) & (pos >= 2)
        neg = torch.tensor(NEG, device=dev)

        def shift(a, k):
            return torch.cat([torch.full((B, k), NEG, device=dev),
                              a[:, :-k]], dim=1)

        def emit(t_lp, a):
            a1 = shift(a, 1)
            a2 = torch.where(can_skip, shift(a, 2), neg)
            m = torch.maximum(torch.maximum(a, a1), a2)
            dead = m <= NEG / 2
            m_safe = torch.where(dead, 0.0, m)
            tot = m_safe + torch.log(
                torch.exp(torch.where(dead, neg, a - m_safe))
                + torch.exp(torch.where(dead, neg, a1 - m_safe))
                + torch.exp(torch.where(dead, neg, a2 - m_safe)))
            tot = torch.where(dead, neg, tot)
            return torch.where(live, tot + torch.gather(t_lp, 1, ext), neg)

        def final(a):
            lastb = torch.gather(a, 1, (S_b - 1)[:, None])[:, 0]
            lastl = torch.gather(a, 1, torch.clamp(S_b - 2, min=0)[:, None]
                                 )[:, 0]
            return torch.logaddexp(lastb, torch.where(lab_len > 0, lastl,
                                                      neg))

        first_lab = torch.gather(lp[0], 1, ext[:, 1:2])[:, 0]
        a = torch.where(pos == 0, lp[0, :, blank][:, None],
                        torch.where((pos == 1) & (lab_len > 0)[:, None],
                                    first_lab[:, None], neg))
        a = torch.where(live, a, neg)
        finals = torch.where(in_len == 1, final(a), neg)
        for t in range(1, T):
            a = torch.where((t < in_len)[:, None], emit(lp[t], a), a)
            finals = torch.where(in_len - 1 == t, final(a), finals)
        nll = -finals
        if reduction == "mean":
            return (nll / torch.clamp(lab_len, min=1)).mean()
        if reduction == "sum":
            return nll.sum()
        return nll
    return apply_op(fn, log_probs, labels, input_lengths, label_lengths,
                    name="ctc_loss")


# ------------------------------------------------------------ vision ops

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta (N, 2, 3) -> sampling grid (N, H, W, 2)."""
    N, C, H, W = [int(s) for s in out_shape]

    def coords(n, dev):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=dev)
        step = 2.0 / n
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, n, device=dev)

    def fn(th):
        gy, gx = torch.meshgrid(coords(H, th.device), coords(W, th.device),
                                indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
        return torch.einsum("hwk,nck->nhwc", base.to(th.dtype), th)
    return apply_op(fn, theta, name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x (N, C, H, W); grid (N, Hg, Wg, 2) in [-1, 1]; gather-based
    bilinear / nearest sampling with zeros, border or reflection
    padding."""
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample: unknown padding_mode "
                         f"{padding_mode!r}")

    def fn(a, g):
        N, C, H, W = a.shape
        gx, gy = g[..., 0].float(), g[..., 1].float()
        if align_corners:
            fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
        else:
            fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2

        if padding_mode == "reflection":
            def reflect_f(f, n):
                if align_corners:
                    if n == 1:
                        return torch.zeros_like(f)
                    period = 2.0 * (n - 1)
                    f = torch.remainder(f.abs(), period)
                    return torch.where(f > n - 1, period - f, f)
                period = 2.0 * n
                t = torch.remainder((f + 0.5).abs(), period)
                t = torch.where(t > n, period - t, t)
                return torch.clamp(t - 0.5, 0.0, n - 1.0)
            fx, fy = reflect_f(fx, W), reflect_f(fy, H)

        n_idx = torch.arange(N, device=a.device)[:, None, None]

        def sample(ix, iy):
            inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = a[n_idx, :, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
            if padding_mode != "zeros":
                return v                        # (N, Hg, Wg, C)
            return torch.where(inb[..., None], v, 0.0)

        if mode == "nearest":
            out = sample(torch.round(fx).to(torch.int64),
                         torch.round(fy).to(torch.int64))
        else:
            x0 = torch.floor(fx).to(torch.int64)
            y0 = torch.floor(fy).to(torch.int64)
            x1, y1 = x0 + 1, y0 + 1
            wx, wy = fx - x0, fy - y0
            out = (sample(x0, y0) * ((1 - wx) * (1 - wy))[..., None]
                   + sample(x1, y0) * (wx * (1 - wy))[..., None]
                   + sample(x0, y1) * ((1 - wx) * wy)[..., None]
                   + sample(x1, y1) * (wx * wy)[..., None])
        return torch.movedim(out, -1, 1).to(a.dtype)     # (N, C, Hg, Wg)
    return apply_op(fn, x, grid, name="grid_sample")


# -------------------------------------------------- pooling: 3d + unpool

def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool3d(x, output_size, "avg")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError(
            "adaptive_max_pool3d: return_mask is not supported")
    return _adaptive_pool3d(x, output_size, "max")


def _adaptive_pool3d(x, output_size, mode):
    if isinstance(output_size, int):
        output_size = (output_size,) * 3
    out = tuple(int(s) for s in output_size)
    return apply_op(lambda a: _adaptive_even_or_uneven(a, out, mode), x,
                    name=f"adaptive_{mode}_pool3d")


def _max_unpool(x, indices, out_sp, spatial):
    def fn(a, idx):
        lead = tuple(a.shape[:-spatial])
        flat_in = int(np.prod(a.shape[-spatial:]))
        af = a.reshape(-1, flat_in)
        idxf = idx.reshape(-1, flat_in).to(torch.int64)
        out = torch.zeros((af.shape[0], int(np.prod(out_sp))), dtype=a.dtype,
                          device=a.device)
        return out.scatter(1, idxf, af).reshape(lead + tuple(out_sp))
    return apply_op(fn, x, indices, name=f"max_unpool{spatial}d")


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    stride = stride or kernel_size
    L = x.shape[-1]
    out_l = output_size[-1] if output_size else \
        (L - 1) * stride + kernel_size - 2 * padding
    return _max_unpool(x, indices, (int(out_l),), 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size, kernel_size)
    stride = stride or kernel_size
    if isinstance(stride, int):
        stride = (stride, stride)
    if output_size:
        out_hw = tuple(int(s) for s in output_size[-2:])
    else:
        H, W = x.shape[-2], x.shape[-1]
        out_hw = ((H - 1) * stride[0] + kernel_size[0] - 2 * padding,
                  (W - 1) * stride[1] + kernel_size[1] - 2 * padding)
    return _max_unpool(x, indices, out_hw, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    stride = stride or kernel_size
    if isinstance(stride, int):
        stride = (stride,) * 3
    if output_size:
        out_sp = tuple(int(s) for s in output_size[-3:])
    else:
        out_sp = tuple((s - 1) * st + k - 2 * padding
                       for s, st, k in zip(x.shape[-3:], stride,
                                           kernel_size))
    return _max_unpool(x, indices, out_sp, 3)


# ------------------------------------------------------- sequence utilities

def gather_tree(ids, parents):
    """Beam-search backtrace: follow parent pointers from the last step.
    ids / parents: (T, B, beam)."""
    def fn(ids_, par):
        T = ids_.shape[0]
        beam = torch.arange(ids_.shape[2], device=ids_.device) \
            .expand(ids_.shape[1:]).to(torch.int64)
        outs = [None] * T
        for t in range(T - 1, -1, -1):
            outs[t] = torch.gather(ids_[t], -1, beam)
            beam = torch.gather(par[t].to(torch.int64), -1, beam)
        return torch.stack(outs)
    return apply_op(fn, ids, parents, name="gather_tree")


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None, name=None):
    """Levenshtein distance, batched: one DP row a hypothesis token, the
    in-row dependency as a running minimum. Returns ((B, 1) f32 distance,
    (B, 1) reference lengths)."""
    def fn(hyp, ref, *lens):
        B, L1 = hyp.shape
        L2 = ref.shape[1]
        dev = hyp.device
        h_len = lens[0].reshape(-1).to(torch.int64) if lens \
            else torch.full((B,), L1, dtype=torch.int64, device=dev)
        r_len = lens[1].reshape(-1).to(torch.int64) if len(lens) > 1 \
            else torch.full((B,), L2, dtype=torch.int64, device=dev)
        cols = torch.arange(L2 + 1, device=dev)
        prev = cols.expand(B, L2 + 1).clone()
        for i in range(L1):
            sub = (hyp[:, i][:, None] != ref).to(torch.int64)
            base = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + sub)
            first = torch.full((B, 1), i + 1, dtype=torch.int64, device=dev)
            seed = torch.cat([first, base], dim=1)
            cur = torch.cummin(seed - cols[None, :], dim=1).values \
                + cols[None, :]
            prev = torch.where((i < h_len)[:, None], cur, prev)
        dist = torch.gather(prev, 1, r_len[:, None])[:, 0].float()
        if normalized:
            dist = dist / torch.clamp(r_len.float(), min=1.0)
        return dist.reshape(B, 1), r_len.reshape(B, 1)
    args = [input, label]
    if input_length is not None:
        args += [input_length, label_length]
    return apply_op(fn, *args, name="edit_distance")


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decode: argmax per step, merge repeats, drop blanks.
    input (B, T, V); returns (decoded (B, T) padded with padding_value,
    lengths (B, 1))."""
    def fn(x, *rest):
        B, T, _ = x.shape
        dev = x.device
        ids = x.argmax(dim=-1)
        lens = rest[0].reshape(B).to(torch.int64) if rest \
            else torch.full((B,), T, dtype=torch.int64, device=dev)
        prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                     device=dev), ids[:, :-1]], dim=1)
        live = torch.arange(T, device=dev)[None] < lens[:, None]
        keep = (ids != blank) & (ids != prev) & live
        out_len = keep.sum(dim=1)
        order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
        gathered = torch.gather(ids, 1, order)
        pos_live = torch.arange(T, device=dev)[None] < out_len[:, None]
        decoded = torch.where(pos_live, gathered, padding_value)
        return decoded, out_len[:, None]
    args = [input] if input_length is None else [input, input_length]
    return apply_op(fn, *args, name="ctc_greedy_decoder")
