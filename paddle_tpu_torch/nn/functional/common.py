"""Common functionals: linear, dropout, embedding, pad, interpolate, ...
(counterpart of `paddle_tpu/nn/functional/common.py`).

Random draws (dropout, alpha_dropout, class_center_sample) come from the
generator of the device the input lies on (`core.random.generator`);
they are held by their contract, not bit for bit against `jax.random`.
"""
import numpy as np
import torch
import torch.nn.functional as TF

from ...core import dtype as _dt
from ...core.random import generator
from ...core.tensor import Tensor, _wrap, apply_op

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "interpolate",
           "upsample", "pixel_shuffle", "pixel_unshuffle",
           "cosine_similarity", "bilinear", "unfold", "fold",
           "sequence_mask", "temporal_shift", "npair_loss",
           "class_center_sample"]


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), with paddle's weight layout (in_features,
    out_features)."""
    xs, ws = tuple(x.shape), tuple(weight.shape)
    if len(ws) != 2:
        raise ValueError(
            f"(InvalidArgument) linear: weight must be 2-D "
            f"(in_features, out_features), but received weight.shape={ws}.")
    if not xs or xs[-1] != ws[0]:
        raise ValueError(
            f"(InvalidArgument) linear: input's last dimension must equal "
            f"weight's in_features ({ws[0]}), but received x.shape={xs} "
            f"and weight.shape={ws}.")
    if bias is None:
        return apply_op(torch.matmul, x, weight, name="linear")
    return apply_op(lambda a, w, b: torch.matmul(a, w) + b, x, weight, bias,
                    name="linear")


def _keep_mask(shape, p, device):
    """Bernoulli(1 - p) keep mask from the device's generator."""
    u = torch.rand(shape, dtype=torch.float32, device=device,
                   generator=generator(device))
    return u < (1.0 - p)


def _as_tensor(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not 0 <= float(p) <= 1:
        raise ValueError(
            f"p argument should be a number in [0, 1], but got {p!r}")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(
            f"mode argument should be 'downscale_in_infer' or "
            f"'upscale_in_train', but got {mode!r}")
    if not training:
        if mode == "downscale_in_infer" and p != 0:
            # infer-time out = x * (1 - p) in this mode (train applies the
            # raw mask unscaled)
            return apply_op(lambda a: (a * (1.0 - p)).to(a.dtype), x,
                            name="dropout")
        return _as_tensor(x)
    if p == 0:
        return _as_tensor(x)

    def fn(a):
        shape = list(a.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = _keep_mask(tuple(shape), p, a.device)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
        return torch.where(keep, a, 0.0).to(a.dtype)
    return apply_op(fn, x, name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale

    def fn(a):
        keep = _keep_mask(tuple(a.shape), p, a.device)
        q = 1.0 - p
        a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
        b_coef = -a_coef * alpha_p * p
        return a_coef * torch.where(keep, a, alpha_p) + b_coef
    return apply_op(fn, x, name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    if len(tuple(weight.shape)) != 2:
        raise ValueError(
            f"(InvalidArgument) embedding: weight must be 2-D "
            f"(vocab_size, embedding_dim), but received "
            f"weight.shape={tuple(weight.shape)}.")

    def fn(ids, w):
        ids = ids.to(torch.int64)
        out = w[ids]
        if padding_idx is not None:
            pad = (ids == padding_idx)[..., None]
            out = torch.where(pad, out.detach(), out)
        return out
    return apply_op(fn, x, weight, name="embedding")


def one_hot(x, num_classes, name=None):
    return apply_op(lambda a: TF.one_hot(a.to(torch.int64), num_classes)
                    .to(torch.float32), x, name="one_hot")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def fn(y, *pd):
        k = y.shape[-1]
        smooth = pd[0] if pd else torch.full((k,), 1.0 / k, dtype=y.dtype,
                                             device=y.device)
        return (1 - epsilon) * y + epsilon * smooth
    args = (label,) if prior_dist is None else (label, prior_dist)
    return apply_op(fn, *args, name="label_smooth")


def _pad_pairs(p, ndim, data_format):
    """Paddle pad spec -> per-dim (lo, hi) pairs, outermost first."""
    p = [int(v) for v in p]
    if len(p) == 2 * ndim:
        return [(p[2 * i], p[2 * i + 1]) for i in range(ndim)]
    # a spatial spec is ordered innermost-first: [Wl, Wr, Ht, Hb, ...]
    spatial = len(p) // 2
    sp_pairs = [(p[2 * i], p[2 * i + 1]) for i in range(spatial)][::-1]
    if data_format.startswith("NC"):
        return [(0, 0), (0, 0)] + sp_pairs
    return [(0, 0)] + sp_pairs + [(0, 0)]


def _np_pad(a, pairs, mode, value=0.0):
    """numpy.pad's modes on a torch tensor (constant, reflect, edge,
    wrap), one axis at a time so any rank works."""
    if mode == "constant":
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        return TF.pad(a, flat, value=value)
    for ax, (lo, hi) in enumerate(pairs):
        if lo == 0 and hi == 0:
            continue
        n = a.shape[ax]
        if mode == "reflect":
            idx = np.concatenate([np.arange(lo, 0, -1), np.arange(n),
                                  np.arange(n - 2, n - 2 - hi, -1)])
        elif mode == "edge":
            idx = np.clip(np.arange(-lo, n + hi), 0, n - 1)
        else:                                               # wrap
            idx = np.arange(-lo, n + hi) % n
        a = a.index_select(ax, torch.as_tensor(idx, device=a.device))
    return a


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    def fn(a):
        pairs = _pad_pairs(pad, a.dim(), data_format)
        nmode = {"constant": "constant", "reflect": "reflect",
                 "replicate": "edge", "circular": "wrap"}[mode]
        return _np_pad(a, pairs, nmode, value)
    return apply_op(fn, x, name="pad")


def _interp_ratio(in_s, out_s, align_corners):
    """(in-1)/(out-1) when align_corners else in/out; 0 when out == 1."""
    if out_s <= 1:
        return 0.0
    return (in_s - 1) / (out_s - 1) if align_corners else in_s / out_s


def _axis_shape(a, ax, n):
    s = [1] * a.dim()
    s[ax] = n
    return s


def _interp_axis_linear(a, ax, out_s, align_corners, align_mode):
    """Separable linear interpolation along one axis: half-pixel source
    coordinates when align_mode == 0 and not align_corners, asymmetric
    otherwise."""
    in_s = a.shape[ax]
    ratio = _interp_ratio(in_s, out_s, align_corners)
    i = torch.arange(out_s, dtype=torch.float32, device=a.device)
    if align_mode == 0 and not align_corners:
        src = ratio * (i + 0.5) - 0.5
    else:
        src = ratio * i
    src = torch.clamp(src, min=0.0)
    lo = torch.clamp(torch.floor(src).to(torch.int64), 0, in_s - 1)
    hi = torch.clamp(lo + 1, max=in_s - 1)
    w = (src - lo).to(a.dtype).reshape(_axis_shape(a, ax, out_s))
    return a.index_select(ax, lo) * (1 - w) + a.index_select(ax, hi) * w


def _interp_axis_cubic(a, ax, out_s, align_corners):
    """Separable bicubic with the Keys kernel at A = -0.75; half-pixel
    source coordinates unless align_corners."""
    in_s = a.shape[ax]
    ratio = _interp_ratio(in_s, out_s, align_corners)
    i = torch.arange(out_s, dtype=torch.float32, device=a.device)
    src = ratio * i if align_corners else ratio * (i + 0.5) - 0.5
    base = torch.floor(src).to(torch.int64)
    t = src - base
    A = -0.75

    def w_near(v):           # |v| <= 1
        return (A + 2) * v ** 3 - (A + 3) * v ** 2 + 1

    def w_far(v):            # 1 < |v| < 2
        return A * v ** 3 - 5 * A * v ** 2 + 8 * A * v - 4 * A

    weights = [w_far(t + 1), w_near(t), w_near(1 - t), w_far(2 - t)]
    out = 0
    for k, w in enumerate(weights):
        idx = torch.clamp(base - 1 + k, 0, in_s - 1)
        out = out + a.index_select(ax, idx) * \
            w.to(a.dtype).reshape(_axis_shape(a, ax, out_s))
    return out


def _interp_axis_nearest(a, ax, out_s, align_corners):
    """int(ratio * i + 0.5) when align_corners else int(ratio * i)."""
    in_s = a.shape[ax]
    ratio = _interp_ratio(in_s, out_s, align_corners)
    i = torch.arange(out_s, dtype=torch.float32, device=a.device)
    src = ratio * i + (0.5 if align_corners else 0.0)
    idx = torch.clamp(src.to(torch.int64), 0, in_s - 1)
    return a.index_select(ax, idx)


_INTERP_MODE_RANKS = {
    "linear": (1,), "bilinear": (2,), "bicubic": (2,),
    "trilinear": (3,), "nearest": (2, 3), "area": (1, 2, 3),
}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    cf = data_format.startswith("NC")
    nd = len(tuple(x.shape)) - 2
    spatial_in = tuple(x.shape)[2:] if cf else tuple(x.shape)[1:-1]
    if size is None and scale_factor is None:
        raise ValueError(
            "(InvalidArgument) interpolate: one of size or scale_factor "
            "must be set.")
    allowed = _INTERP_MODE_RANKS.get(mode)
    if allowed is not None and nd not in allowed:
        raise ValueError(
            f"(InvalidArgument) interpolate: mode '{mode}' expects a "
            f"{'/'.join(str(r + 2) + '-D' for r in allowed)} input, got "
            f"{nd + 2}-D.")
    if size is not None:
        sz = size if isinstance(size, (list, tuple)) else [size] * nd
        out_sp = tuple(int(s) for s in sz)
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        out_sp = tuple(int(s * f) for s, f in zip(spatial_in, sf))
    if len(out_sp) != nd:
        raise ValueError(
            f"(InvalidArgument) interpolate: size/scale_factor must give "
            f"{nd} spatial sizes, got {out_sp}.")

    if mode == "area":
        # area interpolation is adaptive average pooling
        from . import extras as _ex
        from .conv import adaptive_avg_pool1d, adaptive_avg_pool2d
        xin = x if cf else paddle_transpose_to_cf(x, nd)
        if nd == 1:
            out = adaptive_avg_pool1d(xin, out_sp[0])
        elif nd == 2:
            out = adaptive_avg_pool2d(xin, list(out_sp))
        else:
            out = _ex.adaptive_avg_pool3d(xin, list(out_sp))
        return out if cf else paddle_transpose_to_cl(out, nd)

    def fn(a):
        spatial_axes = tuple(range(2, a.dim())) if cf \
            else tuple(range(1, a.dim() - 1))
        for ax, o in zip(spatial_axes, out_sp):
            if mode == "nearest":
                a = _interp_axis_nearest(a, ax, o, align_corners)
            elif mode in ("linear", "bilinear", "trilinear"):
                a = _interp_axis_linear(a, ax, o, align_corners, align_mode)
            elif mode == "bicubic":
                a = _interp_axis_cubic(a, ax, o, align_corners)
            else:
                raise ValueError(f"(InvalidArgument) interpolate: unknown "
                                 f"mode {mode!r}")
        return a
    return apply_op(fn, x, name="interpolate")


def paddle_transpose_to_cf(x, nd):
    """N...C -> NC... for the channels-first pooling helpers."""
    perm = [0, nd + 1] + list(range(1, nd + 1))
    return apply_op(lambda a: a.permute(perm), x, name="transpose")


def paddle_transpose_to_cl(x, nd):
    """NC... -> N...C."""
    perm = [0] + list(range(2, nd + 2)) + [1]
    return apply_op(lambda a: a.permute(perm), x, name="transpose")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(a):
        if data_format == "NCHW":
            N, C, H, W = a.shape
            out = a.reshape(N, C // (r * r), r, r, H, W)
            out = out.permute(0, 1, 4, 2, 5, 3)
            return out.reshape(N, C // (r * r), H * r, W * r)
        N, H, W, C = a.shape
        out = a.reshape(N, H, W, r, r, C // (r * r))
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(N, H * r, W * r, C // (r * r))
    return apply_op(fn, x, name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def fn(a):
        if data_format == "NCHW":
            N, C, H, W = a.shape
            out = a.reshape(N, C, H // r, r, W // r, r)
            out = out.permute(0, 1, 3, 5, 2, 4)
            return out.reshape(N, C * r * r, H // r, W // r)
        N, H, W, C = a.shape
        out = a.reshape(N, H // r, r, W // r, r, C)
        out = out.permute(0, 1, 3, 2, 4, 5)
        return out.reshape(N, H // r, W // r, C * r * r)
    return apply_op(fn, x, name="pixel_unshuffle")


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.linalg.vector_norm(a, dim=axis)
        nb = torch.linalg.vector_norm(b, dim=axis)
        return dot / torch.clamp(na * nb, min=eps)
    return apply_op(fn, x1, x2, name="cosine_similarity")


def bilinear(x1, x2, weight, bias=None, name=None):
    def fn(a, b, w, *bi):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        if bi:
            out = out + bi[0]
        return out
    args = (x1, x2, weight) if bias is None else (x1, x2, weight, bias)
    return apply_op(fn, *args, name="bilinear")


def _unfold_paddings(paddings):
    """int -> all four; [h, w] -> [h, w, h, w]; [top, left, bottom,
    right]. Returns ((top, bottom), (left, right))."""
    if isinstance(paddings, int):
        pd = [paddings] * 4
    else:
        pd = list(paddings)
        if len(pd) == 2:
            pd = pd * 2
        elif len(pd) != 4:
            raise ValueError(
                "paddings should either be an integer or a list of 2 or 4 "
                "integers")
    return (int(pd[0]), int(pd[2])), (int(pd[1]), int(pd[3]))


def _unfold_geometry(kernel_sizes, strides, dilations):
    from .conv import _pair
    ks, st, dl = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    if any(s <= 0 for s in st) or any(d <= 0 for d in dl):
        raise ValueError(
            f"(InvalidArgument) unfold/fold: strides and dilations must be "
            f"positive, got strides={st} dilations={dl}.")
    return ks, st, dl


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    ks, st, dl = _unfold_geometry(kernel_sizes, strides, dilations)
    (pt, pb), (pl, pr) = _unfold_paddings(paddings)

    def fn(a):
        N, C, H, W = a.shape
        a_p = TF.pad(a, [pl, pr, pt, pb])
        oh = (H + pt + pb - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
        ow = (W + pl + pr - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
        cols = []
        for i in range(ks[0]):
            for j in range(ks[1]):
                cols.append(a_p[:, :, i * dl[0]:i * dl[0] + oh * st[0]:st[0],
                                j * dl[1]:j * dl[1] + ow * st[1]:st[1]])
        out = torch.stack(cols, dim=2)          # N, C, k*k, oh, ow
        return out.reshape(N, C * ks[0] * ks[1], oh * ow)
    return apply_op(fn, x, name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of unfold: overlapping patches add back into
    the image. x: (N, C*kh*kw, L) with L = Lh*Lw sliding positions."""
    from .conv import _pair
    os_ = _pair(output_sizes)
    ks, st, dl = _unfold_geometry(kernel_sizes, strides, dilations)
    (pt, pb), (pl, pr) = _unfold_paddings(paddings)

    def fn(a):
        N, ckk, L = a.shape
        if ckk % (ks[0] * ks[1]):
            raise ValueError(
                f"(InvalidArgument) fold: input channel dim {ckk} must be "
                f"divisible by kernel area {ks[0]}*{ks[1]}.")
        C = ckk // (ks[0] * ks[1])
        lh = (os_[0] + pt + pb - dl[0] * (ks[0] - 1) - 1) // st[0] + 1
        lw = (os_[1] + pl + pr - dl[1] * (ks[1] - 1) - 1) // st[1] + 1
        if lh * lw != L:
            raise ValueError(
                f"(InvalidArgument) fold: input holds {L} sliding positions "
                f"but output_sizes/kernel/stride/padding/dilation imply "
                f"{lh}*{lw}={lh * lw}.")
        cols = a.reshape(N, C, ks[0], ks[1], lh, lw)
        out = torch.zeros((N, C, os_[0] + pt + pb, os_[1] + pl + pr),
                          dtype=a.dtype, device=a.device)
        for i in range(ks[0]):
            for j in range(ks[1]):
                sl = (slice(None), slice(None),
                      slice(i * dl[0], i * dl[0] + lh * st[0], st[0]),
                      slice(j * dl[1], j * dl[1] + lw * st[1], st[1]))
                out = out.index_put(_grid_index(out, sl),
                                    cols[:, :, i, j], accumulate=True)
        return out[:, :, pt:pt + os_[0], pl:pl + os_[1]]
    return apply_op(fn, x, name="fold")


def _grid_index(t, sl):
    """Advanced-index tuple equal to the basic slice `sl` of t (so an
    out-of-place accumulate can target it)."""
    idx = [torch.arange(t.shape[d], device=t.device)[s]
           for d, s in enumerate(sl)]
    return torch.meshgrid(*idx, indexing="ij")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    d = _dt.convert_dtype(dtype)

    def fn(lens):
        m = maxlen if maxlen is not None else int(lens.max())
        ar = torch.arange(m, device=lens.device)
        return (ar[None, :] < lens[:, None]).to(d)
    return apply_op(fn, x, name="sequence_mask")


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def fn(a):
        NT, C, H, W = a.shape
        N = NT // seg_num
        v = a.reshape(N, seg_num, C, H, W)
        fold_c = int(C * shift_ratio)
        left = torch.cat([v[:, 1:, :fold_c],
                          torch.zeros_like(v[:, :1, :fold_c])], dim=1)
        right = torch.cat([torch.zeros_like(v[:, :1, fold_c:2 * fold_c]),
                           v[:, :-1, fold_c:2 * fold_c]], dim=1)
        rest = v[:, :, 2 * fold_c:]
        return torch.cat([left, right, rest], dim=2).reshape(NT, C, H, W)
    return apply_op(fn, x, name="temporal_shift")


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Soft-label CE over the anchor x positive similarity matrix plus
    0.25 * l2_reg of the embedding norms; the per-anchor CE is weighted by
    the soft labels column-wise and averaged, as in the reference."""
    def fn(a, pos, lab):
        beta = 0.25
        n = lab.shape[0]
        labf = lab.reshape(n, 1).to(torch.float32)
        eq = (labf == labf.T).to(torch.float32)
        soft = eq / eq.sum(dim=1, keepdim=True)
        l2loss = ((a * a).sum(1).mean() + (pos * pos).sum(1).mean()) \
            * beta * l2_reg
        sim = a @ pos.T
        lse = torch.logsumexp(sim, dim=1, keepdim=True)
        ce_rows = (soft * (lse - sim)).sum(dim=1)
        ce = (soft * ce_rows[:, None]).sum(dim=0).mean()
        return l2loss + ce
    return apply_op(fn, anchor, positive, labels, name="npair_loss")


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-center sampling: keep every positive class center,
    sample negatives uniformly up to num_samples, and remap the labels
    into the sorted sampled list. The output size depends on the data, so
    it is computed on the host; the negatives' host RNG is seeded from the
    CPU generator (contract-held: same seed, same sample)."""
    if not (group is None or group is False):
        raise NotImplementedError(
            "class_center_sample: process groups are not supported; "
            "gather labels across ranks first (reference docstring recipe)")
    dev = label._data.device
    lab = label.numpy().reshape(-1).astype(np.int64)
    if lab.size and (lab.min() < 0 or lab.max() >= num_classes):
        raise ValueError(
            f"(InvalidArgument) class_center_sample: labels must lie in "
            f"[0, {num_classes}), got min {lab.min()} max {lab.max()}.")
    pos = np.unique(lab)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes, dtype=np.int64), pos,
                                assume_unique=True)
        k = min(num_samples - len(pos), len(neg_pool))
        seed_bits = int(torch.randint(
            0, np.iinfo(np.int32).max, (), generator=generator(
                torch.device("cpu"))))
        rng = np.random.default_rng(seed_bits)
        negs = rng.choice(neg_pool, size=k, replace=False)
        sampled = np.sort(np.concatenate([pos, negs]))
    remapped = np.searchsorted(sampled, lab)
    return (_wrap(torch.as_tensor(remapped, device=dev)),
            _wrap(torch.as_tensor(sampled, device=dev)))
