"""Convolution and pooling functionals (counterpart of
`paddle_tpu/nn/functional/conv.py`), in plain torch: the reference
computes them with `lax.conv_general_dilated` and `reduce_window`, not in
Pallas.

Paddle's padding forms (an int, per-dim ints, (lo, hi) pairs, the
full-rank pair form, 'SAME' / 'VALID') are normalised to (lo, hi) pairs
and applied as an explicit pad, since torch's convs and pools take only
symmetric padding. Pooling follows the reference's rules where torch's
differ: `ceil_mode` has no drop-last-window rule, max pooling never
yields -inf (windows with no finite value give the dtype's minimum), and
`exclusive` average pooling divides by the window's overlap with the
input.
"""
import itertools

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.tensor import apply_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
           "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_max_pool1d", "adaptive_max_pool2d"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_padding(padding, spatial, kernel, stride, dilation,
                  channels_first=True):
    """Paddle padding spec -> 'SAME' / 'VALID' or a list of (lo, hi)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * spatial
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        # the full-rank pair form carries pairs for the batch and channel
        # dims too, which must be zero; checked before the flat form
        # because a 2-spatial 4-pair spec has length 4 too
        pairs = [tuple(int(v) for v in p) for p in padding]
        if len(pairs) == spatial + 2:
            if channels_first:
                nonspatial, pairs = pairs[:2], pairs[2:]
            else:
                nonspatial, pairs = [pairs[0], pairs[-1]], pairs[1:-1]
            if any(v != 0 for pr in nonspatial for v in pr):
                raise ValueError(
                    "(InvalidArgument) conv padding: non-zero padding on "
                    f"batch/channel dims is not supported, got {padding}")
        elif len(pairs) != spatial:
            raise ValueError(
                f"(InvalidArgument) conv padding pair spec must have "
                f"{spatial} or {spatial + 2} pairs, got {len(pairs)}")
        return pairs
    if len(padding) == spatial and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * spatial:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(spatial)]
    return [(int(p), int(p)) for p in padding]


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's 'SAME': total = max((ceil(n/s) - 1) s + (k-1) d + 1 - n, 0),
    the odd element on the high side."""
    pads = []
    for n, k, s, d in zip(sizes, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _resolve(pad, sizes, kernel, stride, dilation):
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        return _same_pads(sizes, kernel, stride, dilation)
    return pad


def _flat(pairs):
    """(lo, hi) pairs, outermost first -> torch's F.pad list."""
    return [v for lo_hi in reversed(pairs) for v in lo_hi]


def _to_cf(a, spatial):
    return a.permute(0, spatial + 1, *range(1, spatial + 1))


def _to_cl(a, spatial):
    return a.permute(0, *range(2, spatial + 2), 1)


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _conv_nd(x, w, bias, stride, padding, dilation, groups, spatial,
             data_format, transposed=False, output_padding=0):
    xs, ws = tuple(x.shape), tuple(w.shape)
    opname = f"conv{spatial}d{'_transpose' if transposed else ''}"
    if len(xs) != spatial + 2:
        raise ValueError(
            f"(InvalidArgument) {opname}: input must be {spatial + 2}-D "
            f"(batch, channels, spatial...), but received x.shape={xs}.")
    cf = data_format.startswith("NC")
    cin = xs[1 if cf else len(xs) - 1]
    # weight layouts: (out, in/groups, k...) forward; (in, out/groups, k...)
    # transposed -- torch's own
    expect = ws[0] if transposed else ws[1] * groups
    if cin != expect:
        rule = "weight.shape[0]" if transposed else "weight.shape[1] * groups"
        raise ValueError(
            f"(InvalidArgument) {opname}: input channels ({cin}) must "
            f"equal {rule} ({expect}), but received x.shape={xs}, "
            f"weight.shape={ws}, groups={groups}, "
            f"data_format={data_format}.")
    strides = _pair(stride, spatial)
    dils = _pair(dilation, spatial)
    ksize = ws[2:]
    pad = _conv_padding(padding, spatial, ksize, strides, dils,
                        channels_first=cf)
    if transposed and pad == "SAME":
        raise ValueError("SAME padding unsupported for transpose conv")

    def fn(a, wt, *b):
        if not cf:
            a = _to_cf(a, spatial)
        sizes = a.shape[2:]
        pairs = _resolve(pad, sizes, ksize, strides, dils)
        if not transposed:
            out = _CONV[spatial](TF.pad(a, _flat(pairs)), wt, None, strides,
                                 0, dils, groups)
        else:
            # the full transposed output, then the reference's crop
            # [lo, full - hi + output_padding) (zeros past the end)
            outpad = _pair(output_padding, spatial)
            out = _CONV_T[spatial](a, wt, None, strides, 0, 0, groups, dils)
            extra = [(0, max(0, op - hi)) for (_, hi), op in zip(pairs,
                                                                  outpad)]
            if any(e for _, e in extra):
                out = TF.pad(out, _flat([(0, 0), (0, 0)] + extra))
            sl = [slice(None), slice(None)]
            for d, ((lo, hi), op) in enumerate(zip(pairs, outpad)):
                full = (sizes[d] - 1) * strides[d] + \
                    (ksize[d] - 1) * dils[d] + 1
                sl.append(slice(lo, full - hi + op))
            out = out[tuple(sl)]
        if b:
            out = out + b[0].reshape([1, -1] + [1] * spatial)
        return out if cf else _to_cl(out, spatial)

    args = (x, w) if bias is None else (x, w, bias)
    return apply_op(fn, *args, name=opname)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format, transposed=True,
                    output_padding=output_padding)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, transposed=True,
                    output_padding=output_padding)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", name=None):
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, transposed=True,
                    output_padding=output_padding)


# ---------------------------------------------------------------- pooling

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _window_sum(a, ks, st, spatial):
    """Sum over each window (no padding: the caller pads)."""
    return _AVG_POOL[spatial](a, ks, st) * float(np.prod(ks))


def _pool_nd(x, kernel, stride, padding, spatial, ceil_mode=False,
             data_format="NCHW", exclusive=True, is_avg=False):
    ks = _pair(kernel, spatial)
    st = _pair(stride if stride is not None else kernel, spatial)
    cf = data_format.startswith("NC")
    pad = _conv_padding(padding, spatial, ks, st, (1,) * spatial,
                        channels_first=cf)
    if ceil_mode and isinstance(pad, str) and pad == "VALID":
        raise ValueError(
            'When Attr(padding) is "VALID", Attr(ceil_mode) must be False. '
            'Received ceil_mode: True.')

    def fn(a):
        if not cf:
            a = _to_cf(a, spatial)
        sizes = a.shape[2:]
        orig = _resolve(pad, sizes, ks, st, (1,) * spatial)
        pairs = orig
        if ceil_mode and not isinstance(pad, str):
            # out = ceil((in + lo + hi - k) / s) + 1 with no drop-last-window
            # rule: extra high padding realizes it; those cells are padding
            pairs = []
            for i, (lo, hi) in enumerate(orig):
                span = sizes[i] + lo + hi - ks[i]
                out_ceil = -(-span // st[i]) + 1
                need = (out_ceil - 1) * st[i] + ks[i] - (sizes[i] + lo)
                pairs.append((lo, max(hi, need)))
        if is_avg:
            summed = _window_sum(TF.pad(a, _flat(pairs)), ks, st, spatial)
            no_pad = all(p == (0, 0) for p in pairs)
            if exclusive and no_pad:
                out = summed / float(np.prod(ks))
            elif exclusive:
                # divisor: the window's overlap with the input
                ones = TF.pad(torch.ones_like(a), _flat(pairs))
                out = summed / _window_sum(ones, ks, st, spatial)
            elif isinstance(pad, str) or not ceil_mode:
                out = summed / float(np.prod(ks))
            else:
                # divisor: overlap with the input and the original padding
                # (only the ceil cells are left out)
                ones = TF.pad(torch.ones_like(a), _flat(orig), value=1.0)
                extra = [(p[0] - o[0], p[1] - o[1])
                         for p, o in zip(pairs, orig)]
                out = summed / _window_sum(TF.pad(ones, _flat(extra)), ks,
                                           st, spatial)
        else:
            if a.is_floating_point():
                fill = float("-inf")
            else:
                fill = torch.iinfo(a.dtype).min
            out = _MAX_POOL[spatial](TF.pad(a, _flat(pairs), value=fill), ks,
                                     st)
            if a.is_floating_point():
                # windows with no finite value give the dtype's minimum
                out = torch.where(torch.isneginf(out),
                                  torch.finfo(a.dtype).min, out)
        return out if cf else _to_cl(out, spatial)

    return apply_op(fn, x, name=f"{'avg' if is_avg else 'max'}_pool"
                                f"{spatial}d")


def _max_pool_with_mask(x, kernel, stride, padding, spatial,
                        data_format="NCHW", ceil_mode=False):
    """Max pool that also returns the argmax's flat index into the input's
    spatial plane (paddle's return_mask, which feeds max_unpool*)."""
    if not data_format.startswith("NC"):
        raise NotImplementedError(
            "return_mask requires channels-first data_format")
    if ceil_mode:
        raise NotImplementedError("return_mask with ceil_mode is not "
                                  "supported")
    ks = _pair(kernel, spatial)
    st = _pair(stride if stride is not None else kernel, spatial)
    pad = _conv_padding(padding, spatial, ks, st, (1,) * spatial)
    if isinstance(pad, str):
        raise ValueError("return_mask does not support string padding")

    def fn(a):
        sp = a.shape[-spatial:]
        out_sp = tuple((s + lo + hi - k) // t + 1
                       for s, (lo, hi), k, t in zip(sp, pad, ks, st))
        neg = float("-inf") if a.is_floating_point() \
            else torch.iinfo(a.dtype).min
        ap = TF.pad(a, _flat(pad), value=neg)
        views = []
        for offs in itertools.product(*[range(k) for k in ks]):
            sl = tuple(slice(o, o + (osz - 1) * t + 1, t)
                       for o, osz, t in zip(offs, out_sp, st))
            views.append(ap[(Ellipsis,) + sl])
        stacked = torch.stack(views)                  # (K, ..., *out_sp)
        pooled = stacked.amax(dim=0)
        k_best = stacked.argmax(dim=0)            # the first maximum
        flat = torch.zeros_like(k_best)
        rem = k_best
        for d in range(spatial):
            inner = int(np.prod(ks[d + 1:])) if d + 1 < spatial else 1
            off_d = rem // inner
            rem = rem % inner
            grid = torch.arange(out_sp[d], device=a.device) * st[d] \
                - pad[d][0]
            shape = [1] * pooled.dim()
            shape[pooled.dim() - spatial + d] = out_sp[d]
            flat = flat * sp[d] + off_d + grid.reshape(shape)
        return pooled, flat
    return apply_op(fn, x, name=f"max_pool{spatial}d")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 1,
                                   "NCL", ceil_mode)
    return _pool_nd(x, kernel_size, stride, padding, 1, ceil_mode, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 2,
                                   data_format, ceil_mode)
    return _pool_nd(x, kernel_size, stride, padding, 2, ceil_mode,
                    data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, kernel_size, stride, padding, 3,
                                   data_format, ceil_mode)
    return _pool_nd(x, kernel_size, stride, padding, 3, ceil_mode,
                    data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, ceil_mode, "NCL",
                    exclusive, is_avg=True)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2, ceil_mode,
                    data_format, exclusive, is_avg=True)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3, ceil_mode,
                    data_format, exclusive, is_avg=True)


def _adaptive_regions(in_size, out_size):
    starts = (np.arange(out_size) * in_size) // out_size
    ends = ((np.arange(out_size) + 1) * in_size + out_size - 1) // out_size
    return starts, ends


def _adaptive_reduce_nd(a, out_sizes, mode):
    """Uneven adaptive pooling over the trailing len(out_sizes) axes: one
    nested static loop over the floor/ceil buckets."""
    spatial = len(out_sizes)
    in_sizes = a.shape[-spatial:]
    regions = [_adaptive_regions(i, o) for i, o in zip(in_sizes, out_sizes)]
    red_axes = tuple(range(-spatial, 0))

    def build(level, index):
        if level == spatial:
            sl = (Ellipsis,) + tuple(
                slice(int(regions[d][0][index[d]]),
                      int(regions[d][1][index[d]])) for d in range(spatial))
            blk = a[sl]
            return blk.mean(dim=red_axes) if mode == "avg" \
                else blk.amax(dim=red_axes)
        return torch.stack([build(level + 1, index + (i,))
                            for i in range(out_sizes[level])],
                           dim=-1 - (spatial - level - 1))
    return build(0, ())


def _adaptive_even_or_uneven(a, out_sizes, mode):
    spatial = len(out_sizes)
    in_sizes = a.shape[-spatial:]
    if all(i % o == 0 for i, o in zip(in_sizes, out_sizes)):
        shape = list(a.shape[:-spatial])
        for i, o in zip(in_sizes, out_sizes):
            shape += [o, i // o]
        r = a.reshape(shape)
        axes = tuple(-1 - 2 * j for j in range(spatial))
        return r.mean(dim=axes) if mode == "avg" else r.amax(dim=axes)
    return _adaptive_reduce_nd(a, out_sizes, mode)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    out = _pair(output_size, 2)
    return apply_op(lambda a: _adaptive_even_or_uneven(a, out, "avg"), x,
                    name="adaptive_avg_pool2d")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _pair(output_size, 2)
    return apply_op(lambda a: _adaptive_even_or_uneven(a, out, "max"), x,
                    name="adaptive_max_pool2d")


def adaptive_avg_pool1d(x, output_size, name=None):
    out = (int(output_size),)
    return apply_op(lambda a: _adaptive_even_or_uneven(a, out, "avg"), x,
                    name="adaptive_avg_pool1d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = (int(output_size),)
    return apply_op(lambda a: _adaptive_even_or_uneven(a, out, "max"), x,
                    name="adaptive_max_pool1d")
