"""Sparse 3-D convolutions over COO point clouds (counterpart of
`paddle_tpu/sparse/nn/conv.py`; reference Paddle's sparse Conv3D /
SubmConv3D).

The algorithm is the reference's: a rulebook (for each of the kernel's
offsets, which input site feeds which output site), then one gather, one
matmul and one scatter-add per offset. The reference builds its rulebook
on the host with a Python loop over every input site for each offset (the
reference Paddle builds it in a CUDA kernel); at a LiDAR sweep's size
that is about a million Python steps a layer. The port builds it with
tensor ops on the input's device (`rulebook`):

  * a site's key is its linear index (b, z, y, x) over the batch and the
    output grid;
  * every (offset, input) candidate is a cell of one (offsets, nnz)
    grid, and one `nonzero` over its valid cells takes the pairs
    offset-major and input-minor, as the reference's loops take them
    (one host sync a layer, for the pairs per offset);
  * submanifold: the input keys are sorted once (stably) and every
    candidate key is looked up with `searchsorted`; a coordinate that
    appears twice maps to its last row, as the reference's dict does;
  * strided: output sites are numbered in order of their first
    appearance (`scatter_reduce` "amin" of the pair positions over
    `torch.unique`'s inverse, then a sort by it), which is the
    reference's `dict.setdefault` order.

`rulebook_plain` is the reference's host loop, kept as the plain version:
the two are equal index for index. The scatter-add is `index_add_`; on
CUDA it uses atomics, so the values agree with the plain path within an
f32 tolerance, not bit for bit.

Layout as the reference: dense_shape (N, D, H, W, C), indices (4, nnz) =
[batch, z, y, x], values (nnz, C), weight (kd, kh, kw, Cin, Cout).
"""
import numpy as np
import torch

from ...core.tensor import Tensor, apply_op
from ...nn.initializer import XavierUniform
from ...nn.layer.layers import Layer

__all__ = ["conv3d", "subm_conv3d", "Conv3D", "SubmConv3D", "rulebook",
           "rulebook_plain"]


def _triple(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * 3


def _out_spatial(dense_shape, ksize, stride, padding, dilation):
    return tuple((n + 2 * p - d * (k - 1) - 1) // s + 1
                 for n, k, s, p, d in zip(dense_shape[1:4], ksize, stride,
                                          padding, dilation))


def rulebook_plain(in_idx, dense_shape, ksize, stride, padding, dilation,
                   subm):
    """The reference's host rulebook (numpy): (out_idx (4, m) int64, one
    (gather, scatter) int32 pair of arrays an offset, out_spatial)."""
    kd, kh, kw = ksize
    sd, sh, sw = stride
    pd, ph, pw = padding
    dd, dh, dw = dilation
    D, H, W = dense_shape[1:4]
    coords = np.asarray(in_idx).T                 # (nnz, 4) b z y x
    D_out, H_out, W_out = _out_spatial(dense_shape, ksize, stride, padding,
                                       dilation)

    def out_site(b, z, y, x, oz, oy, ox):
        z2 = z + pd - oz * dd
        y2 = y + ph - oy * dh
        x2 = x + pw - ox * dw
        if z2 % sd or y2 % sh or x2 % sw:
            return None
        z2 //= sd
        y2 //= sh
        x2 //= sw
        if subm:
            return (b, z2, y2, x2)
        if 0 <= z2 < D_out and 0 <= y2 < H_out and 0 <= x2 < W_out:
            return (b, z2, y2, x2)
        return None

    per_offset = []
    out_key = {tuple(c): i for i, c in enumerate(map(tuple, coords))} \
        if subm else {}
    for oz in range(kd):
        for oy in range(kh):
            for ox in range(kw):
                pairs = []
                for i, (b, z, y, x) in enumerate(coords):
                    site = out_site(b, z, y, x, oz, oy, ox)
                    if site is None:
                        continue
                    if subm:
                        j = out_key.get(site)
                        if j is None:
                            continue
                    else:
                        j = out_key.setdefault(site, len(out_key))
                    pairs.append((i, j))
                per_offset.append(pairs)

    if subm:
        out_coords = coords
        out_spatial = (D, H, W)
    else:
        out_coords = np.asarray(sorted(out_key, key=out_key.get),
                                np.int64).reshape(-1, 4)
        out_spatial = (D_out, H_out, W_out)
    rules = [(np.asarray([p[0] for p in pairs], np.int32),
              np.asarray([p[1] for p in pairs], np.int32))
             for pairs in per_offset]
    return np.asarray(out_coords, np.int64).T, rules, out_spatial


def rulebook(in_idx, dense_shape, ksize, stride, padding, dilation, subm):
    """The rulebook with tensor ops on in_idx's device: (out_idx (4, m)
    int64, one (gather, scatter) int64 pair of tensors an offset,
    out_spatial), equal to `rulebook_plain`'s. Every (offset, input) pair
    is a cell of one (offsets, nnz) grid, whose row-major `nonzero` takes
    the pairs offset-major and input-minor, as the reference's loops."""
    dev = in_idx.device
    coords = in_idx.to(torch.int64)
    spatial = tuple(int(n) for n in dense_shape[1:4]) if subm else \
        _out_spatial(dense_shape, ksize, stride, padding, dilation)
    Dl, Hl, Wl = spatial

    def key(bb, zz, yy, xx):
        return ((bb * Dl + zz) * Hl + yy) * Wl + xx

    offs = torch.cartesian_prod(*[torch.arange(k, device=dev)
                                  for k in ksize]).reshape(-1, 3)
    K = offs.shape[0]
    ok = torch.ones((K, coords.shape[1]), dtype=torch.bool, device=dev)
    pos = []
    for axis in range(3):
        c2 = coords[axis + 1][None] + (padding[axis] - offs[:, axis:axis + 1]
                                       * dilation[axis])
        ok &= torch.remainder(c2, stride[axis]) == 0
        c2 = torch.div(c2, stride[axis], rounding_mode="floor")
        ok &= (c2 >= 0) & (c2 < spatial[axis])
        pos.append(c2)
    keys = key(coords[0][None], *pos)                   # (K, nnz)
    if subm:
        sorted_keys, perm = torch.sort(key(*coords), stable=True)
        at = (torch.searchsorted(sorted_keys, keys.reshape(-1), right=True)
              - 1).clamp_min(0).reshape(keys.shape)
        ok &= sorted_keys[at] == keys
    kk, g = torch.nonzero(ok, as_tuple=True)
    counts = torch.bincount(kk, minlength=K).tolist()
    if subm:
        scatter, out_idx = perm[at[kk, g]], coords
    else:
        allk = keys[kk, g]
        uniq, inv = torch.unique(allk, return_inverse=True)
        # output sites numbered by first appearance (the reference's
        # dict.setdefault), not by torch.unique's sorted order
        first = torch.full(uniq.shape, allk.numel(), dtype=torch.int64,
                           device=dev).scatter_reduce(
            0, inv, torch.arange(allk.numel(), device=dev), "amin")
        order = torch.argsort(first)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.numel(), device=dev)
        scatter = rank[inv]
        ok_keys = uniq[order]
        xx = ok_keys % Wl
        rest = torch.div(ok_keys, Wl, rounding_mode="floor")
        yy = rest % Hl
        rest = torch.div(rest, Hl, rounding_mode="floor")
        out_idx = torch.stack([torch.div(rest, Dl, rounding_mode="floor"),
                               rest % Dl, yy, xx])
    return out_idx, list(zip(torch.split(g, counts),
                             torch.split(scatter, counts))), spatial


def _sparse_conv(x, weight, bias, stride, padding, dilation, subm):
    ksize = tuple(int(s) for s in weight.shape[:3])
    in_idx = x.indices_._data.to(x.values_._data.device)
    out_idx, rules, out_spatial = rulebook(in_idx, x.shape, ksize, stride,
                                           padding, dilation, subm)
    m = out_idx.shape[1]
    Cout = int(weight.shape[-1])

    def fn(vals, w, *b):
        out = vals.new_zeros((m, Cout),
                             dtype=torch.promote_types(vals.dtype, w.dtype))
        for k, (g, s) in enumerate(rules):
            if g.numel() == 0:
                continue
            oz, rem = divmod(k, ksize[1] * ksize[2])
            oy, ox = divmod(rem, ksize[2])
            out.index_add_(0, s, vals[g] @ w[oz, oy, ox])
        if b:
            out = out + b[0]
        return out

    from .. import SparseCooTensor
    args = [x.values_, weight] + ([bias] if bias is not None else [])
    out_vals = apply_op(fn, *args, name="subm_conv3d" if subm else "conv3d")
    out_shape = [x.shape[0], *out_spatial, Cout]
    return SparseCooTensor(Tensor(out_idx), out_vals, out_shape)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NDHWC", name=None):
    """Sparse conv3d."""
    if groups != 1:
        raise NotImplementedError("sparse conv3d: groups > 1")
    return _sparse_conv(x, _unwrap_w(weight), bias, _triple(stride),
                        _triple(padding), _triple(dilation), subm=False)


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", key=None, name=None):
    """Submanifold sparse conv3d: the output sites are the input sites
    (stride 1 by definition)."""
    if groups != 1:
        raise NotImplementedError("sparse subm_conv3d: groups > 1")
    if _triple(stride) != (1, 1, 1):
        raise NotImplementedError(
            "subm_conv3d requires stride=1 (output sites are the input "
            "sites; use sparse conv3d for strided downsampling)")
    return _sparse_conv(x, _unwrap_w(weight), bias, _triple(stride),
                        _triple(padding), _triple(dilation), subm=True)


def _unwrap_w(w):
    return w if isinstance(w, Tensor) else Tensor(torch.as_tensor(w))


class _SparseConvBase(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NDHWC"):
        super().__init__()
        if groups != 1:
            raise NotImplementedError("sparse conv layers: groups > 1")
        kd, kh, kw = _triple(kernel_size)
        self.weight = self.create_parameter(
            (kd, kh, kw, in_channels, out_channels), attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True)
        self._stride = _triple(stride)
        self._padding = _triple(padding)
        self._dilation = _triple(dilation)


class Conv3D(_SparseConvBase):
    def forward(self, x):
        return _sparse_conv(x, self.weight, self.bias, self._stride,
                            self._padding, self._dilation, subm=False)


class SubmConv3D(_SparseConvBase):
    """Stride must be 1."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self._stride != (1, 1, 1):
            raise NotImplementedError(
                "SubmConv3D requires stride=1 (output sites are the "
                "input sites)")

    def forward(self, x):
        return _sparse_conv(x, self.weight, self.bias, self._stride,
                            self._padding, self._dilation, subm=True)
