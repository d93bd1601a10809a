"""paddle.vision.ops for the port (counterpart of `paddle_tpu/vision/ops.py`):
detection and vision operators.

Where the reference computes in `jax.numpy` (roi_align, deform_conv2d,
yolo_box, box_coder), the port computes in plain torch on the tensors'
device, and gradients flow where the reference's do (roi_align to the
feature map and the boxes; deform_conv2d to the input, offsets, weight,
bias and mask). The reference's host-side numpy passes stay host numpy
(nms and matrix_nms, roi_pool, psroi_pool, distribute_fpn_proposals,
prior_box, generate_proposals: sequential or data-dependent postprocess),
and their results land on the input's device. `yolo_loss` keeps the
reference's host assignment of ground truths to anchors and cells but
computes the loss in torch on the input's device, so its gradient flows
to the head's map. `decode_jpeg` imports PIL when it is called.
"""
import numpy as np
import torch

from ..core.tensor import Tensor, apply_op, to_tensor
from ..nn.initializer import Constant, Uniform
from ..nn.layer.layers import Layer

__all__ = ["roi_align", "roi_pool", "psroi_pool", "nms", "matrix_nms",
           "deform_conv2d", "DeformConv2D", "RoIAlign", "RoIPool",
           "PSRoIPool", "distribute_fpn_proposals", "generate_proposals",
           "prior_box", "box_coder", "yolo_box", "yolo_loss", "read_file",
           "decode_jpeg"]


def _unwrap(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(
        np.asarray(x))


def _host(x, dtype=None):
    a = x.numpy() if isinstance(x, Tensor) else np.asarray(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    return a if dtype is None else np.asarray(a, dtype)


def _device_of(x):
    if isinstance(x, Tensor):
        return x._data.device
    if isinstance(x, torch.Tensor):
        return x.device
    return None


def _out(arr, like):
    """A host result as a Tensor on `like`'s device (the current place
    when `like` is not a tensor)."""
    return to_tensor(np.ascontiguousarray(arr), place=_device_of(like))


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _as_tensor_on(v, like):
    if isinstance(v, Tensor):
        return v
    return to_tensor(np.asarray(v), place=_device_of(like))


# ------------------------------------------------------------- roi_align

def _bilinear_sample(feat, ys, xs):
    """feat: (R, C, H, W); ys: (R, A); xs: (R, B) -> (R, C, A, B).

    Boundary rules of phi's roi_align kernel: points further than 1px
    outside contribute 0; points in (-1, 0] clamp to the border; corner
    indices clamp at the far edge."""
    R, C, H, W = feat.shape
    valid = ((ys >= -1.0) & (ys <= H))[:, :, None] & \
            ((xs >= -1.0) & (xs <= W))[:, None, :]
    ys = torch.clamp(ys, 0.0, H - 1)
    xs = torch.clamp(xs, 0.0, W - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    r = torch.arange(R, device=feat.device)[:, None, None]

    def at(yi, xi):
        # (R, A, B) gather per channel -> (R, A, B, C)
        return feat[r, :, yi[:, :, None], xi[:, None, :]]

    w00 = ((1 - ly)[:, :, None] * (1 - lx)[:, None, :])[..., None]
    w01 = ((1 - ly)[:, :, None] * lx[:, None, :])[..., None]
    w10 = (ly[:, :, None] * (1 - lx)[:, None, :])[..., None]
    w11 = (ly[:, :, None] * lx[:, None, :])[..., None]
    out = (at(y0i, x0i) * w00 + at(y0i, x1i) * w01 +
           at(y1i, x0i) * w10 + at(y1i, x1i) * w11)
    out = out * valid[..., None]
    return out.permute(0, 3, 1, 2)                  # (R, C, A, B)


def _roi_sample_grid(boxes, output_size, spatial_scale, sampling_ratio,
                     aligned):
    ph, pw = _pair(output_size)
    ns = sampling_ratio if sampling_ratio > 0 else 2
    off = 0.5 if aligned else 0.0
    b = boxes * spatial_scale
    x1, y1, x2, y2 = b[:, 0] - off, b[:, 1] - off, b[:, 2] - off, \
        b[:, 3] - off
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    bin_w = roi_w / pw
    bin_h = roi_h / ph
    # sample points: (R, ph*ns) y coords, (R, pw*ns) x coords
    dev = boxes.device
    iy = (torch.arange(ph * ns, device=dev, dtype=torch.float32) + 0.5) / ns
    ix = (torch.arange(pw * ns, device=dev, dtype=torch.float32) + 0.5) / ns
    ys = y1[:, None] + iy[None, :] * bin_h[:, None]
    xs = x1[:, None] + ix[None, :] * bin_w[:, None]
    return ys, xs, ph, pw, ns


def _rois_feat(x, boxes_num, R):
    if boxes_num is None:
        bidx = torch.zeros((R,), dtype=torch.int64, device=x.device)
    else:
        counts = _unwrap(boxes_num).to(device=x.device, dtype=torch.int64)
        bidx = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=x.device), counts,
            output_size=R)
    return x[bidx]


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: the average of bilinear samples per output bin (an
    adaptive sampling_ratio (-1) takes 2 points an axis). Differentiable
    in the feature map and the boxes."""
    def fn(xr, br):
        br32 = br.to(torch.float32)
        ys, xs, ph, pw, ns = _roi_sample_grid(
            br32, output_size, spatial_scale, sampling_ratio, aligned)
        feat = _rois_feat(xr, boxes_num, br32.shape[0])
        samples = _bilinear_sample(feat, ys, xs)   # (R, C, ph*ns, pw*ns)
        R, C = samples.shape[:2]
        return samples.reshape(R, C, ph, ns, pw, ns).mean(dim=(3, 5))

    if isinstance(x, Tensor):
        return apply_op(fn, x, _as_tensor_on(boxes, x), name="roi_align")
    return fn(_unwrap(x), _unwrap(boxes))


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    """RoIPool with phi's quantized-bin max rules, host numpy (the bins'
    extents depend on the data)."""
    xr = _host(x)
    br = _host(boxes, np.float32) * spatial_scale
    ph, pw = _pair(output_size)
    N, C, H, W = xr.shape
    R = br.shape[0]
    counts = (_host(boxes_num) if boxes_num is not None
              else np.asarray([R]))
    bidx = np.repeat(np.arange(counts.shape[0]), counts)
    out = np.zeros((R, C, ph, pw), xr.dtype)
    for r in range(R):
        x1, y1, x2, y2 = np.round(br[r]).astype(np.int64)
        roi_h = max(y2 - y1 + 1, 1)
        roi_w = max(x2 - x1 + 1, 1)
        for py in range(ph):
            ys_ = y1 + int(np.floor(py * roi_h / ph))
            ye = y1 + int(np.ceil((py + 1) * roi_h / ph))
            ys_, ye = np.clip([ys_, ye], 0, H)
            for px in range(pw):
                xs_ = x1 + int(np.floor(px * roi_w / pw))
                xe = x1 + int(np.ceil((px + 1) * roi_w / pw))
                xs_, xe = np.clip([xs_, xe], 0, W)
                if ye > ys_ and xe > xs_:
                    out[r, :, py, px] = xr[bidx[r], :, ys_:ye,
                                           xs_:xe].max(axis=(1, 2))
    return _out(out, x) if isinstance(x, Tensor) else out


# ------------------------------------------------------------------ nms

def _iou_matrix(boxes):
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    xx1 = np.maximum(x1[:, None], x1[None, :])
    yy1 = np.maximum(y1[:, None], y1[None, :])
    xx2 = np.minimum(x2[:, None], x2[None, :])
    yy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
    return inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None, name=None):
    """Greedy NMS, host numpy (sequential suppression). Returns the kept
    indices (int64), score-descending."""
    b = _host(boxes, np.float32)
    n = b.shape[0]
    s = (_host(scores, np.float32) if scores is not None
         else np.arange(n, 0, -1, dtype=np.float32))
    order = np.argsort(-s)
    iou = _iou_matrix(b)
    if category_idxs is not None:
        cats = _host(category_idxs)
        iou = iou * (cats[:, None] == cats[None, :])  # suppress within class
    keep = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    keep = np.asarray(keep, dtype=np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return _out(keep, boxes) if isinstance(boxes, Tensor) else keep


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False, rois_num=None,
                             name=None):
    """Assign RoIs to FPN levels by scale: level = floor(refer +
    log2(sqrt(area) / scale))."""
    rois = _host(fpn_rois, np.float32)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-9))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-9))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi_rois, restore = [], []
    for level in range(min_level, max_level + 1):
        idx = np.where(lvl == level)[0]
        multi_rois.append(_out(rois[idx], fpn_rois))
        restore.append(idx)
    restore_ind = np.argsort(np.concatenate(restore)) if restore else \
        np.zeros((0,), np.int64)
    return multi_rois, _out(restore_ind.astype(np.int64), fpn_rois), None


# ------------------------------------------------------------- yolo_box

def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLO head map (N, A*(5+C), H, W) to boxes and scores."""
    xr = _unwrap(x).to(torch.float32)
    dev = xr.device
    N, _, H, W = xr.shape
    A = len(anchors) // 2
    anc = torch.as_tensor(np.asarray(anchors, np.float32),
                          device=dev).reshape(A, 2)
    p = xr.reshape(N, A, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    sxy = scale_x_y
    bx = (torch.sigmoid(p[:, :, 0]) * sxy - (sxy - 1) / 2 + gx) / W
    by = (torch.sigmoid(p[:, :, 1]) * sxy - (sxy - 1) / 2 + gy) / H
    bw = torch.exp(p[:, :, 2]) * anc[None, :, 0, None, None] / \
        (W * downsample_ratio)
    bh = torch.exp(p[:, :, 3]) * anc[None, :, 1, None, None] / \
        (H * downsample_ratio)
    obj = torch.sigmoid(p[:, :, 4])
    cls = torch.sigmoid(p[:, :, 5:])
    scores = obj[:, :, None] * cls                  # (N, A, C, H, W)

    img = _unwrap(img_size).to(device=dev, dtype=torch.float32)  # (N, 2)
    imh = img[:, 0][:, None, None, None]
    imw = img[:, 1][:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    mask = obj.reshape(N, -1, 1) > conf_thresh
    boxes = boxes * mask
    if isinstance(x, Tensor):
        return Tensor(boxes), Tensor(scores)
    return boxes, scores


# -------------------------------------------------------- deform_conv2d

def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable conv v1 / v2 (with `mask`): bilinear samples of the input
    at the offset taps, contracted with the kernel. Gradients flow to the
    input, offsets, weight, bias and mask."""
    tensor_out = isinstance(x, Tensor)
    args = [x, offset, weight]
    has_bias = bias is not None
    has_mask = mask is not None
    if has_bias:
        args.append(_as_tensor_on(bias, x))
    if has_mask:
        args.append(_as_tensor_on(mask, x))

    def fn(xr, offr, wr, *rest):
        b = rest[0] if has_bias else None
        m = rest[-1] if has_mask else None
        return _deform_conv2d_raw(xr, offr, wr, b, m, stride, padding,
                                  dilation, deformable_groups, groups)

    if tensor_out:
        return apply_op(fn, *args, name="deform_conv2d")
    return fn(*[_unwrap(a) for a in args])


def _deform_conv2d_raw(xr, offr, wr, bias, mask, stride, padding, dilation,
                       deformable_groups, groups):
    xr = xr.to(torch.float32)
    offr = offr.to(torch.float32)
    wr = wr.to(torch.float32)
    dev = xr.device
    N, C, H, W = xr.shape
    Co, Cg, kh, kw = wr.shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError("groups/deformable_groups > 1")

    def ar(n, step, start=0):
        return torch.arange(n, dtype=torch.float32, device=dev) * step \
            - start

    # sampling positions: base grid + kernel taps + learned offsets
    oy, ox = ar(Ho, sh, ph), ar(Wo, sw, pw)
    ky, kx = ar(kh, dh), ar(kw, dw)
    # offsets layout: (N, 2*kh*kw, Ho, Wo), [dy, dx] per tap
    off = offr.reshape(N, kh * kw, 2, Ho, Wo)
    ys = (oy[None, None, :, None]
          + ky.repeat_interleave(kw)[None, :, None, None] + off[:, :, 0])
    xs = (ox[None, None, None, :] + kx.repeat(kh)[None, :, None, None]
          + off[:, :, 1])

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    flat_x = xr.reshape(N, C, H * W)

    def gather(yi, xi):
        yc = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xc = torch.clamp(xi.to(torch.int64), 0, W - 1)
        flat = (yc * W + xc).reshape(N, 1, -1)      # (N, 1, K*Ho*Wo)
        g = torch.gather(flat_x, 2, flat.expand(N, C, flat.shape[-1]))
        valid = ((yi >= 0) & (yi <= H - 1) & (xi >= 0) &
                 (xi <= W - 1)).reshape(N, 1, -1)
        return g * valid

    v = (gather(y0, x0) * ((1 - ly) * (1 - lx)).reshape(N, 1, -1) +
         gather(y0, x0 + 1) * ((1 - ly) * lx).reshape(N, 1, -1) +
         gather(y0 + 1, x0) * (ly * (1 - lx)).reshape(N, 1, -1) +
         gather(y0 + 1, x0 + 1) * (ly * lx).reshape(N, 1, -1))
    cols = v.reshape(N, C, kh * kw, Ho, Wo)
    if mask is not None:                            # v2 modulation
        cols = cols * mask.to(torch.float32).reshape(N, 1, kh * kw, Ho, Wo)
    out = torch.einsum("nckhw,ock->nohw", cols, wr.reshape(Co, C, kh * kw))
    if bias is not None:
        out = out + bias.reshape(1, Co, 1, 1)
    return out


class DeformConv2D(Layer):
    """Deformable conv Layer: weight from Uniform(+-1/sqrt(fan_in)) with
    fan_in = in_channels * kh * kw, bias zeros."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._deformable_groups = deformable_groups
        bound = 1.0 / np.sqrt(in_channels * kh * kw)
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw],
            default_initializer=Uniform(-bound, bound))
        self.bias = None
        if bias_attr is not False:
            self.bias = self.create_parameter(
                [out_channels], is_bias=True,
                default_initializer=Constant(0.0))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             stride=self._stride, padding=self._padding,
                             dilation=self._dilation, groups=self._groups,
                             deformable_groups=self._deformable_groups,
                             mask=mask)


class RoIAlign(Layer):
    """Layer form of roi_align."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale, aligned=aligned)


class RoIPool(Layer):
    """Layer form of roi_pool."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling, host numpy: input channels C =
    out_channels * ph * pw; bin (i, j) averages its own channel group."""
    ph, pw = _pair(output_size)
    xr = _host(x, np.float32)
    br = _host(boxes, np.float32) * spatial_scale
    N, C, H, W = xr.shape
    assert C % (ph * pw) == 0, "C must be divisible by output_size^2"
    Cout = C // (ph * pw)
    R = br.shape[0]
    counts = (_host(boxes_num).astype(np.int64)
              if boxes_num is not None else np.asarray([R]))
    bidx = np.repeat(np.arange(counts.shape[0]), counts)
    out = np.zeros((R, Cout, ph, pw), np.float32)
    for r in range(R):
        x1, y1, x2, y2 = br[r]
        roi_h = max(y2 - y1, 0.1)
        roi_w = max(x2 - x1, 0.1)
        bh, bw = roi_h / ph, roi_w / pw
        for py in range(ph):
            for px in range(pw):
                ys_ = int(np.floor(y1 + py * bh))
                ye = int(np.ceil(y1 + (py + 1) * bh))
                xs_ = int(np.floor(x1 + px * bw))
                xe = int(np.ceil(x1 + (px + 1) * bw))
                ys_, ye = np.clip([ys_, ye], 0, H)
                xs_, xe = np.clip([xs_, xe], 0, W)
                if ye > ys_ and xe > xs_:
                    for c in range(Cout):
                        ch = (c * ph + py) * pw + px
                        out[r, c, py, px] = xr[bidx[r], ch, ys_:ye,
                                               xs_:xe].mean()
    return _out(out, x) if isinstance(x, Tensor) else out


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


# ------------------------------------------------------- priors, coders

def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes for one feature map: (boxes (H, W, P, 4) in
    normalized ltrb, the variances broadcast to the same shape)."""
    H, W = int(input.shape[2]), int(input.shape[3])
    H_img, W_img = int(image.shape[2]), int(image.shape[3])
    sw = steps[0] or W_img / W
    sh = steps[1] or H_img / H
    cx = (np.arange(W) + offset) * sw
    cy = (np.arange(H) + offset) * sh
    cxg, cyg = np.meshgrid(cx, cy)
    sizes = []
    for i, ms in enumerate(min_sizes):
        sizes.append((ms, ms))
        ars = []
        for a in aspect_ratios:
            if abs(a - 1.0) > 1e-6:
                ars.append(a)
                if flip:
                    ars.append(1.0 / a)
        ar_sizes = [(ms * np.sqrt(a), ms / np.sqrt(a)) for a in ars]
        mx_sizes = []
        if max_sizes is not None and i < len(max_sizes):
            m = np.sqrt(ms * max_sizes[i])
            mx_sizes.append((m, m))
        if min_max_aspect_ratios_order:
            sizes.extend(mx_sizes + ar_sizes)
        else:
            sizes.extend(ar_sizes + mx_sizes)
    boxes = []
    for (bw, bh) in sizes:
        boxes.append(np.stack([(cxg - bw / 2) / W_img, (cyg - bh / 2) / H_img,
                               (cxg + bw / 2) / W_img, (cyg + bh / 2) / H_img],
                              axis=-1))
    pb = np.stack(boxes, axis=2)                     # (H, W, P, 4)
    if clip:
        pb = np.clip(pb, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), pb.shape)
    return _out(pb.astype(np.float32), input), _out(var, input)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode or decode boxes against priors. `axis` is the priors'
    broadcast axis for a 3-D target: 0 pairs prior j with target[:, j],
    1 prior i with target[i]."""
    def fn(pb, tb, *pv):
        pbv = pv[0] if pv else None
        if tb.dim() == 3 and pb.dim() == 2:
            expand = (None, slice(None)) if axis == 0 else (slice(None), None)
            pb = pb[expand]
            if pbv is not None and pbv.dim() == 2:
                pbv = pbv[expand]
        pw = pb[..., 2] - pb[..., 0] + (0.0 if box_normalized else 1.0)
        phh = pb[..., 3] - pb[..., 1] + (0.0 if box_normalized else 1.0)
        pcx = pb[..., 0] + pw * 0.5
        pcy = pb[..., 1] + phh * 0.5
        if code_type == "encode_center_size":
            tw = tb[..., 2] - tb[..., 0] + (0.0 if box_normalized else 1.0)
            th = tb[..., 3] - tb[..., 1] + (0.0 if box_normalized else 1.0)
            tcx = tb[..., 0] + tw * 0.5
            tcy = tb[..., 1] + th * 0.5
            out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / phh,
                               torch.log(tw / pw), torch.log(th / phh)],
                              dim=-1)
            if pbv is not None:
                out = out / pbv
            return out
        # decode_center_size
        d = tb
        if pbv is not None:
            d = d * pbv
        dcx = d[..., 0] * pw + pcx
        dcy = d[..., 1] * phh + pcy
        dw = torch.exp(d[..., 2]) * pw
        dh = torch.exp(d[..., 3]) * phh
        sub = 0.0 if box_normalized else 1.0
        return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                            dcx + dw * 0.5 - sub, dcy + dh * 0.5 - sub],
                           dim=-1)
    args = [prior_box, target_box]
    if prior_box_var is not None:
        args.append(prior_box_var if isinstance(prior_box_var, Tensor)
                    else to_tensor(np.asarray(prior_box_var, np.float32),
                                   place=_device_of(prior_box)))
    return apply_op(fn, *args, name="box_coder")


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2), host numpy: a score decays by its largest IoU
    with a higher-scoring box of its class, in one IoU-matrix pass."""
    bb = _host(bboxes, np.float32)                   # (N, M, 4)
    sc = _host(scores, np.float32)                   # (N, C, M)
    outs, indices, nums = [], [], []
    for n in range(bb.shape[0]):
        dets = []
        idxs = []
        for c in range(sc.shape[1]):
            if c == background_label:
                continue
            s = sc[n, c]
            keep = s > score_threshold
            if not keep.any():
                continue
            ki = np.where(keep)[0]
            order = ki[np.argsort(-s[ki])][:nms_top_k]
            b = bb[n, order]
            ss = s[order]
            m = len(order)
            x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
            add = 0.0 if normalized else 1.0
            area = (x2 - x1 + add) * (y2 - y1 + add)
            ix1 = np.maximum(x1[:, None], x1[None])
            iy1 = np.maximum(y1[:, None], y1[None])
            ix2 = np.minimum(x2[:, None], x2[None])
            iy2 = np.minimum(y2[:, None], y2[None])
            iw = np.maximum(ix2 - ix1 + add, 0)
            ih = np.maximum(iy2 - iy1 + add, 0)
            inter = iw * ih
            iou = inter / (area[:, None] + area[None] - inter)
            iou = np.triu(iou, k=1)                  # iou[i, j], i scored > j
            # decay_j = min_i f(iou_ij) / f(comp_i), comp_i the largest IoU
            # of box i with any box scored above it
            comp = iou.max(axis=0)
            if use_gaussian:
                D = np.exp(-(iou ** 2 - comp[:, None] ** 2) / gaussian_sigma)
            else:
                D = (1 - iou) / np.maximum(1 - comp[:, None], 1e-9)
            D = np.where(np.triu(np.ones((m, m), bool), k=1), D, np.inf)
            decay = np.minimum(D.min(axis=0), 1.0)
            decay[0] = 1.0                            # top box undecayed
            new_s = ss * decay
            ok = new_s >= post_threshold
            for j in np.where(ok)[0]:
                dets.append([c, new_s[j], *b[j]])
                idxs.append(n * bb.shape[1] + order[j])
        dets = np.asarray(dets, np.float32).reshape(-1, 6)
        srt = np.argsort(-dets[:, 1])[:keep_top_k]
        outs.append(dets[srt])
        indices.append(np.asarray(idxs, np.int64)[srt] if len(idxs)
                       else np.zeros((0,), np.int64))
        nums.append(len(srt))
    out = _out(np.concatenate(outs, axis=0) if outs
               else np.zeros((0, 6), np.float32), bboxes)
    rois_num = _out(np.asarray(nums, np.int32), bboxes)
    if return_index:
        idx = _out(np.concatenate(indices) if indices
                   else np.zeros((0,), np.int64), bboxes)
        return (out, idx, rois_num) if return_rois_num else (out, idx)
    return (out, rois_num) if return_rois_num else out


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False, name=None):
    """RPN proposals, host numpy: decode the anchor deltas, clip to the
    image, drop small boxes, NMS, top-k."""
    sc = _host(scores, np.float32)                    # (N, A, H, W)
    bd = _host(bbox_deltas, np.float32)               # (N, 4A, H, W)
    im = _host(img_size, np.float32)                  # (N, 2) h, w
    an = _host(anchors, np.float32).reshape(-1, 4)
    va = _host(variances, np.float32).reshape(-1, 4)
    N, A, H, W = sc.shape
    rois, roi_probs, nums = [], [], []
    for n in range(N):
        s = sc[n].transpose(1, 2, 0).reshape(-1)            # HWA
        d = bd[n].reshape(A, 4, H, W).transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], an[order], va[order]
        aw = a[:, 2] - a[:, 0] + (1.0 if pixel_offset else 0.0)
        ah = a[:, 3] - a[:, 1] + (1.0 if pixel_offset else 0.0)
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        dcx = v[:, 0] * d[:, 0] * aw + acx
        dcy = v[:, 1] * d[:, 1] * ah + acy
        dw = np.exp(np.minimum(v[:, 2] * d[:, 2], 10)) * aw
        dh = np.exp(np.minimum(v[:, 3] * d[:, 3], 10)) * ah
        sub = 1.0 if pixel_offset else 0.0
        boxes = np.stack([dcx - dw / 2, dcy - dh / 2,
                          dcx + dw / 2 - sub, dcy + dh / 2 - sub], axis=-1)
        h_im, w_im = im[n]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w_im - sub)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h_im - sub)
        ws = boxes[:, 2] - boxes[:, 0] + sub
        hs = boxes[:, 3] - boxes[:, 1] + sub
        keep = (ws >= min_size) & (hs >= min_size)
        boxes, s = boxes[keep], s[keep]
        if len(boxes):
            ki = nms(boxes, iou_threshold=nms_thresh, scores=s,
                     top_k=post_nms_top_n)
            boxes, s = boxes[ki], s[ki]
        rois.append(boxes)
        roi_probs.append(s[:, None])
        nums.append(len(boxes))
    out = (_out(np.concatenate(rois).astype(np.float32), scores),
           _out(np.concatenate(roi_probs).astype(np.float32), scores))
    if return_rois_num:
        return out + (_out(np.asarray(nums, np.int32), scores),)
    return out


# ------------------------------------------------------------ file ops

def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor on the current place."""
    with open(filename, "rb") as f:
        data = f.read()
    return to_tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode JPEG bytes to a CHW uint8 tensor (PIL is the codec)."""
    import io
    from PIL import Image
    data = bytes(_host(x).astype(np.uint8))
    img = Image.open(io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return _out(arr, x)


# ------------------------------------------------------------ yolo_loss

def _iou_cwh(b1, b2, eps):
    l1 = b1[..., :2] - b1[..., 2:] / 2
    r1 = b1[..., :2] + b1[..., 2:] / 2
    l2 = b2[..., :2] - b2[..., 2:] / 2
    r2 = b2[..., :2] + b2[..., 2:] / 2
    wh = np.maximum(np.minimum(r1, r2) - np.maximum(l1, l2), 0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = b1[..., 2] * b1[..., 3]
    a2 = b2[..., 2] * b2[..., 3]
    return inter / (a1 + a2 - inter + eps)


def _yolo_assign(p, gb, gl, gs, anchors, mask, class_num, ignore_thresh,
                 downsample_ratio, use_label_smooth, eps):
    """The host half of yolo_loss: each ground truth's best anchor over
    the whole set, its cell and regression targets, and the ignore
    region (predictions whose box overlaps a ground truth by more than
    `ignore_thresh`). Returns the positives as index and target arrays,
    and the objectness targets and their keep mask."""
    N, A, _, H, W = p.shape
    an_all = np.asarray(anchors, np.float32).reshape(-1, 2)
    an = an_all[mask]
    in_h, in_w = H * downsample_ratio, W * downsample_ratio
    px = 1 / (1 + np.exp(-p[:, :, 0]))
    py = 1 / (1 + np.exp(-p[:, :, 1]))
    pos = {"n": [], "a": [], "j": [], "i": [], "t": [], "w": [], "cls": []}
    obj_t = np.zeros((N, A, H, W), np.float32)
    keep = np.ones((N, A, H, W), bool)
    for n in range(N):
        obj_mask = np.zeros((A, H, W), bool)
        ignore = np.zeros((A, H, W), bool)
        gx = (np.arange(W)[None, None] + px[n]) / W
        gy = (np.arange(H)[None, :, None] + py[n]) / H
        gw = an[:, 0][:, None, None] * np.exp(p[n, :, 2]) / in_w
        gh = an[:, 1][:, None, None] * np.exp(p[n, :, 3]) / in_h
        pb = np.stack([gx, gy, gw, gh], -1).reshape(-1, 4)
        for b in range(gb.shape[1]):
            if gb[n, b, 2] <= 0 or gb[n, b, 3] <= 0:
                continue
            ious = _iou_cwh(gb[n, b][None], pb, eps).reshape(A, H, W)
            ignore |= ious > ignore_thresh
            gt_wh = gb[n, b, 2:] * np.asarray([in_w, in_h])
            best, best_iou = -1, 0
            for ai, (aw, ah) in enumerate(an_all):
                mn = np.minimum([aw, ah], gt_wh)
                inter = mn[0] * mn[1]
                u = aw * ah + gt_wh[0] * gt_wh[1] - inter
                if inter / u > best_iou:
                    best, best_iou = ai, inter / u
            if best not in mask:
                continue
            a_loc = mask.index(best)
            gi = min(int(gb[n, b, 0] * W), W - 1)
            gj = min(int(gb[n, b, 1] * H), H - 1)
            obj_mask[a_loc, gj, gi] = True
            ignore[a_loc, gj, gi] = False
            tx = gb[n, b, 0] * W - gi
            ty = gb[n, b, 1] * H - gj
            tw = np.log(gb[n, b, 2] * in_w / an[a_loc, 0] + eps)
            th = np.log(gb[n, b, 3] * in_h / an[a_loc, 1] + eps)
            delta = 1.0 / class_num if use_label_smooth else 0.0
            tcls = np.full((class_num,), delta, np.float32)
            tcls[gl[n, b]] = 1.0 - delta
            for k, v in (("n", n), ("a", a_loc), ("j", gj), ("i", gi),
                         ("t", (tx, ty, tw, th)),
                         ("w", (gs[n, b], 2.0 - gb[n, b, 2] * gb[n, b, 3])),
                         ("cls", tcls)):
                pos[k].append(v)
        obj_t[n] = obj_mask
        keep[n] = ~(~obj_mask & ignore)
    return pos, obj_t, keep


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 loss a sample: coordinate, objectness and class terms, with
    best-anchor assignment per ground truth and ignore-region masking.
    The assignment and the ignore region are host numpy (they read no
    gradient); the loss is torch on `x`'s device, differentiable in `x`."""
    eps = 1e-9
    gb = _host(gt_box, np.float32)                   # (N, B, 4) cx cy w h
    gl = _host(gt_label).astype(np.int64)            # (N, B)
    gs = (_host(gt_score, np.float32) if gt_score is not None
          else np.ones(gl.shape, np.float32))
    mask = list(anchor_mask)
    A = len(mask)
    xt = x if isinstance(x, Tensor) else to_tensor(np.asarray(x, np.float32))
    N, C, H, W = xt.shape
    p_host = _host(xt, np.float32).reshape(N, A, 5 + class_num, H, W)
    pos, obj_t, keep = _yolo_assign(p_host, gb, gl, gs, anchors, mask,
                                    class_num, ignore_thresh,
                                    downsample_ratio, use_label_smooth, eps)

    def fn(xr):
        dev = xr.device
        p = xr.to(torch.float32).reshape(N, A, 5 + class_num, H, W)

        def bce(z, y):
            zs = torch.sigmoid(z)
            return -(y * torch.log(zs + eps)
                     + (1 - y) * torch.log(1 - zs + eps))

        obj = bce(p[:, :, 4], torch.as_tensor(obj_t, device=dev))
        loss = (obj * torch.as_tensor(keep, device=dev)).sum(dim=(1, 2, 3))
        if pos["n"]:
            def idx(k):
                return torch.as_tensor(np.asarray(pos[k], np.int64),
                                       device=dev)
            n, a, j, i = idx("n"), idx("a"), idx("j"), idx("i")
            t = torch.as_tensor(np.asarray(pos["t"], np.float32), device=dev)
            w = torch.as_tensor(np.asarray(pos["w"], np.float32), device=dev)
            cls_t = torch.as_tensor(np.stack(pos["cls"]), device=dev)
            cell = p[n, a, :, j, i]                  # (P, 5 + class_num)
            box = (bce(cell[:, 0], t[:, 0]) + bce(cell[:, 1], t[:, 1])
                   + (cell[:, 2] - t[:, 2]) ** 2
                   + (cell[:, 3] - t[:, 3]) ** 2)
            per = w[:, 0] * w[:, 1] * box \
                + w[:, 0] * bce(cell[:, 5:], cls_t).sum(dim=-1)
            loss = loss.index_add(0, n, per)
        return loss

    return apply_op(fn, xt, name="yolo_loss")
