"""PP-YOLOE detection model for the port (counterpart of
`paddle_tpu/vision/models/ppyoloe.py`): conv / BatchNorm / SiLU blocks
(RepVGG-style in a CSPRepResNet backbone), a CSP-PAN neck, an
anchor-free ET-head, and its loss (varifocal classification, GIoU and
distribution-focal regression, a center-prior top-k assigner).

Ground truths are padded to a fixed count with a mask, as in the
reference, and the loss is torch on the head outputs' device.
`sync_bn=True` builds `SyncBatchNorm`, which is the local BatchNorm until
the port has collectives for Layers (ROADMAP C.15).
"""
from dataclasses import dataclass

import numpy as np

import torch
import torch.nn.functional as TF

from ...core.tensor import Tensor, apply_op
from ...nn import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Layer, LayerList,
                   Sequential, Sigmoid, Silu, SyncBatchNorm)

__all__ = ["PPYOLOE", "PPYOLOEConfig", "ppyoloe_s", "ppyoloe_crn_tiny",
           "ppyoloe_loss"]


def _norm(ch, sync):
    return SyncBatchNorm(ch) if sync else BatchNorm2D(ch)


class ConvBNLayer(Layer):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, padding=None,
                 act=True, sync_bn=False):
        super().__init__()
        if padding is None:
            padding = (k - 1) // 2
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False)
        self.bn = _norm(cout, sync_bn)
        self.act = Silu() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class RepVggBlock(Layer):
    """3x3 + 1x1 parallel branches (re-parameterizable at deploy)."""

    def __init__(self, ch, sync_bn=False):
        super().__init__()
        self.conv1 = ConvBNLayer(ch, ch, 3, act=False, sync_bn=sync_bn)
        self.conv2 = ConvBNLayer(ch, ch, 1, act=False, sync_bn=sync_bn)
        self.act = Silu()

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class EffectiveSE(Layer):
    """Effective squeeze-excite attention (PP-YOLOE CSP stages)."""

    def __init__(self, ch, sync_bn=False):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Conv2D(ch, ch, 1)
        self.act = Sigmoid()

    def forward(self, x):
        return x * self.act(self.fc(self.pool(x)))


class CSPResStage(Layer):
    def __init__(self, cin, cout, n, stride=2, attn=True, sync_bn=False):
        super().__init__()
        mid = (cin + cout) // 2
        self.conv_down = ConvBNLayer(cin, mid, 3, stride=stride,
                                     sync_bn=sync_bn) if stride > 1 else None
        src = mid if self.conv_down is not None else cin
        half = cout // 2
        self.conv1 = ConvBNLayer(src, half, 1, sync_bn=sync_bn)
        self.conv2 = ConvBNLayer(src, half, 1, sync_bn=sync_bn)
        self.blocks = Sequential(*[RepVggBlock(half, sync_bn)
                                   for _ in range(n)])
        self.attn = EffectiveSE(cout, sync_bn) if attn else None
        self.conv3 = ConvBNLayer(cout, cout, 1, sync_bn=sync_bn)

    def forward(self, x):
        if self.conv_down is not None:
            x = self.conv_down(x)
        y1 = self.conv1(x)
        y2 = self.blocks(self.conv2(x))
        from ...tensor.manipulation import concat
        y = concat([y1, y2], axis=1)
        if self.attn is not None:
            y = self.attn(y)
        return self.conv3(y)


class CSPRepResNet(Layer):
    """Backbone: stem + 3 return stages (C3, C4, C5)."""

    def __init__(self, width_mult=0.5, depth_mult=0.33, sync_bn=False):
        super().__init__()
        chs = [int(c * width_mult) for c in (64, 128, 256, 512, 1024)]
        ns = [max(round(n * depth_mult), 1) for n in (3, 6, 6, 3)]
        self.stem = Sequential(
            ConvBNLayer(3, chs[0] // 2, 3, stride=2, sync_bn=sync_bn),
            ConvBNLayer(chs[0] // 2, chs[0], 3, stride=1, sync_bn=sync_bn))
        self.stages = LayerList([
            CSPResStage(chs[i], chs[i + 1], ns[i], sync_bn=sync_bn)
            for i in range(4)])
        self.out_channels = chs[2:]

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage(x)
            if i >= 1:
                outs.append(x)
        return outs           # strides 8, 16, 32


class CSPPAN(Layer):
    """PAN neck: top-down then bottom-up fusion with CSP stages."""

    def __init__(self, in_channels, sync_bn=False):
        super().__init__()
        c3, c4, c5 = in_channels
        self.reduce5 = ConvBNLayer(c5, c4, 1, sync_bn=sync_bn)
        self.td4 = CSPResStage(c4 * 2, c4, 1, stride=1, attn=False,
                               sync_bn=sync_bn)
        self.reduce4 = ConvBNLayer(c4, c3, 1, sync_bn=sync_bn)
        self.td3 = CSPResStage(c3 * 2, c3, 1, stride=1, attn=False,
                               sync_bn=sync_bn)
        self.down3 = ConvBNLayer(c3, c3, 3, stride=2, sync_bn=sync_bn)
        self.bu4 = CSPResStage(c3 + c3, c4, 1, stride=1, attn=False,
                               sync_bn=sync_bn)
        self.down4 = ConvBNLayer(c4, c4, 3, stride=2, sync_bn=sync_bn)
        self.bu5 = CSPResStage(c4 + c4, c4, 1, stride=1, attn=False,
                               sync_bn=sync_bn)
        self.out_channels = [c3, c4, c4]

    def forward(self, feats):
        from ...nn.functional import interpolate
        from ...tensor.manipulation import concat
        c3, c4, c5 = feats
        p5 = self.reduce5(c5)
        p4 = self.td4(concat([c4, interpolate(p5, scale_factor=2)], axis=1))
        p4r = self.reduce4(p4)
        p3 = self.td3(concat([c3, interpolate(p4r, scale_factor=2)], axis=1))
        n4 = self.bu4(concat([self.down3(p3), p4r], axis=1))
        n5 = self.bu5(concat([self.down4(n4), p5], axis=1))
        return [p3, n4, n5]


class PPYOLOEHead(Layer):
    """Anchor-free ET-head: per-level cls + DFL-regression branches."""

    def __init__(self, in_channels, num_classes=80, reg_max=16,
                 sync_bn=False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.stem_cls = LayerList([ConvBNLayer(c, c, 1, sync_bn=sync_bn)
                                   for c in in_channels])
        self.stem_reg = LayerList([ConvBNLayer(c, c, 1, sync_bn=sync_bn)
                                   for c in in_channels])
        self.pred_cls = LayerList([Conv2D(c, num_classes, 3, padding=1)
                                   for c in in_channels])
        self.pred_reg = LayerList([Conv2D(c, 4 * (reg_max + 1), 3, padding=1)
                                   for c in in_channels])

    def forward(self, feats):
        from ...tensor.manipulation import concat
        cls_list, reg_list = [], []
        for i, f in enumerate(feats):
            avg = f  # ET-head uses attention over the stem; 1x1 stem here
            c = self.pred_cls[i](self.stem_cls[i](avg) + f)
            r = self.pred_reg[i](self.stem_reg[i](avg))
            N = c.shape[0]
            cls_list.append(c.reshape([N, self.num_classes, -1]))
            reg_list.append(r.reshape([N, 4 * (self.reg_max + 1), -1]))
        cls = concat(cls_list, axis=-1).transpose([0, 2, 1])  # (N, L, nc)
        reg = concat(reg_list, axis=-1).transpose([0, 2, 1])  # (N, L, 4*(m+1))
        return cls, reg


@dataclass
class PPYOLOEConfig:
    num_classes: int = 80
    width_mult: float = 0.5
    depth_mult: float = 0.33
    strides: tuple = (8, 16, 32)
    reg_max: int = 16
    sync_bn: bool = False


class PPYOLOE(Layer):
    def __init__(self, cfg: PPYOLOEConfig = None, **kw):
        super().__init__()
        cfg = cfg or PPYOLOEConfig(**kw)
        self.cfg = cfg
        self.backbone = CSPRepResNet(cfg.width_mult, cfg.depth_mult,
                                     cfg.sync_bn)
        self.neck = CSPPAN(self.backbone.out_channels, cfg.sync_bn)
        self.head = PPYOLOEHead(self.neck.out_channels, cfg.num_classes,
                                cfg.reg_max, cfg.sync_bn)

    def forward(self, images):
        return self.head(self.neck(self.backbone(images)))

    def anchor_points(self, input_hw):
        """(L, 2) pixel-space anchor centers + (L,) strides for an input
        of shape (H, W)."""
        H, W = input_hw
        pts, strides = [], []
        for s in self.cfg.strides:
            h, w = H // s, W // s
            yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
            pts.append(np.stack([(xx.reshape(-1) + 0.5) * s,
                                 (yy.reshape(-1) + 0.5) * s], axis=-1))
            strides.append(np.full((h * w,), s, np.float32))
        return (torch.as_tensor(np.concatenate(pts), dtype=torch.float32),
                torch.as_tensor(np.concatenate(strides),
                                dtype=torch.float32))


# ----------------------------------------------------------------- the loss

def _decode_boxes(reg, points, strides, reg_max):
    """DFL distances -> xyxy boxes. reg: (N, L, 4*(m+1))."""
    N, L = reg.shape[:2]
    logits = reg.reshape(N, L, 4, reg_max + 1)
    proj = torch.arange(reg_max + 1, dtype=torch.float32, device=reg.device)
    dist = (torch.softmax(logits, dim=-1) * proj).sum(-1)  # (N, L, 4) ltrb
    dist = dist * strides[None, :, None]
    x1 = points[None, :, 0] - dist[..., 0]
    y1 = points[None, :, 1] - dist[..., 1]
    x2 = points[None, :, 0] + dist[..., 2]
    y2 = points[None, :, 1] + dist[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _giou(a, b):
    """a, b: (..., 4) xyxy -> GIoU in [-1, 1]."""
    ax1, ay1, ax2, ay2 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    inter = (torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                         min=0) *
             torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                         min=0))
    area_a = torch.clamp(ax2 - ax1, min=0) * torch.clamp(ay2 - ay1, min=0)
    area_b = torch.clamp(bx2 - bx1, min=0) * torch.clamp(by2 - by1, min=0)
    union = area_a + area_b - inter
    iou = inter / torch.clamp(union, min=1e-9)
    ex1 = torch.minimum(ax1, bx1)
    ey1 = torch.minimum(ay1, by1)
    ex2 = torch.maximum(ax2, bx2)
    ey2 = torch.maximum(ay2, by2)
    enc = torch.clamp((ex2 - ex1) * (ey2 - ey1), min=1e-9)
    return iou - (enc - union) / enc


def _assign(points, gt_boxes, gt_mask, topk=9):
    """Center-prior top-k assigner: for each gt, the topk anchors (by center
    distance; ties to the lower index) whose centers lie inside the gt
    box. (N, M, 4), (N, M) -> per-anchor (matched_gt_idx, assigned_mask),
    each (N, L)."""
    px, py = points[:, 0], points[:, 1]                     # (L,)
    x1, y1, x2, y2 = (gt_boxes[..., i] for i in range(4))   # (N, M)
    inside = ((px[None, None, :] >= x1[..., None]) &
              (px[None, None, :] <= x2[..., None]) &
              (py[None, None, :] >= y1[..., None]) &
              (py[None, None, :] <= y2[..., None]))         # (N, M, L)
    cx = (x1 + x2) / 2
    cy = (y1 + y2) / 2
    d = torch.sqrt((px[None, None, :] - cx[..., None]) ** 2 +
                   (py[None, None, :] - cy[..., None]) ** 2)
    d = torch.where(inside & gt_mask[..., None], d,
                    torch.full_like(d, 1e9))
    L = points.shape[0]
    k = min(topk, L)
    top_idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]  # (N,M,k)
    sel = TF.one_hot(top_idx, L).sum(dim=2) > 0             # (N, M, L)
    sel = sel & inside & gt_mask[..., None]
    # anchor claimed by the nearest selecting gt
    d_sel = torch.where(sel, d, torch.full_like(d, 1e9))
    matched = torch.argmin(d_sel, dim=1)                    # (N, L)
    assigned = sel.any(dim=1)                               # (N, L)
    return matched, assigned


def _raw_on(v, dev):
    t = v._data if isinstance(v, Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(dev)


def ppyoloe_loss(model, images, gt_boxes, gt_class, gt_mask,
                 cls_weight=1.0, iou_weight=2.5, dfl_weight=0.5):
    """Training loss: varifocal cls + GIoU + DFL, static shapes.

    gt_boxes: (N, M, 4) xyxy pixels; gt_class: (N, M) int; gt_mask: (N, M).
    Recorded through the head outputs, so `.backward()` and the functional
    step both work."""
    cls_t, reg_t = model(images)
    H, W = images.shape[2], images.shape[3]
    dev = cls_t._data.device
    points, strides = (t.to(dev) for t in model.anchor_points((H, W)))
    cfg = model.cfg
    gt_boxes_r = _raw_on(gt_boxes, dev)
    gt_class_r = _raw_on(gt_class, dev)
    gt_mask_r = _raw_on(gt_mask, dev).to(torch.bool)
    return apply_op(
        lambda c, r: _ppyoloe_loss_raw(
            c, r, points, strides, cfg, gt_boxes_r, gt_class_r, gt_mask_r,
            cls_weight, iou_weight, dfl_weight),
        cls_t, reg_t, name="ppyoloe_loss")


def _ppyoloe_loss_raw(cls_logits, reg, points, strides, cfg, gt_boxes,
                      gt_class, gt_mask, cls_weight, iou_weight, dfl_weight):
    matched, assigned = _assign(points, gt_boxes, gt_mask)
    N, L = matched.shape
    bidx = torch.arange(N, device=matched.device)[:, None]
    tgt_boxes = gt_boxes[bidx, matched].to(torch.float32)   # (N, L, 4)
    tgt_class = gt_class[bidx, matched].to(torch.int64)     # (N, L)

    pred_boxes = _decode_boxes(reg, points, strides, cfg.reg_max)
    giou = _giou(pred_boxes, tgt_boxes)
    iou_detached = torch.clamp((giou.detach() + 1) / 2, 0, 1)

    # varifocal: IoU-aware soft targets on positives, focal down-weighted
    # negatives
    q = torch.where(assigned[..., None],
                    TF.one_hot(tgt_class, cfg.num_classes).to(torch.float32)
                    * iou_detached[..., None],
                    torch.zeros((), device=reg.device))
    p = torch.sigmoid(cls_logits)
    alpha, gamma = 0.75, 2.0
    weight = torch.where(q > 0, q, alpha * p ** gamma)
    bce = -(q * TF.logsigmoid(cls_logits) +
            (1 - q) * TF.logsigmoid(-cls_logits))
    n_pos = torch.clamp(assigned.sum(), min=1).to(torch.float32)
    cls_loss = (weight * bce).sum() / n_pos

    iou_loss = torch.where(assigned, 1.0 - giou,
                           torch.zeros((), device=reg.device)).sum() / n_pos

    # DFL: cross-entropy between the distance distribution and the two
    # integer bins bracketing the target distance
    lt = torch.stack([points[None, :, 0] - tgt_boxes[..., 0],
                      points[None, :, 1] - tgt_boxes[..., 1],
                      tgt_boxes[..., 2] - points[None, :, 0],
                      tgt_boxes[..., 3] - points[None, :, 1]], dim=-1)
    tgt_dist = torch.clamp(lt / strides[None, :, None], 0,
                           cfg.reg_max - 0.01)
    tl = torch.floor(tgt_dist)
    wr = tgt_dist - tl
    logits = reg.reshape(N, L, 4, cfg.reg_max + 1)
    logp = torch.log_softmax(logits, dim=-1)
    til = tl.to(torch.int64)
    oh_l = TF.one_hot(til, cfg.reg_max + 1).to(logp.dtype)
    oh_r = TF.one_hot(til + 1, cfg.reg_max + 1).to(logp.dtype)
    dfl = -(oh_l * logp).sum(-1) * (1 - wr) - (oh_r * logp).sum(-1) * wr
    dfl_loss = torch.where(assigned[..., None], dfl,
                           torch.zeros((), device=reg.device)).sum() \
        / (n_pos * 4)

    return (cls_weight * cls_loss + iou_weight * iou_loss +
            dfl_weight * dfl_loss)


def ppyoloe_crn_tiny(num_classes=80, **kw):
    return PPYOLOE(PPYOLOEConfig(num_classes=num_classes, width_mult=0.25,
                                 depth_mult=0.33, **kw))


def ppyoloe_s(num_classes=80, **kw):
    return PPYOLOE(PPYOLOEConfig(num_classes=num_classes, width_mult=0.5,
                                 depth_mult=0.33, **kw))
