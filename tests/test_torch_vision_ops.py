"""The port's `vision.ops` against the JAX package's, on the CPU.

Every op runs in both packages on the same seeded numpy inputs; values
within 1e-5 (1e-4 for the products of deform_conv2d and the reductions
of yolo_loss), index results exact. Gradients where the reference's flow
(roi_align to the map and the boxes; deform_conv2d to the input,
offsets, weight, bias and mask), under a seeded cotangent. yolo_loss is
host numpy in the reference, with no gradient; the port's is torch, and
its gradient is held to central differences of the port's own loss.
Then `tests/test_vision_ops.py`'s checks on the port.
"""
import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as T


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield pt


def jops():
    import paddle_tpu as pj
    from paddle_tpu.vision import ops as J
    return pj, J


def host(x):
    if isinstance(x, (list, tuple)):
        return [host(v) for v in x]
    if x is None:
        return None
    a = np.asarray(x.numpy() if hasattr(x, "numpy") else x)
    return a.astype(np.int64) if a.dtype.kind in "iu" else a


def same(got, want, tol=1e-5, what=""):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, tol, f"{what}[{i}]")
        return
    if want is None:
        assert got is None, what
        return
    g, w = host(got), host(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)


def rand_boxes(rng, n, size, lo=1.0):
    xy = rng.uniform(0, size * 0.6, (n, 2))
    wh = rng.uniform(lo, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def run_grad(P, fn, arrays, diff):
    """fn(P, *tensors) with the float inputs in `diff` trainable; returns
    (outputs, their input gradients under a seeded cotangent)."""
    ts = [P.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    out = fn(P, *ts)
    w = np.random.RandomState(5).uniform(0.5, 1.5, out.shape).astype(
        np.float32)
    (out * P.to_tensor(w)).sum().backward()
    return host(out), [host(ts[i].grad) for i in diff]


# ---------------------------------------------------------------- roi_align

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sampling", [-1, 3])
def test_roi_align_values_and_grads_match_jax(aligned, sampling):
    pj, J = jops()
    rng = np.random.RandomState(1)
    x = rng.rand(2, 3, 10, 12).astype(np.float32)
    boxes = rand_boxes(rng, 5, 10, lo=0.5)
    boxes[0] = [-1.5, -0.5, 4.0, 11.5]          # off the map's edges

    def fn(P, xt, bt):
        ops = J if P is pj else T
        return ops.roi_align(xt, bt, boxes_num=np.asarray([2, 3]),
                             output_size=(3, 2), spatial_scale=0.9,
                             sampling_ratio=sampling, aligned=aligned)
    got = run_grad(pt, fn, [x, boxes], [0, 1])
    want = run_grad(pj, fn, [x, boxes], [0, 1])
    same(got[0], want[0], what="roi_align")
    same(got[1][0], want[1][0], 1e-4, "d map")
    same(got[1][1], want[1][1], 1e-4, "d boxes")
    layer = T.RoIAlign(2, 0.5)
    same(layer(pt.to_tensor(x), pt.to_tensor(boxes), [2, 3]),
         J.RoIAlign(2, 0.5)(pj.to_tensor(x), pj.to_tensor(boxes), [2, 3]),
         what="RoIAlign")


# --------------------------------------------------------- host-side pools

def test_roi_pool_and_psroi_pool_match_jax():
    pj, J = jops()
    rng = np.random.RandomState(2)
    x = rng.rand(2, 8, 9, 9).astype(np.float32)
    boxes = rand_boxes(rng, 4, 9)
    out = {}
    for P, ops in ((pt, T), (pj, J)):
        xt, bt = P.to_tensor(x), P.to_tensor(boxes)
        out[P] = [ops.roi_pool(xt, bt, [1, 3], output_size=(2, 3),
                               spatial_scale=0.8),
                  ops.roi_pool(x, boxes, None, 2),
                  ops.RoIPool(3)(xt, bt, [2, 2]),
                  ops.psroi_pool(xt, bt, [2, 2], 2, spatial_scale=0.7),
                  ops.PSRoIPool(2)(xt, bt, [3, 1])]
    same(out[pt], out[pj], what="pools")
    assert isinstance(out[pt][0], pt.Tensor)
    assert isinstance(out[pt][1], np.ndarray)


# ---------------------------------------------------------------------- nms

@pytest.mark.parametrize("case", ["plain", "scores", "categories", "top_k",
                                  "tensor"])
def test_nms_matches_jax(case):
    pj, J = jops()
    rng = np.random.RandomState(3)
    boxes = rand_boxes(rng, 30, 40)
    scores = rng.rand(30).astype(np.float32)
    cats = rng.randint(0, 3, 30)
    kw = {"plain": dict(), "scores": dict(scores=scores),
          "categories": dict(scores=scores, category_idxs=cats,
                             categories=[0, 1, 2]),
          "top_k": dict(scores=scores, top_k=5),
          "tensor": dict(scores=scores)}[case]
    out = {}
    for P, ops in ((pt, T), (pj, J)):
        b = P.to_tensor(boxes) if case == "tensor" else boxes
        out[P] = ops.nms(b, 0.3, **kw)
    same(out[pt], out[pj], what=case)
    assert isinstance(out[pt], pt.Tensor) == (case == "tensor")


def test_matrix_nms_matches_jax():
    pj, J = jops()
    rng = np.random.RandomState(4)
    bb = np.stack([rand_boxes(rng, 12, 1.0, lo=0.05) for _ in range(2)])
    sc = rng.rand(2, 3, 12).astype(np.float32)
    for kw in (dict(), dict(use_gaussian=True, gaussian_sigma=0.5),
               dict(normalized=False, background_label=-1),
               dict(return_index=True), dict(return_index=True,
                                             return_rois_num=False),
               dict(return_rois_num=False)):
        args = (0.1, 0.05, 8, 6)
        got = T.matrix_nms(pt.to_tensor(bb), pt.to_tensor(sc), *args, **kw)
        want = J.matrix_nms(pj.to_tensor(bb), pj.to_tensor(sc), *args, **kw)
        same(got, want, what=str(kw))


def test_distribute_fpn_and_generate_proposals_match_jax():
    pj, J = jops()
    rng = np.random.RandomState(5)
    rois = np.concatenate([rand_boxes(rng, 6, 600), rand_boxes(rng, 2, 30)])
    N, A, H, W = 2, 3, 4, 5
    scores = rng.rand(N, A, H, W).astype(np.float32)
    deltas = rng.normal(0, 0.3, (N, 4 * A, H, W)).astype(np.float32)
    anchors = rand_boxes(rng, H * W * A, 64)
    var = np.full((H * W * A, 4), 0.5, np.float32)
    img = np.asarray([[64, 64], [48, 56]], np.float32)
    out = {}
    for P, ops in ((pt, T), (pj, J)):
        multi, restore, none = ops.distribute_fpn_proposals(
            P.to_tensor(rois), 2, 5, 4, 224, pixel_offset=True)
        assert none is None
        r = [multi, restore]
        for kw in (dict(), dict(pixel_offset=True, return_rois_num=True,
                                post_nms_top_n=5, min_size=2.0)):
            r.append(ops.generate_proposals(
                P.to_tensor(scores), P.to_tensor(deltas), P.to_tensor(img),
                P.to_tensor(anchors), P.to_tensor(var), pre_nms_top_n=40,
                **kw))
        out[P] = r
    same(out[pt], out[pj], what="fpn/proposals")


# -------------------------------------------------------- priors, coders

def test_prior_box_matches_jax():
    pj, J = jops()
    feat = np.zeros((1, 4, 3, 5), np.float32)
    img = np.zeros((1, 3, 30, 50), np.float32)
    for kw in (dict(min_sizes=[4.0]),
               dict(min_sizes=[4.0, 8.0], max_sizes=[9.0, 16.0],
                    aspect_ratios=[1.0, 2.0], flip=True, clip=True),
               dict(min_sizes=[6.0], max_sizes=[12.0],
                    aspect_ratios=[3.0], min_max_aspect_ratios_order=True,
                    steps=(8.0, 9.0), offset=0.3)):
        got = T.prior_box(pt.to_tensor(feat), pt.to_tensor(img), **kw)
        want = J.prior_box(pj.to_tensor(feat), pj.to_tensor(img), **kw)
        same(got, want, what=str(kw))


@pytest.mark.parametrize("code", ["encode_center_size",
                                  "decode_center_size"])
@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_matches_jax(code, normalized, axis):
    pj, J = jops()
    rng = np.random.RandomState(6)
    prior = rand_boxes(rng, 4, 20)
    pvar = rng.uniform(0.1, 0.3, (4, 4)).astype(np.float32)
    if code == "encode_center_size":
        target = rand_boxes(rng, 3, 20) if axis == 0 else \
            rand_boxes(rng, 4, 20)
        target = np.repeat(target[:, None], 4 if axis == 0 else 3, 1)
    else:
        target = rng.normal(0, 0.2, (3, 4, 4)).astype(np.float32) \
            if axis == 0 else rng.normal(0, 0.2, (4, 3, 4)).astype(
                np.float32)
    for var in (pvar, [0.1, 0.1, 0.2, 0.2], None):
        def fn(P, pb, tb):
            ops = J if P is pj else T
            return ops.box_coder(pb, var, tb, code_type=code,
                                 box_normalized=normalized, axis=axis)
        got = run_grad(pt, fn, [prior, target], [0, 1])
        want = run_grad(pj, fn, [prior, target], [0, 1])
        same(got[0], want[0], what=f"{code} {var is None}")
        same(got[1], want[1], 1e-4, "grads")


# --------------------------------------------------------------- yolo_box

@pytest.mark.parametrize("kw", [dict(), dict(clip_bbox=False),
                                dict(scale_x_y=1.2, conf_thresh=0.5)])
def test_yolo_box_matches_jax(kw):
    pj, J = jops()
    rng = np.random.RandomState(7)
    x = rng.normal(0, 1, (2, 2 * (5 + 3), 3, 4)).astype(np.float32)
    img = np.asarray([[64, 96], [80, 80]], np.int32)
    got = T.yolo_box(pt.to_tensor(x), pt.to_tensor(img), [10, 13, 16, 30],
                     3, downsample_ratio=16, **kw)
    want = J.yolo_box(pj.to_tensor(x), pj.to_tensor(img), [10, 13, 16, 30],
                      3, downsample_ratio=16, **kw)
    same(got, want, what=str(kw))
    raw = T.yolo_box(x, img, [10, 13, 16, 30], 3, downsample_ratio=16, **kw)
    same(raw, want, what="raw")


# ---------------------------------------------------------- deform_conv2d

@pytest.mark.parametrize("case", ["v1", "v2_bias", "stride_pad_dil"])
def test_deform_conv2d_values_and_grads_match_jax(case):
    pj, J = jops()
    rng = np.random.RandomState(8)
    stride, pad, dil = (2, 1, 2) if case == "stride_pad_dil" else (1, 1, 1)
    x = rng.rand(2, 3, 7, 7).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32)
    Ho = (7 + 2 * pad - dil * 2 - 1) // stride + 1
    off = rng.normal(0, 0.8, (2, 18, Ho, Ho)).astype(np.float32)
    arrays, diff = [x, off, w], [0, 1, 2]
    if case == "v2_bias":
        arrays += [rng.rand(4).astype(np.float32),
                   rng.rand(2, 9, Ho, Ho).astype(np.float32)]
        diff += [3, 4]

    def fn(P, xt, ot, wt, *rest):
        ops = J if P is pj else T
        b = rest[0] if rest else None
        m = rest[1] if rest else None
        return ops.deform_conv2d(xt, ot, wt, b, stride=stride, padding=pad,
                                 dilation=dil, mask=m)
    got = run_grad(pt, fn, arrays, diff)
    want = run_grad(pj, fn, arrays, diff)
    same(got[0], want[0], 1e-4, "out")
    for i, (g, wnt) in enumerate(zip(got[1], want[1])):
        same(g, wnt, 1e-4, f"grad {diff[i]}")
    with pytest.raises(NotImplementedError):
        T.deform_conv2d(pt.to_tensor(x), pt.to_tensor(off), pt.to_tensor(w),
                        groups=2)


def test_deform_conv_layer_matches_jax():
    pj, J = jops()
    t, j = T.DeformConv2D(2, 3, 3, padding=1), J.DeformConv2D(2, 3, 3,
                                                               padding=1)
    assert [(k, tuple(v.shape)) for k, v in t.state_dict().items()] == \
        [(k, tuple(v.shape)) for k, v in j.state_dict().items()]
    bound = 1 / np.sqrt(2 * 9)
    assert np.abs(t.weight.numpy()).max() <= bound
    assert not t.bias.numpy().any()
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    rng = np.random.RandomState(9)
    x = rng.rand(1, 2, 5, 5).astype(np.float32)
    off = rng.normal(0, 0.5, (1, 18, 5, 5)).astype(np.float32)
    same(t(pt.to_tensor(x), pt.to_tensor(off)),
         j(pj.to_tensor(x), pj.to_tensor(off)), 1e-4)
    assert T.DeformConv2D(2, 3, 3, bias_attr=False).bias is None


# --------------------------------------------------------------- yolo_loss

def _yolo_inputs(seed=10):
    rng = np.random.RandomState(seed)
    A, C, H, W = 3, 4, 4, 4
    x = rng.normal(0, 0.5, (2, A * (5 + C), H, W)).astype(np.float32)
    gt_box = np.asarray([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.2, 0.5, 0.4],
                          [0.5, 0.5, 0.0, 0.0]],
                         [[0.55, 0.6, 0.1, 0.15], [0.1, 0.9, 0.3, 0.2],
                          [0.8, 0.8, 0.9, 0.9]]], np.float32)
    gt_label = rng.randint(0, C, (2, 3))
    gt_score = rng.uniform(0.5, 1.0, (2, 3)).astype(np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    return x, gt_box, gt_label, gt_score, anchors, C


@pytest.mark.parametrize("kw", [dict(), dict(use_label_smooth=False),
                                dict(gt_score=True, ignore_thresh=0.3)])
def test_yolo_loss_matches_jax(kw):
    pj, J = jops()
    x, gb, gl, gs, anchors, C = _yolo_inputs()
    kw = dict(kw)
    score = gs if kw.pop("gt_score", False) else None
    thresh = kw.pop("ignore_thresh", 0.7)
    for mask in ([3, 4, 5], [0, 1, 2]):
        got = T.yolo_loss(pt.to_tensor(x), gb, gl, anchors, mask, C, thresh,
                          8, gt_score=score, **kw)
        want = J.yolo_loss(pj.to_tensor(x), gb, gl, anchors, mask, C,
                           thresh, 8, gt_score=score, **kw)
        same(got, want, 1e-4, f"mask {mask}")
        assert float(host(got).sum()) > 0


def test_yolo_loss_gradient_is_its_derivative():
    """The port's yolo_loss is differentiable in the head's map: its
    gradient against central differences of the port's own loss along
    three seeded directions (float32, step 1e-2: relative 2e-2)."""
    x, gb, gl, gs, anchors, C = _yolo_inputs()
    xt = pt.to_tensor(x, stop_gradient=False)
    loss = T.yolo_loss(xt, gb, gl, anchors, [0, 1, 2], C, 0.7, 8,
                       gt_score=gs).sum()
    loss.backward()
    g = xt.grad.numpy()
    assert np.abs(g).max() > 0
    rng = np.random.RandomState(11)

    def value(a):
        return float(T.yolo_loss(pt.to_tensor(a), gb, gl, anchors,
                                 [0, 1, 2], C, 0.7, 8, gt_score=gs).sum())
    for _ in range(3):
        v = rng.normal(0, 1, x.shape).astype(np.float32)
        eps = 1e-2
        fd = (value(x + eps * v) - value(x - eps * v)) / (2 * eps)
        np.testing.assert_allclose(float((g * v).sum()), fd, rtol=2e-2)


# -------------------------------------------------------------- file ops

def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    pj, J = jops()
    rng = np.random.RandomState(12)
    arr = (rng.rand(6, 5, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "a.jpg")
    Image.fromarray(arr).save(path)
    data = T.read_file(path)
    np.testing.assert_array_equal(data.numpy(),
                                  np.asarray(J.read_file(path).numpy()))
    for mode in ("unchanged", "rgb", "gray"):
        same(T.decode_jpeg(data, mode=mode),
             J.decode_jpeg(J.read_file(path), mode=mode), what=mode)
    assert T.decode_jpeg(data).shape == [3, 6, 5]


# ------------------------------------------------------- the oracle's checks

def test_vision_ops_oracle_checks():
    """`tests/test_vision_ops.py`'s checks on the port."""
    import torch
    x = pt.to_tensor(np.full((1, 2, 8, 8), 3.0, np.float32))
    b = pt.to_tensor(np.asarray([[0., 0., 7., 7.]], np.float32))
    out = T.roi_align(x, b, boxes_num=[1], output_size=4)
    assert out.shape == [1, 2, 4, 4]
    np.testing.assert_allclose(out.numpy(), 3.0, rtol=1e-6)
    ramp = np.tile(np.arange(8, dtype=np.float32), (8, 1))
    out = T.roi_align(pt.to_tensor(ramp[None, None]),
                      pt.to_tensor(np.asarray([[0., 0., 8., 8.]],
                                              np.float32)),
                      boxes_num=[1], output_size=2).numpy()[0, 0]
    assert out[0, 0] < out[0, 1]
    np.testing.assert_allclose(out[:, 1] - out[:, 0], 4.0, atol=0.2)
    xs = np.zeros((2, 1, 4, 4), np.float32)
    xs[0], xs[1] = 1.0, 9.0
    out = T.roi_align(pt.to_tensor(xs), pt.to_tensor(np.asarray(
        [[0, 0, 3, 3], [0, 0, 3, 3]], np.float32)), boxes_num=[1, 1]).numpy()
    np.testing.assert_allclose(out[:, 0, 0, 0], [1.0, 9.0], atol=1e-5)
    spike = np.zeros((1, 1, 8, 8), np.float32)
    spike[0, 0, 2, 2] = 7.0
    assert T.roi_pool(pt.to_tensor(spike), b, [1], 2).numpy().max() > 5.0
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]],
                       np.float32)
    np.testing.assert_array_equal(
        np.sort(T.nms(boxes, 0.5, np.asarray([0.9, 0.8, 0.7], np.float32))),
        [0, 2])
    assert len(T.nms(boxes[:2], 0.5, np.asarray([0.9, 0.8], np.float32),
                     category_idxs=np.asarray([0, 1]),
                     categories=[0, 1])) == 2
    rng = np.random.RandomState(0)
    xc = rng.rand(2, 3, 8, 8).astype(np.float32)
    w = rng.rand(4, 3, 3, 3).astype(np.float32)
    out = T.deform_conv2d(pt.to_tensor(xc), pt.to_tensor(
        np.zeros((2, 18, 6, 6), np.float32)), pt.to_tensor(w)).numpy()
    want = torch.nn.functional.conv2d(torch.from_numpy(xc),
                                      torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    layer = T.DeformConv2D(2, 3, 3)
    o = layer(pt.to_tensor(xc[:1, :2, :6, :6]),
              pt.to_tensor(np.zeros((1, 18, 4, 4), np.float32)))
    (o * o).sum().backward()
    assert o.shape == [1, 3, 4, 4] and layer.weight.grad is not None
    xy = np.zeros((1, 16, 2, 2), np.float32)
    xy[:, 4] = 5.0
    bx, sc = T.yolo_box(pt.to_tensor(xy), pt.to_tensor(np.asarray(
        [[64, 64]], np.int32)), anchors=[10, 13, 16, 30], class_num=3,
        downsample_ratio=32)
    assert bx.shape == [1, 8, 4] and sc.shape == [1, 8, 3]
    assert (bx.numpy() >= 0).all() and (bx.numpy() <= 64).all()
