"""The functional table: every `nn.functional` of the port held against
the JAX package's on the same seeded numpy inputs, values and (for float
inputs) gradients under a seeded cotangent, on the CPU.

Tolerances (rtol = atol): f32 elementwise 1e-5, products and reductions
1e-4, bf16 2e-2; integer, bool and index results exact. Dtypes compare
through ROADMAP C.14's width map (port int64 = JAX int32).

The random functionals (dropout in training, rrelu, gumbel_softmax,
alpha_dropout) are held by their contract in `test_random_functionals`;
their deterministic modes are in the table. `FN_TABLE` is also run on
CUDA against the port on the CPU by `chip_smoke.py` phase 22 (d), so its
makers and functions take the package as an argument and import nothing
of JAX.
"""
import numpy as np
import pytest

from test_torch_tensor_ops import (B, Case, F, I, K, Pos, compare, host,
                                   run_case)

EW, RED, BF16 = 1e-5, 1e-4, 2e-2


def f(name, *args, **kw):
    """fn(P, *tensors) calling P.nn.functional.<name>."""
    return lambda P, *ts: getattr(P.nn.functional, name)(*ts, *args, **kw)


def C(id, fn, makers, **kw):
    kw.setdefault("tol", EW)
    return Case(id, fn, makers, **kw)


def bf16(name, *args, **kw):
    """The functional on bfloat16 copies of the float inputs."""
    def fn(P, *ts):
        ts = [t.astype("bfloat16") if "float" in str(t.dtype) else t
              for t in ts]
        return getattr(P.nn.functional, name)(*ts, *args, **kw)
    return fn


def unpool(dim):
    def fn(P, x):
        Fn = P.nn.functional
        out, idx = getattr(Fn, f"max_pool{dim}d")(x, 2, return_mask=True)
        return getattr(Fn, f"max_unpool{dim}d")(out, idx, 2)
    return fn


def _csr():
    off = np.array([0, 2, 4, 5, 7], np.int64)
    cols = np.array([0, 1, 0, 2, 2, 1, 3], np.int64)
    return (K(np.broadcast_to(off, (1, 2, 5)).copy()),
            K(np.broadcast_to(cols, (1, 2, 7)).copy()))


_ACT = [
    ("relu", (), {}), ("relu6", (), {}), ("gelu", (), {}),
    ("gelu_tanh", (True,), {}), ("silu", (), {}), ("swish", (), {}),
    ("sigmoid", (), {}), ("log_sigmoid", (), {}), ("tanh", (), {}),
    ("softmax", (), {}), ("softmax_axis0", (0,), {}),
    ("log_softmax", (), {}), ("leaky_relu", (0.1,), {}),
    ("elu", (0.5,), {}), ("selu", (), {}), ("celu", (0.7,), {}),
    ("hardswish", (), {}), ("hardsigmoid", (), {}),
    ("hardtanh", (-0.5, 0.7), {}), ("hardshrink", (0.7,), {}),
    ("softshrink", (0.7,), {}), ("tanhshrink", (), {}),
    ("softplus", (2.0, 3.0), {}), ("softsign", (), {}), ("mish", (), {}),
    ("glu", (), {}), ("thresholded_relu", (0.5,), {}),
    ("maxout", (2,), {}),
]


def _act_cases():
    out = []
    for cid, args, kw in _ACT:
        name = cid.split("_axis")[0].replace("gelu_tanh", "gelu")
        maker = F(2, 4, 3, 6, lo=-4.0, hi=8.0) if cid in (
            "relu6", "hardswish", "hardsigmoid") else F(2, 4, 3, 6, lo=-2,
                                                      hi=2)
        out.append(C(f"act_{cid}", f(name, *args, **kw), [maker]))
    return out


_PAD_CASES = [
    ("pad_const_nchw", [1, 2, 0, 1], "constant", "NCHW", F(1, 2, 4, 5)),
    ("pad_reflect_nchw", [1, 2, 2, 1], "reflect", "NCHW", F(1, 2, 4, 5)),
    ("pad_replicate_nchw", [1, 0, 2, 1], "replicate", "NCHW",
     F(1, 2, 4, 5)),
    ("pad_circular_nchw", [2, 1, 1, 0], "circular", "NCHW", F(1, 2, 4, 5)),
    ("pad_const_nhwc", [1, 2, 0, 1], "constant", "NHWC", F(1, 4, 5, 2)),
    ("pad_full_rank", [0, 0, 1, 0, 2, 1], "constant", "NCHW", F(2, 3, 4)),
    ("pad_reflect_ncl", [2, 1], "reflect", "NCL", F(2, 3, 6)),
]

_INTERP = [
    ("nearest_size", dict(size=[6, 7]), F(1, 2, 4, 5)),
    ("nearest_scale", dict(scale_factor=2), F(1, 2, 3, 4)),
    ("nearest_align", dict(size=[7, 9], align_corners=True), F(1, 2, 4, 5)),
    ("bilinear", dict(size=[7, 9], mode="bilinear"), F(1, 2, 4, 5)),
    ("bilinear_align", dict(size=[7, 9], mode="bilinear",
                            align_corners=True), F(1, 2, 4, 5)),
    ("bilinear_mode1", dict(size=[7, 3], mode="bilinear", align_mode=1),
     F(1, 2, 4, 5)),
    ("bicubic", dict(size=[7, 9], mode="bicubic"), F(1, 2, 4, 5)),
    ("bicubic_align", dict(size=[3, 8], mode="bicubic", align_corners=True),
     F(1, 2, 4, 5)),
    ("linear_1d", dict(size=9, mode="linear", data_format="NCW"),
     F(2, 3, 5)),
    ("trilinear", dict(size=[3, 5, 4], mode="trilinear",
                       data_format="NCDHW"), F(1, 2, 2, 3, 4)),
    ("area_2d", dict(size=[3, 2], mode="area"), F(1, 2, 7, 5)),
    ("area_1d", dict(size=3, mode="area", data_format="NCW"), F(2, 3, 8)),
    ("nearest_nhwc", dict(size=[6, 3], data_format="NHWC"), F(1, 4, 5, 2)),
]

_CONV = [
    ("conv1d", "conv1d", dict(stride=2, padding=1), F(2, 4, 9), F(6, 4, 3)),
    ("conv2d", "conv2d", dict(padding=1), F(2, 3, 6, 5), F(4, 3, 3, 3)),
    ("conv2d_stride_dil", "conv2d", dict(stride=2, dilation=2, padding=2),
     F(1, 3, 9, 8), F(4, 3, 3, 3)),
    ("conv2d_pairs", "conv2d", dict(padding=[[0, 0], [0, 0], [1, 1],
                                             [2, 2]]),
     F(1, 2, 5, 5), F(3, 2, 3, 3)),
    ("conv2d_flat4", "conv2d", dict(padding=[1, 0, 2, 1]), F(1, 2, 5, 5),
     F(3, 2, 3, 3)),
    ("conv2d_same", "conv2d", dict(padding="SAME", stride=2),
     F(1, 2, 7, 6), F(3, 2, 3, 3)),
    ("conv2d_valid", "conv2d", dict(padding="VALID"), F(1, 2, 6, 6),
     F(3, 2, 3, 3)),
    ("conv2d_groups", "conv2d", dict(groups=2, padding=1), F(1, 4, 5, 5),
     F(6, 2, 3, 3)),
    ("conv2d_nhwc", "conv2d", dict(padding=1, data_format="NHWC"),
     F(1, 5, 6, 3), F(4, 3, 3, 3)),
    ("conv3d", "conv3d", dict(padding=1), F(1, 2, 4, 4, 3), F(3, 2, 3, 3, 3)),
    ("conv1d_transpose", "conv1d_transpose", dict(stride=2, padding=1),
     F(2, 4, 5), F(4, 3, 3)),
    ("conv2d_transpose", "conv2d_transpose", dict(stride=2, padding=1),
     F(1, 3, 4, 5), F(3, 2, 3, 3)),
    ("conv2d_transpose_outpad", "conv2d_transpose",
     dict(stride=2, padding=1, output_padding=1), F(1, 3, 4, 4),
     F(3, 2, 3, 3)),
    ("conv2d_transpose_groups_dil", "conv2d_transpose",
     dict(stride=2, groups=2, dilation=2), F(1, 4, 3, 3), F(4, 3, 3, 3)),
    ("conv3d_transpose", "conv3d_transpose", dict(stride=2), F(1, 2, 2, 3, 2),
     F(2, 3, 2, 2, 2)),
]

_POOL = [
    ("max_pool1d", "max_pool1d", (3, 2, 1), {}, F(2, 3, 9)),
    ("max_pool2d", "max_pool2d", (2,), {}, F(2, 3, 6, 4)),
    ("max_pool2d_pad_ceil", "max_pool2d", (3, 2, 1), dict(ceil_mode=True),
     F(1, 2, 7, 6)),
    ("max_pool2d_nhwc", "max_pool2d", (2, 2), dict(data_format="NHWC"),
     F(1, 6, 4, 3)),
    ("max_pool3d", "max_pool3d", (2,), {}, F(1, 2, 4, 4, 2)),
    ("avg_pool1d", "avg_pool1d", (3, 2, 1), {}, F(2, 3, 9)),
    ("avg_pool2d", "avg_pool2d", (2,), {}, F(2, 3, 6, 4)),
    ("avg_pool2d_excl_pad", "avg_pool2d", (3, 2, 1), {}, F(1, 2, 7, 6)),
    ("avg_pool2d_incl_pad", "avg_pool2d", (3, 2, 1), dict(exclusive=False),
     F(1, 2, 7, 6)),
    ("avg_pool2d_ceil", "avg_pool2d", (2, 2, 0), dict(ceil_mode=True),
     F(1, 2, 5, 5)),
    ("avg_pool2d_incl_ceil", "avg_pool2d", (3, 2, 1),
     dict(ceil_mode=True, exclusive=False), F(1, 2, 6, 6)),
    ("avg_pool3d", "avg_pool3d", (2,), {}, F(1, 2, 4, 4, 2)),
    ("adaptive_avg_pool1d", "adaptive_avg_pool1d", (4,), {}, F(2, 3, 10)),
    ("adaptive_max_pool1d", "adaptive_max_pool1d", (4,), {}, F(2, 3, 10)),
    ("adaptive_avg_pool2d", "adaptive_avg_pool2d", ([3, 2],), {},
     F(1, 2, 7, 5)),
    ("adaptive_avg_pool2d_even", "adaptive_avg_pool2d", (2,), {},
     F(1, 2, 4, 6)),
    ("adaptive_max_pool2d", "adaptive_max_pool2d", ([3, 2],), {},
     F(1, 2, 7, 5)),
    ("adaptive_avg_pool3d", "adaptive_avg_pool3d", ([2, 3, 2],), {},
     F(1, 2, 4, 5, 3)),
    ("adaptive_max_pool3d", "adaptive_max_pool3d", (2,), {},
     F(1, 2, 4, 4, 4)),
]

_CSR_OFF, _CSR_COLS = _csr()

FN_TABLE = (
    _act_cases()
    + [
        C("act_prelu_scalar", f("prelu"), [F(2, 3, 4), K([0.25], "float32")]),
        C("act_prelu_channel", f("prelu"), [F(2, 3, 4), F(3)]),
        C("act_softmax_bf16", bf16("softmax"), [F(3, 8)], tol=BF16),
        C("act_gelu_bf16", bf16("gelu"), [F(3, 8)], tol=BF16),
        C("rrelu_eval", f("rrelu", training=False), [F(3, 4)]),
        # ----------------------------------------------------------- common
        C("linear", f("linear"), [F(4, 6), F(6, 5), F(5)], tol=RED),
        C("linear_nobias", f("linear"), [F(2, 3, 6), F(6, 5)], tol=RED),
        C("linear_bf16", bf16("linear"), [F(4, 16), F(16, 8), F(8)],
          tol=BF16),
        C("embedding", f("embedding"), [I(3, 4, hi=7), F(7, 5)]),
        C("embedding_padding_idx", f("embedding", padding_idx=2),
          [I(3, 4, hi=7), F(7, 5)]),
        C("one_hot", f("one_hot", 6), [I(2, 3, hi=6)]),
        C("label_smooth", f("label_smooth", epsilon=0.2), [F(3, 5, lo=0)]),
        C("label_smooth_prior", lambda P, y, pd: P.nn.functional.label_smooth(
            y, prior_dist=pd, epsilon=0.1), [F(3, 5, lo=0), F(5, lo=0)]),
        C("dropout_eval", f("dropout", 0.5, training=False), [F(3, 4)]),
        C("dropout_eval_downscale", f("dropout", 0.25, training=False,
                                      mode="downscale_in_infer"), [F(3, 4)]),
        C("dropout_p0", f("dropout", 0.0), [F(3, 4)]),
        C("dropout2d_eval", f("dropout2d", 0.5, training=False),
          [F(1, 2, 3, 3)]),
        C("alpha_dropout_eval", f("alpha_dropout", 0.5, training=False),
          [F(3, 4)]),
    ]
    + [C(cid, f("pad", p, mode=m, data_format=df), [mk])
       for cid, p, m, df, mk in _PAD_CASES]
    + [C(f"interpolate_{cid}", f("interpolate", **kw), [mk], tol=RED)
       for cid, kw, mk in _INTERP]
    + [
        C("upsample", f("upsample", scale_factor=2, mode="bilinear"),
          [F(1, 1, 3, 3)], tol=RED),
        C("pixel_shuffle", f("pixel_shuffle", 2), [F(1, 8, 2, 3)]),
        C("pixel_shuffle_nhwc", f("pixel_shuffle", 2, data_format="NHWC"),
          [F(1, 2, 3, 8)]),
        C("pixel_unshuffle", f("pixel_unshuffle", 2), [F(1, 2, 4, 6)]),
        C("cosine_similarity", f("cosine_similarity"), [F(3, 5), F(3, 5)],
          tol=RED),
        C("bilinear", f("bilinear"), [F(3, 4), F(3, 5), F(2, 4, 5), F(2)],
          tol=RED),
        C("unfold", f("unfold", 3, strides=2, paddings=1, dilations=1),
          [F(1, 2, 6, 6)]),
        C("unfold_4pad_dil", f("unfold", [2, 3], paddings=[1, 0, 0, 2],
                               dilations=2), [F(1, 2, 6, 7)]),
        C("fold", f("fold", [5, 5], 2, strides=1), [F(1, 8, 16)], tol=RED),
        C("fold_stride_pad", f("fold", [6, 6], 3, strides=2, paddings=1),
          [F(1, 18, 9)], tol=RED),
        C("sequence_mask", f("sequence_mask", 6), [I(4, lo=0, hi=7)]),
        C("sequence_mask_auto", f("sequence_mask", dtype="float32"),
          [K([1, 4, 2], "int64")], jax_uncached=True),
        C("temporal_shift", f("temporal_shift", 2, 0.25), [F(4, 8, 2, 2)]),
        C("npair_loss", f("npair_loss"), [F(4, 6), F(4, 6),
                                          K([0, 1, 0, 2], "int64")],
          tol=RED),
        C("class_center_sample", f("class_center_sample", 10, 3),
          [K([1, 5, 5, 7, 2, 9], "int64")]),
        # ------------------------------------------------------------- norm
        C("batch_norm_eval", f("batch_norm"), [F(3, 4, 2, 2), F(4),
                                                Pos(4), Pos(4), F(4)],
          tol=RED),
        C("batch_norm_train", f("batch_norm", training=True),
          [F(3, 4, 2, 2), F(4), Pos(4), Pos(4), F(4)], tol=RED),
        C("batch_norm_nhwc_train", f("batch_norm", training=True,
                                     data_format="NHWC"),
          [F(3, 2, 2, 4), F(4), Pos(4)], tol=RED),
        C("layer_norm", lambda P, x, w, b: P.nn.functional.layer_norm(
            x, 6, w, b), [F(3, 6), Pos(6), F(6)], tol=RED),
        C("layer_norm_2d", lambda P, x, w, b: P.nn.functional.layer_norm(
            x, [4, 5], w, b), [F(3, 4, 5), Pos(4, 5), F(4, 5)], tol=RED),
        C("layer_norm_noaffine", f("layer_norm", 6), [F(3, 6)], tol=RED),
        C("layer_norm_weight_only", lambda P, x, w:
          P.nn.functional.layer_norm(x, 6, w), [F(3, 6), Pos(6)], tol=RED),
        C("layer_norm_bf16", lambda P, x, w, b: P.nn.functional.layer_norm(
            x.astype("bfloat16"), 16, w.astype("bfloat16"),
            b.astype("bfloat16")), [F(4, 16), Pos(16), F(16)], tol=BF16),
        C("group_norm", lambda P, x, w, b: P.nn.functional.group_norm(
            x, 2, weight=w, bias=b), [F(2, 4, 3, 3), Pos(4), F(4)], tol=RED),
        C("group_norm_nhwc", lambda P, x: P.nn.functional.group_norm(
            x, 2, data_format="NHWC"), [F(2, 3, 3, 4)], tol=RED),
        C("instance_norm", lambda P, x, w, b: P.nn.functional.instance_norm(
            x, weight=w, bias=b), [F(2, 3, 4, 4), Pos(3), F(3)], tol=RED),
        C("local_response_norm", f("local_response_norm", 3),
          [F(2, 5, 3, 3)], tol=RED),
        C("normalize", f("normalize"), [F(3, 5)], tol=RED),
        C("normalize_p1", f("normalize", p=1, axis=0), [F(3, 5)], tol=RED),
        # ------------------------------------------------------------- loss
        C("cross_entropy", f("cross_entropy"), [F(6, 5), I(6, hi=5)],
          tol=RED),
        C("cross_entropy_n1_labels", f("cross_entropy"), [F(6, 5),
                                                          I(6, 1, hi=5)],
          tol=RED),
        C("cross_entropy_ignore", f("cross_entropy", ignore_index=1),
          [F(8, 5), K([1, 0, 3, 1, 4, 2, 1, 0], "int64")], tol=RED),
        C("cross_entropy_weight", lambda P, x, y, w:
          P.nn.functional.cross_entropy(x, y, weight=w, ignore_index=0),
          [F(8, 5), K([1, 0, 3, 1, 4, 2, 1, 0], "int64"), Pos(5)], tol=RED),
        C("cross_entropy_weight_sum", lambda P, x, y, w:
          P.nn.functional.cross_entropy(x, y, weight=w, reduction="sum"),
          [F(6, 5), I(6, hi=5), Pos(5)], tol=RED),
        C("cross_entropy_soft", f("cross_entropy", soft_label=True),
          [F(4, 5), F(4, 5, lo=0.0, hi=1.0)], tol=RED),
        C("cross_entropy_axis1", f("cross_entropy", axis=1,
                                   reduction="none"),
          [F(2, 5, 3), I(2, 1, 3, hi=5)], tol=RED),
        C("cross_entropy_nosoftmax", f("cross_entropy", use_softmax=False),
          [F(4, 5, lo=0.05, hi=1.0), I(4, hi=5)], tol=RED),
        C("cross_entropy_3d", f("cross_entropy"), [F(2, 3, 7), I(2, 3,
                                                                hi=7)],
          tol=RED),
        C("cross_entropy_bf16", bf16("cross_entropy"), [F(6, 16),
                                                        I(6, hi=16)],
          tol=BF16),
        C("softmax_with_cross_entropy",
          f("softmax_with_cross_entropy", return_softmax=True),
          [F(4, 5), I(4, 1, hi=5)], tol=RED),
        C("nll_loss", f("nll_loss"), [F(5, 4), I(5, hi=4)], tol=RED),
        C("nll_loss_weight", lambda P, x, y, w: P.nn.functional.nll_loss(
            x, y, weight=w, reduction="sum"), [F(5, 4), I(5, hi=4), Pos(4)],
          tol=RED),
        C("mse_loss", f("mse_loss"), [F(3, 4), F(3, 4)], tol=RED),
        C("l1_loss_sum", f("l1_loss", reduction="sum"), [F(3, 4), F(3, 4)],
          tol=RED),
        C("smooth_l1_loss", f("smooth_l1_loss"), [F(3, 4, lo=-2, hi=2),
                                                  F(3, 4)], tol=RED),
        C("smooth_l1_loss_delta", f("smooth_l1_loss", delta=0.5,
                                    reduction="none"),
          [F(3, 4, lo=-2, hi=2), F(3, 4)]),
        C("binary_cross_entropy", f("binary_cross_entropy"),
          [F(3, 4, lo=0.05, hi=0.95), F(3, 4, lo=0, hi=1)], tol=RED),
        C("binary_cross_entropy_weight", f("binary_cross_entropy"),
          [F(3, 4, lo=0.05, hi=0.95), F(3, 4, lo=0, hi=1), Pos(3, 4)],
          tol=RED),
        C("binary_cross_entropy_with_logits",
          f("binary_cross_entropy_with_logits"),
          [F(3, 4, lo=-3, hi=3), F(3, 4, lo=0, hi=1)], tol=RED),
        C("bce_with_logits_pos_weight", lambda P, z, y, w, pw:
          P.nn.functional.binary_cross_entropy_with_logits(
              z, y, weight=w, pos_weight=pw),
          [F(3, 4, lo=-3, hi=3), F(3, 4, lo=0, hi=1), Pos(3, 4), Pos(4)],
          tol=RED),
        C("kl_div", f("kl_div"), [F(3, 4), F(3, 4, lo=-0.2, hi=1)], tol=RED),
        C("kl_div_batchmean", f("kl_div", reduction="batchmean"),
          [F(3, 4), F(3, 4, lo=-0.2, hi=1)], tol=RED),
        C("margin_ranking_loss", f("margin_ranking_loss", margin=0.1),
          [F(6), F(6), K([1, -1, 1, 1, -1, -1], "float32")], tol=RED),
        C("hinge_embedding_loss", f("hinge_embedding_loss"),
          [F(6), K([1, -1, 1, 1, -1, -1], "float32")], tol=RED),
        C("cosine_embedding_loss", f("cosine_embedding_loss", margin=0.2),
          [F(4, 5), F(4, 5), K([1, -1, 1, -1], "int64")], tol=RED),
        C("triplet_margin_loss", f("triplet_margin_loss"),
          [F(4, 5), F(4, 5), F(4, 5)], tol=RED),
        C("triplet_margin_loss_swap_p1", f("triplet_margin_loss", p=1,
                                           swap=True, reduction="sum"),
          [F(4, 5), F(4, 5), F(4, 5)], tol=RED),
        C("log_loss", f("log_loss"), [F(4, 1, lo=0.05, hi=0.95),
                                      F(4, 1, lo=0, hi=1)]),
        C("square_error_cost", f("square_error_cost"), [F(3, 4), F(3, 4)]),
        C("sigmoid_focal_loss", f("sigmoid_focal_loss"),
          [F(4, 3, lo=-3, hi=3), F(4, 3, lo=0, hi=1)], tol=RED),
        C("sigmoid_focal_loss_norm", f("sigmoid_focal_loss",
                                       reduction="mean"),
          [F(4, 3, lo=-3, hi=3), F(4, 3, lo=0, hi=1), Pos(1)], tol=RED),
        C("poisson_nll_loss", f("poisson_nll_loss"), [F(3, 4), Pos(3, 4)],
          tol=RED),
        C("poisson_nll_loss_full", f("poisson_nll_loss", log_input=False,
                                     full=True),
          [Pos(3, 4), F(3, 4, lo=0.5, hi=3)], tol=RED),
        C("gaussian_nll_loss", f("gaussian_nll_loss", full=True),
          [F(3, 4), F(3, 4), Pos(3, 4)], tol=RED),
        C("teacher_student_sigmoid_loss", f("teacher_student_sigmoid_loss",
                                            soft_max_up_bound=1.5,
                                            soft_max_lower_bound=-1.5),
          [F(6, 1, lo=-3, hi=3), K([[-2.0], [-1.0], [0.3], [1.7], [0.9],
                                    [1.2]], "float32")], tol=RED),
    ]
    + [C(cid, f(name, **kw), [x, w], tol=RED) for cid, name, kw, x, w in _CONV]
    + [C("conv2d_bias", f("conv2d", padding=1), [F(1, 2, 4, 4),
                                                  F(3, 2, 3, 3), F(3)],
         tol=RED),
       C("conv2d_transpose_bias", f("conv2d_transpose", stride=2),
         [F(1, 2, 3, 3), F(2, 3, 3, 3), F(3)], tol=RED)]
    + [C(cid, f(name, *args, **kw), [mk], tol=RED)
       for cid, name, args, kw, mk in _POOL]
    + [
        C("max_pool2d_mask", f("max_pool2d", 2, 2, 1, return_mask=True),
          [F(1, 2, 5, 5)]),
        C("max_pool1d_mask", f("max_pool1d", 3, 2, return_mask=True),
          [F(2, 2, 9)]),
        C("max_unpool1d", unpool(1), [F(1, 2, 8)]),
        C("max_unpool2d", unpool(2), [F(1, 2, 4, 6)]),
        C("max_unpool3d", unpool(3), [F(1, 1, 4, 4, 2)]),
        # ----------------------------------------------------------- extras
        C("channel_shuffle", f("channel_shuffle", 2), [F(1, 6, 2, 2)]),
        C("channel_shuffle_nhwc", f("channel_shuffle", 3,
                                    data_format="NHWC"), [F(1, 2, 2, 6)]),
        C("zeropad2d", f("zeropad2d", [1, 2, 0, 1]), [F(1, 2, 3, 3)]),
        C("diag_embed", f("diag_embed"), [F(2, 3)]),
        C("diag_embed_offset", f("diag_embed", offset=-1, dim1=0, dim2=2),
          [F(2, 3)]),
        C("soft_margin_loss", f("soft_margin_loss"),
          [F(3, 4), K(np.sign(np.arange(12) % 3 - 0.5).reshape(3, 4),
                      "float32")], tol=RED),
        C("multi_label_soft_margin_loss", f("multi_label_soft_margin_loss"),
          [F(3, 4), B(3, 4)], tol=RED),
        C("multi_label_soft_margin_loss_weight",
          lambda P, x, y, w: P.nn.functional.multi_label_soft_margin_loss(
              x, y, weight=w, reduction="sum"),
          [F(3, 4), K((np.arange(12) % 2).reshape(3, 4), "float32"),
           Pos(4)], tol=RED),
        C("dice_loss", f("dice_loss"), [F(2, 3, 4, lo=0, hi=1),
                                        I(2, 3, 1, hi=4)], tol=RED),
        C("pairwise_distance", f("pairwise_distance"), [F(3, 5), F(3, 5)],
          tol=RED),
        C("pairwise_distance_p1_keep", f("pairwise_distance", p=1.0,
                                         keepdim=True), [F(3, 5), F(3, 5)],
          tol=RED),
        C("triplet_margin_with_distance_loss",
          f("triplet_margin_with_distance_loss", swap=True),
          [F(4, 5), F(4, 5), F(4, 5)], tol=RED),
        C("hsigmoid_loss", lambda P, x, y, w, b:
          P.nn.functional.hsigmoid_loss(x, y, 6, w, bias=b),
          [F(4, 3), I(4, hi=6), F(5, 3), F(5)], tol=RED),
        C("margin_cross_entropy", f("margin_cross_entropy"),
          [F(4, 6, lo=-0.9, hi=0.9), I(4, hi=6)], tol=RED),
        C("margin_cross_entropy_softmax", f("margin_cross_entropy",
                                            margin2=0.3, scale=8.0,
                                            return_softmax=True,
                                            reduction="none"),
          [F(4, 6, lo=-0.9, hi=0.9), I(4, hi=6)], tol=RED),
        C("ctc_loss", f("ctc_loss"), [F(6, 2, 5), I(2, 3, lo=1, hi=5),
                                      K([6, 5], "int64"), K([3, 2],
                                                            "int64")],
          tol=RED),
        C("ctc_loss_sum", f("ctc_loss", reduction="sum"),
          [F(5, 3, 4), K([[1, 1, 2], [2, 3, 0], [3, 0, 0]], "int64"),
           K([5, 4, 3], "int64"), K([3, 2, 1], "int64")], tol=RED),
        C("ctc_loss_none_blank", f("ctc_loss", blank=4, reduction="none"),
          [F(5, 2, 5), I(2, 2, hi=4), K([5, 5], "int64"),
           K([2, 0], "int64")], tol=RED),
        C("affine_grid", f("affine_grid", [2, 1, 3, 4]), [F(2, 2, 3)],
          tol=RED),
        C("affine_grid_noalign", f("affine_grid", [1, 1, 4, 3],
                                   align_corners=False), [F(1, 2, 3)],
          tol=RED),
    ]
    + [C(f"grid_sample_{mode}_{pm}_{int(al)}",
         f("grid_sample", mode=mode, padding_mode=pm, align_corners=al),
         [F(1, 2, 4, 5), F(1, 3, 3, 2, lo=-1.3, hi=1.3)], tol=RED,
         grad=mode == "bilinear")
       for mode in ("bilinear", "nearest")
       for pm in ("zeros", "border", "reflection")
       for al in (True, False)]
    + [
        C("gather_tree", f("gather_tree"), [I(4, 2, 3, hi=9),
                                            I(4, 2, 3, hi=3)]),
        C("edit_distance", f("edit_distance"), [I(3, 5, hi=4),
                                                I(3, 4, hi=4)]),
        C("edit_distance_lengths", lambda P, h, r, hl, rl:
          P.nn.functional.edit_distance(h, r, normalized=False,
                                        input_length=hl, label_length=rl),
          [I(3, 5, hi=4), I(3, 4, hi=4), K([5, 3, 0], "int64"),
           K([4, 2, 3], "int64")]),
        C("ctc_greedy_decoder", f("ctc_greedy_decoder", 0), [F(2, 7, 4)]),
        C("ctc_greedy_decoder_lengths", lambda P, x, n:
          P.nn.functional.ctc_greedy_decoder(x, 0, input_length=n,
                                             padding_value=-1),
          [F(2, 7, 4), K([[7], [4]], "int64")]),
        C("sparse_attention", f("sparse_attention"),
          [F(1, 2, 4, 8), F(1, 2, 4, 8), F(1, 2, 4, 8), _CSR_OFF, _CSR_COLS],
          tol=RED),
        C("sparse_attention_masks", f("sparse_attention"),
          [F(1, 2, 4, 8), F(1, 2, 4, 8), F(1, 2, 4, 8), _CSR_OFF, _CSR_COLS,
           K([[1, 1, 0, 1]], "float32"), K(np.tril(np.ones((4, 4))),
                                            "float32")], tol=RED),
        C("scaled_dot_product_attention_small",
          f("scaled_dot_product_attention"),
          [F(2, 5, 2, 4), F(2, 5, 2, 4), F(2, 5, 2, 4)], tol=RED),
        C("scaled_dot_product_attention_causal_mask", lambda P, q, k, v, m:
          P.nn.functional.scaled_dot_product_attention(
              q, k, v, attn_mask=m, is_causal=True),
          [F(1, 6, 2, 4), F(1, 6, 2, 4), F(1, 6, 2, 4), F(6, 6)], tol=RED),
    ]
)


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def test_table_is_broad():
    import paddle_tpu_torch.nn.functional as Fn
    ids = [c.id for c in FN_TABLE]
    assert len(ids) == len(set(ids))
    names = set(Fn.__all__) if hasattr(Fn, "__all__") else {
        n for n in dir(Fn) if not n.startswith("_")}
    # every public functional appears in the table or in the random /
    # in-place tests below
    covered = " ".join(ids)
    elsewhere = {"dropout", "dropout2d", "dropout3d", "alpha_dropout",
                 "rrelu", "gumbel_softmax", "relu_", "tanh_", "elu_",
                 "softmax_", "upsample", "paddle_transpose_to_cf",
                 "paddle_transpose_to_cl"}
    missing = [n for n in names if callable(getattr(Fn, n))
               and not isinstance(getattr(Fn, n), type)
               and n not in elsewhere and n not in covered]
    assert not missing, missing


@pytest.mark.parametrize("case", FN_TABLE, ids=lambda c: c.id)
def test_functional_matches_jax(case, cpu):
    import paddle_tpu as pj
    pt = cpu
    arrays = case.inputs()
    grad = case.grad and any(a.dtype.kind == "f" for a in arrays)
    from paddle_tpu.core import tensor as jax_tensor
    cached = jax_tensor.eager_op_cache_enabled
    jax_tensor.eager_op_cache_enabled = cached and not case.jax_uncached
    try:
        want = run_case(pj, case, arrays, grad=grad)
    finally:
        jax_tensor.eager_op_cache_enabled = cached
    got = run_case(pt, case, arrays, grad=grad)
    compare_fn_runs(got, want, case, arrays)


def compare_fn_runs(got, want, case, arrays):
    """Two runs of one functional case (`run_case`'s outputs and input
    gradients): outputs as `compare` holds them, and every float input's
    gradient within the case's tolerance, a missing one counting as
    zeros."""
    compare([host(o) for o in got[0]], [host(o) for o in want[0]], case.tol,
            case.id)
    if got[1] is None and want[1] is None:
        return
    assert len(got[1]) == len(want[1]), case.id
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        if arrays[i].dtype.kind != "f":
            continue
        g = np.zeros_like(arrays[i]) if g is None else g.numpy()
        w = np.zeros_like(arrays[i]) if w is None else np.asarray(w.numpy())
        np.testing.assert_allclose(g, w, rtol=case.tol, atol=case.tol,
                                   err_msg=f"{case.id}: grad of input {i}")


# ------------------------------------------------- the random functionals

def _x(pt, shape=(64, 128)):
    return pt.to_tensor(np.random.RandomState(0).uniform(
        0.5, 1.5, shape).astype(np.float32))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_contract(cpu, mode):
    pt = cpu
    Fn = pt.nn.functional
    x = _x(pt)
    pt.seed(11)
    a = Fn.dropout(x, 0.3, mode=mode).numpy()
    pt.seed(11)
    b = Fn.dropout(x, 0.3, mode=mode).numpy()
    np.testing.assert_array_equal(a, b)            # same seed, same draw
    keep = a != 0
    assert abs(keep.mean() - 0.7) < 0.02
    scale = 1 / 0.7 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(a[keep], x.numpy()[keep] * scale, rtol=1e-6)
    assert Fn.dropout(x, 0.3, mode=mode).shape == x.shape
    c = Fn.dropout(x, 0.3, mode=mode).numpy()
    assert not np.array_equal(a, c)                # the stream moves on


def test_dropout_axis_and_2d(cpu):
    pt = cpu
    Fn = pt.nn.functional
    x = _x(pt, (8, 16, 4, 4))
    a = Fn.dropout(x, 0.5, axis=[0, 1]).numpy()
    per_channel = a.reshape(8, 16, -1)
    zero = (per_channel == 0).all(-1)
    assert ((per_channel != 0).all(-1) | zero).all()   # whole maps drop
    b = Fn.dropout2d(x, 0.5).numpy().reshape(8, 16, -1)
    assert ((b != 0).all(-1) | (b == 0).all(-1)).all()


def test_dropout_gradient_follows_the_mask(cpu):
    pt = cpu
    x = pt.to_tensor(np.ones((32, 32), np.float32), stop_gradient=False)
    y = pt.nn.functional.dropout(x, 0.25)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), y.numpy(), rtol=1e-6)


def test_rrelu_alpha_dropout_gumbel_contracts(cpu):
    pt = cpu
    Fn = pt.nn.functional
    x = pt.to_tensor(-np.ones((64, 64), np.float32))
    pt.seed(3)
    r = Fn.rrelu(x).numpy()
    assert (r <= -0.125 + 1e-7).all() and (r >= -1 / 3 - 1e-7).all()
    pt.seed(3)
    np.testing.assert_array_equal(Fn.rrelu(x).numpy(), r)
    a = Fn.alpha_dropout(_x(pt), 0.2).numpy()
    assert np.isfinite(a).all() and a.shape == (64, 128)
    g = Fn.gumbel_softmax(_x(pt, (16, 10)), temperature=0.5).numpy()
    np.testing.assert_allclose(g.sum(-1), 1.0, rtol=1e-5)
    h = Fn.gumbel_softmax(_x(pt, (16, 10)), hard=True).numpy()
    assert set(np.unique(h)) <= {0.0, 1.0} and (h.sum(-1) == 1).all()


@pytest.mark.parametrize("name", ["relu_", "tanh_", "elu_", "softmax_"])
def test_inplace_activations(cpu, name):
    import paddle_tpu as pj
    pt = cpu
    a = np.random.RandomState(5).uniform(-2, 2, (3, 4)).astype(np.float32)
    outs = []
    for P in (pj, pt):
        x = P.to_tensor(a)
        r = getattr(P.nn.functional, name)(x)
        assert r is x
        outs.append(x.numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=EW, atol=EW)
    p = pt.to_tensor(a, stop_gradient=False)
    with pytest.raises(RuntimeError):
        getattr(pt.nn.functional, name)(p)       # a trainable leaf


# --------------------------------------------------------- error messages

_ERRORS = [
    ("linear_in", lambda P, t: P.nn.functional.linear(t((4, 12)),
                                                      t((16, 32)))),
    ("linear_2d", lambda P, t: P.nn.functional.linear(t((4, 12)), t((12,)))),
    ("conv2d_channels", lambda P, t: P.nn.functional.conv2d(
        t((2, 4, 8, 8)), t((8, 3, 3, 3)))),
    ("conv2d_rank", lambda P, t: P.nn.functional.conv2d(t((4, 8, 8)),
                                                        t((8, 3, 3, 3)))),
    ("conv2d_groups", lambda P, t: P.nn.functional.conv2d(
        t((2, 4, 8, 8)), t((6, 3, 3, 3)), groups=2)),
    ("conv2d_transpose", lambda P, t: P.nn.functional.conv2d_transpose(
        t((2, 5, 8, 8)), t((6, 4, 3, 3)))),
    ("conv_nonzero_batch_pad", lambda P, t: P.nn.functional.conv2d(
        t((1, 2, 5, 5)), t((3, 2, 3, 3)),
        padding=[[1, 1], [0, 0], [2, 2], [3, 3]])),
    ("embedding", lambda P, t: P.nn.functional.embedding(
        P.to_tensor(np.zeros((4,), np.int64)), t((10,)))),
    ("dropout_p", lambda P, t: P.nn.functional.dropout(t((2,)), p=1.5)),
    ("dropout_mode", lambda P, t: P.nn.functional.dropout(t((2,)),
                                                          mode="bogus")),
    ("interpolate_none", lambda P, t: P.nn.functional.interpolate(
        t((1, 2, 4, 4)))),
    ("interpolate_rank", lambda P, t: P.nn.functional.interpolate(
        t((1, 2, 4)), size=[3], mode="bilinear")),
    ("pool_valid_ceil", lambda P, t: P.nn.functional.max_pool2d(
        t((1, 1, 4, 4)), 2, 2, "VALID", ceil_mode=True)),
    ("fold_positions", lambda P, t: P.nn.functional.fold(
        t((1, 8, 9)), [5, 5], 2)),
    ("unfold_stride", lambda P, t: P.nn.functional.unfold(
        t((1, 1, 4, 4)), 2, strides=0)),
    ("gain", lambda P, t: P.nn.initializer.calculate_gain("bogus")),
]


@pytest.mark.parametrize("case", _ERRORS, ids=[e[0] for e in _ERRORS])
def test_errors_match_jax(cpu, case):
    import paddle_tpu as pj
    pt = cpu
    _, fn = case
    msgs = []
    for P in (pj, pt):
        def t(shape, P=P):
            return P.to_tensor(np.zeros(shape, np.float32))
        with pytest.raises(Exception) as ei:
            fn(P, t)
        msgs.append((type(ei.value), str(ei.value).split("\n")[0]))
    assert msgs[0] == msgs[1]
