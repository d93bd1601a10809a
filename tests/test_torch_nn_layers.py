"""The port's `nn` Layers against the JAX package's, on the CPU.

The Layer table builds each Layer in both packages, asserts that their
`state_dict()` keys, shapes and order are equal, carries the JAX weights
across with `set_state_dict` (numpy arrays under the structured names),
and holds the forward outputs, the input gradients, the parameter
gradients and the buffers after the forward (BatchNorm's running
statistics) to the JAX Layer's under a seeded cotangent. Tolerances
(rtol = atol): 1e-5 elementwise, 1e-4 for products and reductions.

Then the Layer mechanics (registration rules, hooks, `functional_call`,
`set_state_dict`, casts, containers), `ParamAttr`, and the initializers,
which are held by their contract (same seed, same values; shape and
dtype; bounds and moments against the formula; paddle's [in, out] fans).
"""
import numpy as np
import pytest

from test_torch_tensor_ops import F, I, K, Pos, flat_outputs, host

EW, RED = 1e-5, 1e-4


class L:
    """One Layer case: ctor(P) -> layer; call(layer, *tensors) -> out."""

    def __init__(self, id, ctor, makers, call=None, tol=RED, train=True):
        self.id, self.ctor, self.makers = id, ctor, makers
        self.call = call or (lambda layer, *ts: layer(*ts))
        self.tol, self.train = tol, train

    def inputs(self):
        import zlib
        rng = np.random.RandomState(zlib.crc32(self.id.encode()))
        return [m(rng) for m in self.makers]


def nn(name, *args, **kw):
    return lambda P: getattr(P.nn, name)(*args, **kw)


_ACTS = ["ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Silu", "Swish",
         "Softmax", "LogSoftmax", "LeakyReLU", "ELU", "SELU", "CELU",
         "Hardswish", "Hardsigmoid", "Hardtanh", "Hardshrink", "Softshrink",
         "Tanhshrink", "Softplus", "Softsign", "Mish", "ThresholdedReLU",
         "LogSigmoid"]

LAYER_TABLE = (
    [L(n, nn(n), [F(3, 4, lo=-3, hi=3)]) for n in _ACTS]
    + [
        L("GELU_tanh", nn("GELU", True), [F(3, 4)]),
        L("PReLU", nn("PReLU", 3, 0.1), [F(2, 3, 4)]),
        L("Maxout", nn("Maxout", 2), [F(2, 4, 3)]),
        L("Softmax2D", nn("Softmax2D"), [F(2, 3, 2, 2)]),
        L("RReLU_eval", nn("RReLU"), [F(3, 4)], train=False),
        L("Identity", nn("Identity", 3), [F(3, 4)]),
        L("Linear", nn("Linear", 6, 4), [F(3, 6)]),
        L("Linear_nobias", nn("Linear", 6, 4, bias_attr=False), [F(2, 3, 6)]),
        L("Dropout_eval", nn("Dropout", 0.3), [F(3, 4)], train=False),
        L("Dropout2D_eval", nn("Dropout2D", 0.3), [F(1, 2, 3, 3)],
          train=False),
        L("Dropout3D_eval", nn("Dropout3D", 0.3), [F(1, 2, 2, 3, 3)],
          train=False),
        L("AlphaDropout_eval", nn("AlphaDropout", 0.3), [F(3, 4)],
          train=False),
        L("Dropout_p0", nn("Dropout", 0.0), [F(3, 4)]),
        L("Embedding", nn("Embedding", 9, 4, padding_idx=1),
          [I(3, 5, hi=9)]),
        L("Flatten", nn("Flatten"), [F(2, 3, 4)]),
        L("Upsample", nn("Upsample", scale_factor=2, mode="bilinear"),
          [F(1, 2, 3, 3)]),
        L("UpsamplingBilinear2D", nn("UpsamplingBilinear2D", size=[5, 4]),
          [F(1, 2, 3, 3)]),
        L("UpsamplingNearest2D", nn("UpsamplingNearest2D", scale_factor=2),
          [F(1, 2, 3, 3)]),
        L("Pad1D", nn("Pad1D", [1, 2], mode="reflect"), [F(2, 3, 5)]),
        L("Pad2D", nn("Pad2D", [1, 0, 2, 1], value=0.5), [F(1, 2, 3, 3)]),
        L("Pad3D", nn("Pad3D", [1, 0, 1, 0, 0, 1], mode="replicate"),
          [F(1, 1, 2, 3, 3)]),
        L("ZeroPad2D", nn("ZeroPad2D", [1, 1, 0, 2]), [F(1, 2, 3, 3)]),
        L("CosineSimilarity", nn("CosineSimilarity", axis=-1),
          [F(3, 5), F(3, 5)]),
        L("PixelShuffle", nn("PixelShuffle", 2), [F(1, 8, 2, 2)]),
        L("PixelUnshuffle", nn("PixelUnshuffle", 2), [F(1, 2, 4, 4)]),
        L("ChannelShuffle", nn("ChannelShuffle", 2), [F(1, 4, 2, 2)]),
        L("Bilinear", nn("Bilinear", 3, 4, 5), [F(2, 3), F(2, 4)]),
        L("Unfold", nn("Unfold", 2, strides=2), [F(1, 2, 4, 4)]),
        L("Fold", nn("Fold", [4, 4], 2, strides=2), [F(1, 8, 4)]),
        L("PairwiseDistance", nn("PairwiseDistance"), [F(3, 5), F(3, 5)]),
        # ------------------------------------------------------------- loss
        L("CrossEntropyLoss", nn("CrossEntropyLoss"), [F(5, 4),
                                                       I(5, hi=4)]),
        L("CrossEntropyLoss_soft", nn("CrossEntropyLoss", soft_label=True,
                                      reduction="sum"),
          [F(5, 4), F(5, 4, lo=0, hi=1)]),
        L("MSELoss", nn("MSELoss"), [F(3, 4), F(3, 4)]),
        L("L1Loss", nn("L1Loss", "sum"), [F(3, 4), F(3, 4)]),
        L("NLLLoss", nn("NLLLoss"), [F(5, 4), I(5, hi=4)]),
        L("BCELoss", nn("BCELoss"), [F(3, 4, lo=0.05, hi=0.95),
                                     F(3, 4, lo=0, hi=1)]),
        L("BCEWithLogitsLoss", nn("BCEWithLogitsLoss"),
          [F(3, 4), F(3, 4, lo=0, hi=1)]),
        L("KLDivLoss", nn("KLDivLoss", "batchmean"),
          [F(3, 4), F(3, 4, lo=0.1, hi=1)]),
        L("SmoothL1Loss", nn("SmoothL1Loss", delta=0.5),
          [F(3, 4, lo=-2, hi=2), F(3, 4)]),
        L("MarginRankingLoss", nn("MarginRankingLoss", 0.1),
          [F(4), F(4), K([1, -1, -1, 1], "float32")]),
        L("HingeEmbeddingLoss", nn("HingeEmbeddingLoss"),
          [F(4), K([1, -1, -1, 1], "float32")]),
        L("CTCLoss", nn("CTCLoss"), [F(5, 2, 4), I(2, 2, lo=1, hi=4),
                                     K([5, 4], "int64"), K([2, 1], "int64")]),
        L("CosineEmbeddingLoss", nn("CosineEmbeddingLoss", 0.1),
          [F(3, 4), F(3, 4), K([1, -1, 1], "int64")]),
        L("SoftMarginLoss", nn("SoftMarginLoss"),
          [F(3, 4), K(np.sign(np.arange(12) % 3 - 0.5).reshape(3, 4),
                      "float32")]),
        L("MultiLabelSoftMarginLoss", nn("MultiLabelSoftMarginLoss"),
          [F(3, 4), K((np.arange(12) % 2).reshape(3, 4), "float32")]),
        L("TripletMarginLoss", nn("TripletMarginLoss", swap=True),
          [F(3, 4), F(3, 4), F(3, 4)]),
        L("TripletMarginWithDistanceLoss",
          nn("TripletMarginWithDistanceLoss"), [F(3, 4), F(3, 4), F(3, 4)]),
        L("HSigmoidLoss", nn("HSigmoidLoss", 3, 6), [F(4, 3), I(4, hi=6)]),
        # ------------------------------------------------------------- norm
        L("BatchNorm1D", nn("BatchNorm1D", 3), [F(4, 3, 5)]),
        L("BatchNorm2D", nn("BatchNorm2D", 3), [F(4, 3, 2, 2)]),
        L("BatchNorm2D_eval", nn("BatchNorm2D", 3), [F(4, 3, 2, 2)],
          train=False),
        L("BatchNorm3D", nn("BatchNorm3D", 2, momentum=0.8),
          [F(2, 2, 2, 2, 2)]),
        L("BatchNorm_act", nn("BatchNorm", 3, act="relu"), [F(4, 3, 2, 2)]),
        L("BatchNorm2D_nhwc", nn("BatchNorm2D", 3, data_format="NHWC"),
          [F(4, 2, 2, 3)]),
        L("SyncBatchNorm", nn("SyncBatchNorm", 3), [F(4, 3, 2, 2)]),
        L("LayerNorm", nn("LayerNorm", 6), [F(3, 6)]),
        L("LayerNorm_2d", nn("LayerNorm", [2, 3]), [F(4, 2, 3)]),
        L("LayerNorm_noaffine", nn("LayerNorm", 6, weight_attr=False,
                                   bias_attr=False), [F(3, 6)]),
        L("GroupNorm", nn("GroupNorm", 2, 4), [F(2, 4, 3, 3)]),
        L("InstanceNorm1D", nn("InstanceNorm1D", 3), [F(2, 3, 6)]),
        L("InstanceNorm2D", nn("InstanceNorm2D", 3), [F(2, 3, 4, 4)]),
        L("InstanceNorm3D", nn("InstanceNorm3D", 2), [F(2, 2, 2, 3, 3)]),
        L("LocalResponseNorm", nn("LocalResponseNorm", 3), [F(2, 5, 3, 3)]),
        L("SpectralNorm", nn("SpectralNorm", [4, 3, 2], dim=1,
                             power_iters=3), [F(4, 3, 2)]),
        # ------------------------------------------------- conv and pooling
        L("Conv1D", nn("Conv1D", 3, 4, 3, padding=1), [F(2, 3, 7)]),
        L("Conv1D_stride_dil", nn("Conv1D", 2, 4, 3, stride=2, dilation=2),
          [F(2, 2, 11)]),
        L("Conv2D", nn("Conv2D", 3, 6, 3), [F(2, 3, 6, 6)]),
        L("Conv2D_pad_stride", nn("Conv2D", 3, 6, 3, stride=2, padding=1),
          [F(2, 3, 7, 7)]),
        L("Conv2D_groups", nn("Conv2D", 4, 6, 3, groups=2, padding=1),
          [F(1, 4, 5, 5)]),
        L("Conv2D_same_nobias", nn("Conv2D", 3, 4, (3, 2), padding="SAME",
                                   bias_attr=False), [F(1, 3, 5, 6)]),
        L("Conv2D_nhwc", nn("Conv2D", 3, 4, 3, padding=1,
                            data_format="NHWC"), [F(1, 5, 5, 3)]),
        L("Conv3D", nn("Conv3D", 2, 3, 2, padding=1), [F(1, 2, 3, 4, 4)]),
        L("Conv1DTranspose", nn("Conv1DTranspose", 3, 2, 3, stride=2),
          [F(2, 3, 5)]),
        L("Conv2DTranspose", nn("Conv2DTranspose", 4, 3, 3, stride=2,
                                padding=1, output_padding=1),
          [F(2, 4, 4, 4)]),
        L("Conv2DTranspose_groups", nn("Conv2DTranspose", 4, 6, 2,
                                       groups=2), [F(1, 4, 3, 3)]),
        L("Conv3DTranspose", nn("Conv3DTranspose", 2, 2, 2, stride=2),
          [F(1, 2, 2, 3, 3)]),
        L("MaxPool1D", nn("MaxPool1D", 2), [F(2, 3, 8)]),
        L("MaxPool2D", nn("MaxPool2D", 2, 2), [F(2, 3, 6, 6)]),
        L("MaxPool2D_pad_ceil", nn("MaxPool2D", 3, 2, padding=1,
                                   ceil_mode=True), [F(1, 2, 7, 7)]),
        L("MaxPool2D_mask", nn("MaxPool2D", 2, return_mask=True),
          [F(1, 2, 4, 4)]),
        L("MaxPool3D", nn("MaxPool3D", 2), [F(1, 2, 4, 4, 4)]),
        L("AvgPool1D", nn("AvgPool1D", 3, 2, padding=1), [F(2, 3, 9)]),
        L("AvgPool2D", nn("AvgPool2D", 2, 2), [F(2, 3, 6, 6)]),
        L("AvgPool2D_inclusive", nn("AvgPool2D", 3, 2, padding=1,
                                    exclusive=False), [F(1, 2, 5, 5)]),
        L("AvgPool2D_divisor", nn("AvgPool2D", 2, divisor_override=3),
          [F(1, 2, 4, 4)]),
        L("AvgPool3D", nn("AvgPool3D", 2), [F(1, 2, 4, 4, 4)]),
        L("AdaptiveAvgPool1D", nn("AdaptiveAvgPool1D", 3), [F(2, 3, 7)]),
        L("AdaptiveAvgPool2D", nn("AdaptiveAvgPool2D", 1), [F(2, 3, 5, 5)]),
        L("AdaptiveAvgPool2D_uneven", nn("AdaptiveAvgPool2D", (2, 3)),
          [F(1, 2, 5, 7)]),
        L("AdaptiveAvgPool3D", nn("AdaptiveAvgPool3D", 2),
          [F(1, 2, 4, 4, 4)]),
        L("AdaptiveMaxPool1D", nn("AdaptiveMaxPool1D", 2), [F(2, 3, 6)]),
        L("AdaptiveMaxPool2D", nn("AdaptiveMaxPool2D", (2, 2)),
          [F(1, 3, 5, 5)]),
        L("AdaptiveMaxPool3D", nn("AdaptiveMaxPool3D", 2),
          [F(1, 2, 4, 4, 4)]),
        L("MaxUnPool1D", lambda P: _unpool(P, 1), [F(1, 2, 8)]),
        L("MaxUnPool2D", lambda P: _unpool(P, 2), [F(1, 2, 4, 4)]),
        L("MaxUnPool3D", lambda P: _unpool(P, 3), [F(1, 1, 4, 4, 4)]),
        L("Conv_stack", lambda P: P.nn.Sequential(
            P.nn.Conv2D(3, 4, 3, padding=1), P.nn.BatchNorm2D(4),
            P.nn.ReLU(), P.nn.MaxPool2D(2, 2), P.nn.Conv2D(4, 2, 1),
            P.nn.AdaptiveAvgPool2D(1), P.nn.Flatten()), [F(2, 3, 6, 6)]),
        # ------------------------------------------------------- containers
        L("Sequential", lambda P: P.nn.Sequential(
            P.nn.Linear(5, 8), P.nn.ReLU(), P.nn.Linear(8, 3)), [F(4, 5)]),
        L("Sequential_named", lambda P: P.nn.Sequential(
            ("fc", P.nn.Linear(5, 8)), ("act", P.nn.Tanh()),
            ("out", P.nn.Linear(8, 2))), [F(4, 5)]),
        L("LayerList", lambda P: P.nn.LayerList(
            [P.nn.Linear(4, 4), P.nn.LayerNorm(4), P.nn.Linear(4, 2)]),
          [F(3, 4)], call=lambda m, x: m[2](m[1](m[0](x)))),
        L("LayerDict", lambda P: P.nn.LayerDict(
            {"a": P.nn.Linear(4, 3), "b": P.nn.Linear(3, 2)}),
          [F(3, 4)], call=lambda m, x: m["b"](m["a"](x))),
        L("ParameterList", lambda P: _param_list(P), [F(2, 4)],
          call=lambda m, x: x.matmul(m[0]) + m[1]),
    ]
)


def _unpool(P, nd):
    """max_pool{nd}d with its mask, then MaxUnPool{nd}D (2-wide)."""
    class Unpool(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.unpool = getattr(P.nn, f"MaxUnPool{nd}D")(2)

        def forward(self, x):
            y, idx = getattr(P.nn.functional, f"max_pool{nd}d")(
                x, 2, return_mask=True)
            return self.unpool(y, idx)
    return Unpool()


def _param_list(P):
    lin = P.nn.Linear(4, 3)
    return P.nn.ParameterList([lin.weight, lin.bias])


@pytest.fixture
def cpu():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _shapes(layer):
    return [(k, tuple(v.shape)) for k, v in layer.state_dict().items()]


def _run(P, case, arrays, layer):
    if not case.train:
        layer.eval()
    ts = [P.to_tensor(a, stop_gradient=a.dtype.kind != "f") for a in arrays]
    outs = flat_outputs(case.call(layer, *ts))
    rng = np.random.RandomState(7)
    loss = None
    for o in outs:
        if getattr(o, "stop_gradient", True):
            continue
        w = P.to_tensor(rng.uniform(0.5, 1.5, o.shape).astype(np.float32))
        term = (o * w.astype(o.dtype)).sum()
        loss = term if loss is None else loss + term
    if loss is not None:
        loss.backward()
    return (outs, [t.grad for t in ts],
            {n: p.grad for n, p in layer.named_parameters()},
            {n: b.numpy() for n, b in layer.named_buffers()})


def _np(g, like):
    return np.zeros(like) if g is None else np.asarray(g.numpy())


@pytest.mark.parametrize("case", LAYER_TABLE, ids=lambda c: c.id)
def test_layer_matches_jax(case, cpu):
    import paddle_tpu as pj
    pt = cpu
    jl, tl = case.ctor(pj), case.ctor(pt)
    assert _shapes(tl) == _shapes(jl)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    missing, unexpected = tl.set_state_dict(
        {k: v.numpy() for k, v in jl.state_dict().items()})
    assert missing == [] and unexpected == []
    arrays = case.inputs()
    want = _run(pj, case, arrays, jl)
    got = _run(pt, case, arrays, tl)
    compare_layer_runs(got, want, case, arrays)


def _close(g, w, tol, what):
    if g.dtype.kind in "biu":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=what)


def compare_layer_runs(got, want, case, arrays):
    """Two runs of one Layer case (`_run`'s outputs, input gradients,
    parameter gradients, buffers): counts, shapes, parameter names and
    buffer keys equal, integer results exact, floats within the case's
    tolerance. A missing gradient counts as zeros."""
    what = case.id
    outs = [host(o) for o in got[0]], [host(o) for o in want[0]]
    assert len(outs[0]) == len(outs[1]), (what, len(outs[0]),
                                          len(outs[1]))
    for (g, _), (w, _) in zip(*outs):
        assert g.shape == np.shape(w), (what, g.shape, np.shape(w))
        _close(g, w, case.tol, f"{what}: output")
    for i, a in enumerate(arrays):
        if a.dtype.kind == "f":
            _close(_np(got[1][i], a.shape), _np(want[1][i], a.shape),
                   case.tol, f"{what}: input {i} grad")
    assert list(got[2]) == list(want[2]), what
    for n in got[2]:
        g, w = got[2][n], want[2][n]
        if g is None and w is None:
            continue
        shape = tuple((w if g is None else g).shape)
        _close(_np(g, shape), _np(w, shape), case.tol, f"{what}: grad of {n}")
    assert set(got[3]) == set(want[3]), what
    for n in got[3]:
        _close(got[3][n], want[3][n], case.tol, f"{what}: buffer {n}")


def test_batchnorm_running_stats_use_paddle_momentum(cpu):
    """running = running * momentum + batch * (1 - momentum), the
    variance unbiased; three training steps against the formula."""
    pt = cpu
    bn = pt.nn.BatchNorm1D(3, momentum=0.9)
    rng = np.random.RandomState(0)
    mean, var = np.zeros(3), np.ones(3)
    for _ in range(3):
        x = rng.randn(8, 3).astype(np.float32) * 2 + 1
        bn(pt.to_tensor(x))
        mean = mean * 0.9 + x.mean(0) * 0.1
        var = var * 0.9 + x.var(0, ddof=1) * 0.1
    np.testing.assert_allclose(bn._mean.numpy(), mean, rtol=1e-5)
    np.testing.assert_allclose(bn._variance.numpy(), var, rtol=1e-5)
    assert bn._mean.stop_gradient


# ------------------------------------------------------------ mechanics

def _nested(P):
    class Block(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)
            self.norm = P.nn.LayerNorm(4)
            self.scratch = P.to_tensor(np.ones(3, np.float32))   # plain attr
            self.register_buffer("steps", P.to_tensor(np.zeros(1, np.float32)))
            self.register_buffer("cache", P.to_tensor(np.zeros(2, np.float32)),
                                 persistable=False)

        def forward(self, x):
            return self.norm(self.fc(x))

    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.blocks = P.nn.LayerList([Block(), Block()])
            self.head = P.nn.Linear(4, 2)
            self.shared = self.head            # a second name, same Layer

        def forward(self, x):
            for b in self.blocks:
                x = b(x)
            return self.head(x)
    return Net()


def test_registration_rules_and_order_match_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    jn, tn = _nested(pj), _nested(pt)
    assert list(tn.state_dict()) == list(jn.state_dict())
    assert [n for n, _ in tn.named_buffers()] == \
        [n for n, _ in jn.named_buffers()]
    assert [n for n, _ in tn.named_sublayers()] == \
        [n for n, _ in jn.named_sublayers()]
    keys = list(tn.state_dict())
    assert "blocks.0.steps" in keys
    assert not any(k.endswith("scratch") or k.endswith("cache")
                   for k in keys)               # non-persistable buffers
    assert "blocks.0.scratch" in dict(tn.named_buffers())
    assert len(tn.parameters()) == 2 * 4 + 2    # head counted once
    tn.head = None
    assert "head" not in dict(tn.named_children())
    with pytest.raises(TypeError):
        tn.blocks[0].fc.weight = 3


def test_hooks(cpu):
    pt = cpu
    lin = pt.nn.Linear(3, 2)
    seen = []
    h1 = lin.register_forward_pre_hook(lambda l, inp: (inp[0] * 2,))
    h2 = lin.register_forward_post_hook(
        lambda l, inp, out: seen.append(out.shape) or out + 1)
    x = pt.to_tensor(np.ones((1, 3), np.float32))
    want = (2 * x.numpy()) @ lin.weight.numpy() + lin.bias.numpy() + 1
    np.testing.assert_allclose(lin(x).numpy(), want, rtol=1e-6)
    h1.remove()
    h2.remove()
    np.testing.assert_allclose(lin(x).numpy(),
                               x.numpy() @ lin.weight.numpy()
                               + lin.bias.numpy(), rtol=1e-6)
    assert seen == [[1, 2]]


def test_functional_call_swaps_and_restores(cpu):
    import torch
    pt = cpu
    net = pt.nn.Sequential(pt.nn.Linear(3, 4), pt.nn.BatchNorm1D(4))
    params, buffers = pt.nn.functional_state(net)
    orig = {n: t.clone() for n, t in params.items()}
    mine = {n: (t.detach() * 2).requires_grad_() for n, t in params.items()}
    x = pt.to_tensor(np.random.RandomState(0).randn(5, 3).astype(np.float32))
    out, new_buffers = pt.nn.functional_call(net, mine, buffers, (x,),
                                             train=True)
    out._data.sum().backward()
    assert all(mine[n].grad is not None for n in mine)
    for n, p in net.named_parameters():
        assert torch.equal(p._data, orig[n])     # the originals are back
    assert not torch.equal(new_buffers["1._mean"], buffers["1._mean"])
    assert torch.equal(net[1]._mean._data, buffers["1._mean"])
    assert net.training


def test_set_state_dict_keeps_identity_dtype_and_trainability(cpu):
    pt = cpu
    lin = pt.nn.Linear(3, 2)
    w = lin.weight
    lin.astype("bfloat16")
    assert lin.weight is w and str(w.dtype) == "torch.bfloat16"
    assert not w.stop_gradient and w.is_leaf
    vals = np.arange(6, dtype=np.float32).reshape(3, 2) / 8
    missing, unexpected = lin.set_state_dict({"weight": vals, "extra": 1})
    assert missing == ["bias"] and unexpected == ["extra"]
    assert lin.weight is w and str(w.dtype) == "torch.bfloat16"
    np.testing.assert_array_equal(w.numpy(), vals)   # exact in bf16
    assert not w.stop_gradient and w.is_leaf
    with pytest.raises(ValueError, match="shape mismatch"):
        lin.set_state_dict({"weight": np.zeros((2, 3), np.float32)})
    lin.float()
    assert str(w.dtype) == "torch.float32"


def test_containers_match_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    for P in (pj, pt):
        seq = P.nn.Sequential(P.nn.Linear(2, 3), P.nn.ReLU(),
                              P.nn.Linear(3, 1))
        assert len(seq) == 3 and isinstance(seq[1], P.nn.ReLU)
        assert len(seq[1:]) == 2
        ll = P.nn.LayerList([P.nn.Linear(2, 2)])
        ll.append(P.nn.Linear(2, 3)).insert(0, P.nn.Tanh())
        ll.extend([P.nn.ReLU()])
        assert [type(m).__name__ for m in ll] == ["Tanh", "Linear",
                                                  "Linear", "ReLU"]
        assert list(ll.state_dict()) == ["1.weight", "1.bias", "2.weight",
                                         "2.bias"]
        ld = P.nn.LayerDict({"x": P.nn.Linear(2, 2)})
        ld["y"] = P.nn.ReLU()
        assert list(ld.keys()) == ["x", "y"] and "y" in ld
        ld.pop("y")
        assert len(ld) == 1


def test_layer_needs_the_cpu_asked_for(monkeypatch):
    """Without CUDA, making a Layer on the default place (the GPU) raises;
    set_device("cpu") runs it on the host."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import device
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(device, "_current_place", device.Place("gpu", 0))
    monkeypatch.setattr(device, "_current_device", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.nn.Linear(2, 2)
    pt.set_device("cpu")
    assert pt.nn.Linear(2, 2).weight.place == pt.CPUPlace()


def test_param_attr(cpu):
    pt = cpu
    from paddle_tpu_torch.regularizer import L2Decay
    attr = pt.nn.ParamAttr(name="w0", learning_rate=0.5,
                           regularizer=L2Decay(0.1), need_clip=False,
                           initializer=pt.nn.initializer.Constant(0.3))
    lin = pt.nn.Linear(2, 3, weight_attr=attr,
                       bias_attr=pt.nn.ParamAttr(trainable=False))
    w = lin.weight
    assert w.name == "w0" and w.optimize_attr["learning_rate"] == 0.5
    assert w.regularizer.coeff == 0.1 and w.need_clip is False
    np.testing.assert_array_equal(w.numpy(), np.full((2, 3), 0.3, np.float32))
    assert lin.bias.stop_gradient and not w.stop_gradient
    assert pt.nn.Linear(2, 3, bias_attr=False).bias is None
    assert pt.nn.ParamAttr._to_attr("n").name == "n"


def test_convert_sync_batchnorm(cpu):
    pt = cpu
    net = pt.nn.Sequential(pt.nn.Linear(2, 3), pt.nn.BatchNorm1D(3))
    net[1]._mean.set_value(np.array([1.0, 2.0, 3.0], np.float32))
    out = pt.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], pt.nn.SyncBatchNorm)
    np.testing.assert_array_equal(out[1]._mean.numpy(), [1.0, 2.0, 3.0])


# ---------------------------------------------------------- initializers

_INITS = [
    ("Normal", dict(mean=0.5, std=2.0)),
    ("TruncatedNormal", dict(mean=0.0, std=1.5)),
    ("Uniform", dict(low=-0.3, high=0.7)),
    ("XavierNormal", {}), ("XavierUniform", {}),
    ("KaimingNormal", {}), ("KaimingUniform", {}),
    ("Orthogonal", dict(gain=1.5)),
]


@pytest.mark.parametrize("name,kw", _INITS, ids=[n for n, _ in _INITS])
def test_initializer_contract(cpu, name, kw):
    import math
    pt = cpu
    init = getattr(pt.nn.initializer, name)(**kw)
    shape = (256, 128)                            # [in, out]: fan_in = 256
    pt.seed(5)
    a = init(shape, "float32")
    pt.seed(5)
    b = init(shape, "float32")
    assert a.shape == shape and str(a.dtype) == "torch.float32"
    assert str(init(shape, "bfloat16").dtype) == "torch.bfloat16"
    v = a.numpy()
    np.testing.assert_array_equal(v, b.numpy())
    fi, fo = 256, 128
    if name == "Normal":
        assert abs(v.mean() - 0.5) < 0.05 and abs(v.std() - 2.0) < 0.05
    elif name == "TruncatedNormal":
        assert np.abs(v).max() <= 2 * 1.5 + 1e-5
        assert abs(v.std() - 1.5 * 0.8796) < 0.03    # truncated std
    elif name == "Uniform":
        assert v.min() >= -0.3 and v.max() <= 0.7
    elif name == "XavierNormal":
        assert abs(v.std() - math.sqrt(2 / (fi + fo))) < 0.003
    elif name == "XavierUniform":
        lim = math.sqrt(6 / (fi + fo))
        assert np.abs(v).max() <= lim and np.abs(v).max() > 0.95 * lim
    elif name == "KaimingNormal":
        assert abs(v.std() - math.sqrt(2) / math.sqrt(fi)) < 0.003
    elif name == "KaimingUniform":
        lim = math.sqrt(2) * math.sqrt(3 / fi)      # fan_in = shape[0]
        assert np.abs(v).max() <= lim and np.abs(v).max() > 0.95 * lim
    elif name == "Orthogonal":
        np.testing.assert_allclose(v.T @ v, 1.5 ** 2 * np.eye(fo),
                                   atol=1e-4)


@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 4)),
    ("Assign", (np.arange(12, dtype=np.float32).reshape(3, 4),), (3, 4)),
    ("Dirac", (), (4, 2, 3, 3)),
    ("Bilinear", (), (2, 2, 4, 4)),
], ids=["Constant", "Assign", "Dirac", "Bilinear"])
def test_deterministic_initializers_match_jax(cpu, name, args, shape):
    import paddle_tpu as pj
    pt = cpu
    want = np.asarray(getattr(pj.nn.initializer, name)(*args)(shape,
                                                              "float32"))
    got = getattr(pt.nn.initializer, name)(*args)(shape, "float32").numpy()
    np.testing.assert_array_equal(got, want)


def test_calculate_gain_matches_jax():
    import paddle_tpu as pj
    import paddle_tpu_torch as pt
    for nl, p in [("relu", None), ("leaky_relu", 0), ("leaky_relu", None),
                  ("tanh", None), ("selu", None), ("conv2d", None)]:
        assert pt.nn.initializer.calculate_gain(nl, p) == \
            pj.nn.initializer.calculate_gain(nl, p)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_state_dict_file_roundtrip(cpu, tmp_path, writer):
    """A Layer's state_dict saved by either package (`framework.io`'s
    format, the JAX package's pickle) loads into the port's Layer."""
    import paddle_tpu as pj
    pt = cpu
    path = str(tmp_path / "model.pdparams")
    src = (pt if writer == "port" else pj).nn.Sequential(
        (pt if writer == "port" else pj).nn.Linear(3, 4),
        (pt if writer == "port" else pj).nn.BatchNorm1D(4))
    if writer == "port":
        pt.framework.io.save(src.state_dict(), path)
    else:
        pj.save(src.state_dict(), path)
    loaded = pt.framework.io.load(path, device="cpu")
    dst = pt.nn.Sequential(pt.nn.Linear(3, 4), pt.nn.BatchNorm1D(4))
    assert dst.set_state_dict(loaded) == ([], [])
    for (k, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        np.testing.assert_array_equal(np.asarray(a.numpy()), b.numpy(),
                                      err_msg=k)


def test_train_eval_propagation_and_sdpa_first_row(cpu):
    pt = cpu
    seq = pt.nn.Sequential(pt.nn.Linear(2, 2), pt.nn.Dropout(0.5))
    seq.eval()
    assert not seq[1].training
    seq.train()
    assert seq[1].training
    q = np.random.RandomState(0).rand(1, 4, 2, 8).astype(np.float32)
    out = pt.nn.functional.scaled_dot_product_attention(
        pt.to_tensor(q), pt.to_tensor(q), pt.to_tensor(q), is_causal=True)
    np.testing.assert_allclose(out.numpy()[0, 0], q[0, 0], rtol=1e-5)


# ------------------------------------------------ conv / pool and nn.utils

def test_conv_pool_oracle_checks(cpu):
    """`tests/test_nn_layers.py::TestConvPool`'s checks on the port."""
    pt = cpu
    nn, F = pt.nn, pt.nn.functional
    rng = np.random.RandomState(3)
    x = pt.to_tensor(rng.rand(2, 3, 8, 8).astype(np.float32))
    assert nn.Conv2D(3, 6, 3)(x).shape == [2, 6, 6, 6]
    assert nn.Conv2D(3, 6, 3, padding=1)(x).shape == [2, 6, 8, 8]
    assert nn.Conv2D(3, 6, 3, stride=2, padding=1)(x).shape == [2, 6, 4, 4]
    assert nn.Conv2D(3, 6, 3, groups=3, padding=1)(x).shape == [2, 6, 8, 8]
    a = rng.rand(1, 1, 4, 4).astype(np.float32)
    w = rng.rand(1, 1, 3, 3).astype(np.float32)
    ref = np.zeros((1, 1, 2, 2), np.float32)
    for i in range(2):
        for j in range(2):
            ref[0, 0, i, j] = (a[0, 0, i:i + 3, j:j + 3] * w[0, 0]).sum()
    np.testing.assert_allclose(F.conv2d(pt.to_tensor(a),
                                        pt.to_tensor(w)).numpy(), ref,
                               rtol=1e-5)
    xt = pt.to_tensor(rng.rand(2, 4, 5, 5).astype(np.float32))
    assert nn.Conv2DTranspose(4, 3, 3, stride=2, padding=1,
                              output_padding=1)(xt).shape == [2, 3, 10, 10]
    assert nn.MaxPool2D(2, 2)(x).shape == [2, 3, 4, 4]
    assert nn.AvgPool2D(2, 2)(x).shape == [2, 3, 4, 4]
    np.testing.assert_allclose(nn.AdaptiveAvgPool2D(1)(x).numpy()[..., 0, 0],
                               x.numpy().mean((2, 3)), rtol=1e-5)
    np.testing.assert_allclose(F.max_pool2d(pt.to_tensor(a), 2, 2).numpy(),
                               a.reshape(1, 1, 2, 2, 2, 2).max((3, 5)),
                               rtol=1e-6)


def test_conv_layers_draw_paddle_fans(cpu):
    """Weights and biases in Uniform(+-1/sqrt(in/groups * k)), the
    layouts [out, in/groups, k..] and [in, out/groups, k..]."""
    pt = cpu
    pt.seed(5)
    c = pt.nn.Conv2D(8, 6, 3, groups=2)
    t = pt.nn.Conv2DTranspose(8, 6, 3, groups=2)
    assert c.weight.shape == [6, 4, 3, 3] and t.weight.shape == [8, 3, 3, 3]
    for layer in (c, t):
        bound = 1 / np.sqrt(4 * 9)
        for p in (layer.weight, layer.bias):
            v = p.numpy()
            assert np.abs(v).max() <= bound and np.abs(v).max() > bound / 2
    pt.seed(5)
    np.testing.assert_array_equal(pt.nn.Conv2D(8, 6, 3, groups=2)
                                  .weight.numpy(), c.weight.numpy())


def _carry(src, dst):
    missing, unexpected = dst.set_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    assert missing == [] and unexpected == []


def _loss_grads(P, layer, x, names):
    out = layer(P.to_tensor(x))
    w = np.random.RandomState(1).uniform(0.5, 1.5, out.shape)
    (out * P.to_tensor(w.astype(np.float32))).sum().backward()
    params = dict(layer.named_parameters())
    return out.numpy(), [params[n].grad.numpy() for n in names]


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_weight_norm_matches_jax(cpu, kind):
    import paddle_tpu as pj
    pt = cpu

    def build(P):
        return P.nn.Linear(5, 4) if kind == "linear" else \
            P.nn.Conv2D(3, 4, 3, padding=1)
    jl, tl = build(pj), build(pt)
    _carry(jl, tl)
    dim = 1 if kind == "linear" else 0
    jl = pj.nn.utils.weight_norm(jl, dim=dim)
    tl = pt.nn.utils.weight_norm(tl, dim=dim)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    x = np.random.RandomState(2).rand(
        *((3, 5) if kind == "linear" else (2, 3, 5, 5))).astype(np.float32)
    names = ["weight_g", "weight_v"]
    got, want = _loss_grads(pt, tl, x, names), _loss_grads(pj, jl, x, names)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    pj.nn.utils.remove_weight_norm(jl)
    pt.nn.utils.remove_weight_norm(tl)
    np.testing.assert_allclose(tl.weight.numpy(), jl.weight.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert [n for n, _ in tl.named_parameters()] == ["bias", "weight"] == \
        [n for n, _ in jl.named_parameters()]
    with pytest.raises(ValueError, match="no weight norm"):
        pt.nn.utils.remove_weight_norm(tl)


def test_spectral_norm_contract_and_jax(cpu):
    """The estimate converges to the largest singular value; the same
    seed draws the same u; the gradient reaches weight_orig; converged,
    the forward equals the JAX package's."""
    import paddle_tpu as pj
    pt = cpu
    jl, tl = pj.nn.Linear(6, 4), pt.nn.Linear(6, 4)
    _carry(jl, tl)
    w = tl.weight.numpy()
    pt.seed(11)
    tl = pt.nn.utils.spectral_norm(tl, n_power_iterations=30, dim=1)
    jl = pj.nn.utils.spectral_norm(jl, n_power_iterations=30, dim=1)
    sigma = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(tl.weight.numpy(), w / sigma, rtol=1e-5,
                               atol=1e-6)
    x = np.random.RandomState(4).rand(3, 6).astype(np.float32)
    got = _loss_grads(pt, tl, x, ["weight_orig"])
    want = _loss_grads(pj, jl, x, ["weight_orig"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-4, atol=1e-5)
    # the power-iteration vector comes from the port's generator
    pt.seed(11)
    a = pt.nn.utils.spectral_norm(pt.nn.Linear(6, 4), n_power_iterations=0)
    pt.seed(11)
    b = pt.nn.utils.spectral_norm(pt.nn.Linear(6, 4), n_power_iterations=0)
    np.testing.assert_array_equal(a.weight.numpy(), b.weight.numpy())


def test_parameters_to_vector_matches_jax(cpu):
    import paddle_tpu as pj
    pt = cpu
    jl, tl = pj.nn.Conv2D(2, 3, 2), pt.nn.Conv2D(2, 3, 2)
    _carry(jl, tl)
    tv = pt.nn.utils.parameters_to_vector(tl.parameters())
    jv = pj.nn.utils.parameters_to_vector(jl.parameters())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
    ids = [id(p) for p in tl.parameters()]
    new = np.arange(tv.shape[0], dtype=np.float32)
    pt.nn.utils.vector_to_parameters(pt.to_tensor(new), tl.parameters())
    pj.nn.utils.vector_to_parameters(pj.to_tensor(new), jl.parameters())
    assert [id(p) for p in tl.parameters()] == ids
    for (n, a), (_, b) in zip(tl.named_parameters(), jl.named_parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)
        assert not a.stop_gradient
    with pytest.raises(ValueError, match="elements"):
        pt.nn.utils.vector_to_parameters(pt.to_tensor(new[:-1]),
                                         tl.parameters())
