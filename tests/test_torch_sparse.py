"""The port's `sparse` against the JAX package's on the CPU, on the same
seeded numpy inputs.

* COO / CSR construction, conversion, coalesce, the values-only unary
  ops, the densifying binary ops and matmul, masked_matmul, mv, addmm,
  reshape, cast and transpose: values within 1e-6, indices equal.
* The 3-D convolutions: the port builds its rulebook with tensor ops
  (`sparse/nn/conv.py: rulebook`); it must equal the reference's host
  rulebook (`paddle_tpu/sparse/nn/conv.py: _rulebook`) index for index,
  and the port's own copy of it (`rulebook_plain`), for submanifold
  convolutions with and without padding and with repeated coordinates,
  and strided convolutions with padding and dilation, including the
  first-appearance numbering of the output sites. Outputs and the
  gradients of the values, weight and bias within 1e-5 (f32 sums in
  another order), with the JAX Layer's weights carried across by
  `set_state_dict`.
* The sparse `nn` functionals and Layers: relu / relu6 / leaky_relu,
  softmax over CSR rows and COO rows, max_pool3d, BatchNorm, attention.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as pj
import paddle_tpu_torch as pt
from paddle_tpu.sparse.nn import conv as jconv
from paddle_tpu_torch.sparse.nn import conv as tconv
from torch_jax_init import numpy_initializers

TOL = 1e-6
CONV_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _coo(P):
    return P.sparse.sparse_coo_tensor([[0, 1, 2, 2], [1, 0, 2, 0]],
                                      [1.0, -2.0, 3.0, 0.5], [3, 3])


def test_coo_csr_roundtrip_and_dense():
    for P in (pj, pt):
        coo = _coo(P)
        csr = coo.to_sparse_csr()
        if P is pt:
            got = (coo.to_dense(), csr.crows(), csr.cols(), csr.values(),
                   csr.to_sparse_coo().indices(), csr.to_dense())
        else:
            want = (coo.to_dense(), csr.crows(), csr.cols(), csr.values(),
                    csr.to_sparse_coo().indices(), csr.to_dense())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    csr_t = pt.sparse.sparse_csr_tensor([0, 2, 3], [0, 2, 1], [1., 2., 3.],
                                        [2, 3])
    csr_j = pj.sparse.sparse_csr_tensor([0, 2, 3], [0, 2, 1], [1., 2., 3.],
                                        [2, 3])
    np.testing.assert_array_equal(_np(csr_t.to_dense()),
                                  _np(csr_j.to_dense()))
    assert csr_t.nnz() == 3 and csr_t.is_sparse_csr()


def test_coalesce_cast_transpose_reshape():
    ind = [[0, 0, 1, 1], [1, 1, 0, 2]]
    vals = [1., 2., 5., -1.]
    res = {}
    for P in (pj, pt):
        x = P.sparse.sparse_coo_tensor(ind, vals, [2, 3])
        c = P.sparse.coalesce(x)
        t = P.sparse.transpose(c, [1, 0])
        r = P.sparse.reshape(c, [3, -1])
        k = P.sparse.cast(c, index_dtype="int32", value_dtype="float64")
        res[P] = (c.indices(), c.values(), t.indices(), t.to_dense(),
                  r.indices(), r.to_dense(), k.values())
        assert c.nnz() == 3 and r.shape == [3, 2]
    for a, b in zip(res[pt], res[pj]):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("op", ["relu", "tanh", "sin", "sinh", "asin",
                                "asinh", "atan", "atanh", "sqrt", "square",
                                "abs", "neg", "tan", "log1p", "expm1",
                                "deg2rad", "rad2deg"])
def test_unary_values_only(op):
    vals = np.asarray([0.1, -0.4, 0.7, 0.25], np.float32)
    if op in ("sqrt", "log1p"):
        vals = np.abs(vals)
    outs = []
    for P in (pj, pt):
        x = P.sparse.sparse_coo_tensor([[0, 1, 2, 2], [1, 0, 2, 0]], vals,
                                       [3, 3])
        y = getattr(P.sparse, op)(x)
        outs.append((y.values(), y.to_dense()))
        csr = getattr(P.sparse, op)(x.to_sparse_csr())
        outs.append((csr.values(), csr.to_dense()))
    for a, b in zip(outs[2] + outs[3], outs[0] + outs[1]):
        _close(a, b)
    p = pt.sparse.pow(pt.sparse.sparse_coo_tensor([[0]], [3.0], [2]), 2)
    assert _np(p.values()).tolist() == [9.0]


def test_binary_matmul_mv_addmm_masked():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 4).astype(np.float32)
    b = rng.rand(4, 3).astype(np.float32)
    d = rng.rand(3, 3).astype(np.float32)
    v = rng.rand(3).astype(np.float32)
    res = {}
    for P in (pj, pt):
        x, y = _coo(P), _coo(P)
        out = []
        for op in ("add", "subtract", "multiply"):
            z = getattr(P.sparse, op)(x, y)
            out += [z.to_dense()]
            zc = getattr(P.sparse, op)(x.to_sparse_csr(), y.to_sparse_csr())
            out += [zc.to_dense()]
        out.append(P.sparse.divide(x, P.to_tensor(d + 1)))
        out.append(P.sparse.matmul(x, P.to_tensor(d)))
        out.append(P.sparse.mv(x, P.to_tensor(v)))
        out.append(P.sparse.addmm(P.to_tensor(d), x, P.to_tensor(d),
                                  beta=0.5, alpha=2.0))
        mm = P.sparse.masked_matmul(P.to_tensor(a), P.to_tensor(b), x)
        out += [mm.values(), mm.to_dense()]
        mc = P.sparse.masked_matmul(P.to_tensor(a), P.to_tensor(b),
                                    x.to_sparse_csr())
        out += [mc.values()]
        tc = P.sparse.to_sparse_coo(P.to_tensor(d * (d > 0.5)))
        out += [tc.indices(), tc.values()]
        res[P] = out
    for a_, b_ in zip(res[pt], res[pj]):
        _close(a_, b_, 1e-5)


def test_values_ops_record_gradients():
    x = pt.sparse.sparse_coo_tensor([[0, 1], [1, 0]], [0.5, -2.0], [2, 2],
                                    stop_gradient=False)
    pt.sparse.square(x).to_dense().sum().backward()
    np.testing.assert_allclose(_np(x.values().grad), [1.0, -4.0])


# ------------------------------------------------------------- 3-D convs
def _sites(rng, N, D, H, W, nnz, dup=0):
    seen = set()
    while len(seen) < nnz:
        seen.add((rng.randint(N), rng.randint(D), rng.randint(H),
                  rng.randint(W)))
    sites = list(seen)
    rng.shuffle(sites)                 # input order is not sorted
    sites += sites[:dup]               # repeated coordinates
    return np.asarray(sites, np.int64).T


RULE_CASES = [
    # (subm, kernel, stride, padding, dilation, dup)
    (True, 3, 1, 1, 1, 0),
    (True, 3, 1, 0, 1, 0),
    (True, (3, 1, 3), 1, (1, 0, 2), (1, 1, 2), 0),
    (True, 3, 1, 1, 1, 4),
    (False, 3, 2, 1, 1, 0),
    (False, 3, 1, 0, 1, 0),
    (False, (3, 2, 3), (2, 1, 3), (1, 0, 2), (2, 1, 1), 0),
    (False, 2, 2, 0, 1, 0),
]


@pytest.mark.parametrize("case", RULE_CASES)
def test_rulebook_equals_the_reference(case):
    subm, k, s, p, d, dup = case
    rng = np.random.RandomState(zlib.crc32(str(case).encode()))
    shape = [2, 7, 9, 8, 3]
    idx = _sites(rng, 2, 7, 9, 8, 60, dup)
    k3, s3, p3, d3 = (tconv._triple(v) for v in (k, s, p, d))
    ref = jconv._rulebook(idx, shape, k3, s3, p3, d3, subm)
    plain = tconv.rulebook_plain(idx, shape, k3, s3, p3, d3, subm)
    dev = tconv.rulebook(torch.from_numpy(idx), shape, k3, s3, p3, d3, subm)
    for got in (plain, (dev[0].numpy(), [(g.numpy(), t.numpy())
                                         for g, t in dev[1]], dev[2])):
        np.testing.assert_array_equal(got[0], ref[0])
        assert tuple(got[2]) == tuple(ref[2])
        assert len(got[1]) == len(ref[1])
        for (g1, s1), (g2, s2) in zip(got[1], ref[1]):
            np.testing.assert_array_equal(g1, g2)
            np.testing.assert_array_equal(s1, s2)
    assert sum(len(g) for g, _ in ref[1]) > 0


# kernels of 6 and 4 offsets: the JAX package compiles the layer's
# forward and backward for each case, ~0.6 s an offset
@pytest.mark.parametrize("case", [(True, (3, 1, 2), 1, (1, 0, 1), 1, 0),
                                  (False, (2, 1, 2), 2, 1, (1, 2, 1), 0)])
def test_conv_layers_values_and_grads(case):
    subm, k, s, p, d, _ = case
    rng = np.random.RandomState(7)
    idx = _sites(rng, 2, 5, 6, 5, 30)
    vals = rng.randn(idx.shape[1], 3).astype("float32")
    shape = [2, 5, 6, 5, 3]
    res = {}
    pj.seed(0)
    with numpy_initializers():
        jl = (pj.sparse.nn.SubmConv3D if subm else pj.sparse.nn.Conv3D)(
            3, 4, k, stride=s, padding=p, dilation=d)
    tl = (pt.sparse.nn.SubmConv3D if subm else pt.sparse.nn.Conv3D)(
        3, 4, k, stride=s, padding=p, dilation=d)
    assert list(tl.state_dict()) == list(jl.state_dict())
    tl.set_state_dict({n: _np(v) for n, v in jl.state_dict().items()})
    for P, layer in ((pj, jl), (pt, tl)):
        v = P.to_tensor(vals, stop_gradient=False)
        # the class keeps the values Tensor (the reference's
        # sparse_coo_tensor copies it off the tape)
        x = P.sparse.SparseCooTensor(P.to_tensor(idx), v, shape)
        out = layer(x)
        (out.values() * out.values()).sum().backward()
        res[P] = (out.indices(), out.values(), v.grad, layer.weight.grad,
                  layer.bias.grad)
        shapes = res.setdefault("shape", [])
        shapes.append(list(out.shape))
    assert res["shape"][0] == res["shape"][1]
    np.testing.assert_array_equal(_np(res[pt][0]), _np(res[pj][0]))
    for a, b in zip(res[pt][1:], res[pj][1:]):
        _close(a, b, CONV_TOL)


def test_functional_convs_and_subm_stride_refusal():
    rng = np.random.RandomState(8)
    idx = _sites(rng, 1, 4, 4, 4, 10)
    vals = rng.randn(10, 2).astype("float32")
    w = rng.randn(1, 3, 3, 2, 3).astype("float32")      # 9 offsets
    w2 = rng.randn(2, 2, 2, 2, 3).astype("float32")
    b = rng.randn(3).astype("float32")
    outs = []
    for P in (pj, pt):
        x = P.sparse.sparse_coo_tensor(P.to_tensor(idx), P.to_tensor(vals),
                                       [1, 4, 4, 4, 2])
        o1 = P.sparse.nn.functional.subm_conv3d(x, P.to_tensor(w),
                                                P.to_tensor(b),
                                                padding=(0, 1, 1))
        o2 = P.sparse.nn.functional.conv3d(x, P.to_tensor(w2), None,
                                           stride=2, padding=1)
        outs.append((o1.values(), o2.indices(), o2.values()))
        assert o2.shape == [1, 3, 3, 3, 3]
        with pytest.raises(NotImplementedError):
            P.sparse.nn.functional.subm_conv3d(x, P.to_tensor(w), stride=2)
        with pytest.raises(NotImplementedError):
            P.sparse.nn.SubmConv3D(2, 3, 3, stride=2)
    for a, b_ in zip(outs[1], outs[0]):
        _close(a, b_, CONV_TOL)


# ------------------------------------------------------- nn functionals
def test_activations_softmax_pool_bn():
    rng = np.random.RandomState(9)
    vals = rng.randn(6).astype("float32") * 4
    ind = [[0, 0, 1, 2, 2, 2], [0, 2, 1, 0, 1, 3]]
    res = {}
    for P in (pj, pt):
        F = P.sparse.nn.functional
        x = P.sparse.sparse_coo_tensor(ind, vals, [3, 4])
        out = [F.relu(x).values(), F.relu6(x).values(),
               F.leaky_relu(x, 0.2).values(),
               P.sparse.nn.ReLU()(x).values(),
               P.sparse.nn.ReLU6()(x).values(),
               P.sparse.nn.LeakyReLU(0.1)(x).values(),
               F.softmax(x).values(), F.softmax(x.to_sparse_csr()).values(),
               P.sparse.nn.Softmax()(x.to_sparse_csr()).values()]
        res[P] = out
    for a, b in zip(res[pt], res[pj]):
        _close(a, b)


def test_max_pool3d_and_batchnorm():
    rng = np.random.RandomState(10)
    idx = _sites(rng, 2, 6, 6, 6, 40)
    vals = rng.randn(40, 3).astype("float32")
    res = {}
    for P in (pj, pt):
        x = P.sparse.sparse_coo_tensor(P.to_tensor(idx), P.to_tensor(vals),
                                       [2, 6, 6, 6, 3])
        p1 = P.sparse.nn.functional.max_pool3d(x, 3, stride=2, padding=1)
        p2 = P.sparse.nn.MaxPool3D(2)(x)
        bn = P.sparse.nn.BatchNorm(3)
        bn.train()
        o = bn(x)
        res[P] = (p1.indices(), p1.values(), p2.indices(), p2.values(),
                  o.values(), bn._bn._mean, bn._bn._variance)
        assert p1.shape == [2, 3, 3, 3, 3]
    for a, b in zip(res[pt], res[pj]):
        _close(a, b, 1e-5)


def test_sparse_attention():
    rng = np.random.RandomState(11)
    B, H, S, D = 2, 2, 6, 4
    q, k, v = (rng.randn(B, H, S, D).astype("float32") for _ in range(3))
    pattern = (rng.rand(S, S) > 0.5).astype("float32")
    np.fill_diagonal(pattern, 1.0)
    kpm = np.ones((B, S), "float32")
    kpm[1, -2:] = 0
    am = rng.randn(S, S).astype("float32") * 0.1
    res = {}
    for P in (pj, pt):
        mask = P.sparse.to_sparse_coo(P.to_tensor(pattern)).to_sparse_csr()
        res[P] = P.sparse.nn.functional.attention(
            P.to_tensor(q), P.to_tensor(k), P.to_tensor(v), mask,
            key_padding_mask=P.to_tensor(kpm), attn_mask=P.to_tensor(am))
    _close(res[pt], res[pj], 1e-5)
