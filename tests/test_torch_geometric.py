"""The port's `geometric` and `incubate.operators` against the JAX
package's on the CPU, on the same seeded numpy inputs.

* Segment and message-passing reductions (sum, mean, max, min) with an
  empty segment (reads 0) and ±inf inputs (a max or min whose result is
  not finite reads 0, as the reference's `jnp.where(isfinite)`), values
  within 1e-6 and input gradients within 1e-6 (f32; scatter sums may add
  in another order). Max / min gradients are compared on inputs without
  ties.
* The graph sampler, k-hop sampler and reindexing are numpy in both
  packages: under the same `np.random.seed` their outputs are equal.
* `softmax_mask_fuse`, its upper-triangle form and `identity_loss` within
  1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt

TOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _graph(seed=0, n=7, e=19, f=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype("float32")     # no ties: max/min grads
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n - 2, e)            # rows n-2, n-1 stay empty
    y = rng.randn(e, f).astype("float32")
    return x, src, dst, y


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_send_u_recv_values_and_grads(op):
    x, src, dst, _ = _graph()
    outs = {}
    for P in (pj, pt):
        xt = P.to_tensor(x, stop_gradient=False)
        o = P.geometric.send_u_recv(xt, src, dst, reduce_op=op,
                                    out_size=x.shape[0])
        (o * o).sum().backward()
        outs[P] = (o, xt.grad)
    _close(outs[pt][0], outs[pj][0])
    _close(outs[pt][1], outs[pj][1])
    assert not _np(outs[pt][0])[-2:].any()     # empty segments read 0


@pytest.mark.parametrize("msg", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_send_ue_recv(msg, op):
    x, src, dst, y = _graph(1)
    if msg == "div":
        y = np.abs(y) + 0.5
    outs = {}
    for P in (pj, pt):
        xt = P.to_tensor(x, stop_gradient=False)
        yt = P.to_tensor(y, stop_gradient=False)
        o = P.geometric.send_ue_recv(xt, yt, src, dst, message_op=msg,
                                     reduce_op=op)
        o.sum().backward()
        outs[P] = (o, xt.grad, yt.grad)
    for a, b in zip(outs[pt], outs[pj]):
        _close(a, b, 1e-5)


def test_send_uv():
    x, src, dst, _ = _graph(2)
    y = x[::-1].copy()
    for msg in ("add", "sub", "mul", "div"):
        yy = np.abs(y) + 0.5 if msg == "div" else y
        got = pt.geometric.send_uv(pt.to_tensor(x), pt.to_tensor(yy),
                                   pt.to_tensor(src), pt.to_tensor(dst),
                                   message_op=msg)
        want = pj.geometric.send_uv(pj.to_tensor(x), pj.to_tensor(yy),
                                    pj.to_tensor(src), pj.to_tensor(dst),
                                    message_op=msg)
        _close(got, want)


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops_with_empty_segment_and_inf(fn):
    x = np.asarray([[1., -2.], [3., np.inf], [-np.inf, 4.], [5., 6.],
                    [7., -8.]], np.float32)
    seg = np.asarray([0, 0, 1, 3, 3])          # segment 2 is empty
    got = getattr(pt.geometric, fn)(pt.to_tensor(x), seg)
    want = getattr(pj.geometric, fn)(pj.to_tensor(x), seg)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not _np(got)[2].any()
    if fn in ("segment_max", "segment_min"):
        # the infinite results read 0 as well
        assert np.isfinite(_np(got)).all()
    # the incubate re-exports are the same functions
    assert getattr(pt.incubate, fn) is getattr(pt.geometric, fn)


def test_segment_grads():
    rng = np.random.RandomState(3)
    x = rng.randn(9, 4).astype("float32")
    seg = np.asarray([0, 0, 0, 1, 1, 3, 3, 3, 3])
    for fn in ("segment_sum", "segment_mean", "segment_max",
               "segment_min"):
        grads = []
        for P in (pj, pt):
            xt = P.to_tensor(x, stop_gradient=False)
            getattr(P.incubate, fn)(xt, seg).sum().backward()
            grads.append(xt.grad)
        _close(grads[1], grads[0])


def _csc(seed=0, n=12, deg=6):
    rng = np.random.RandomState(seed)
    cnt = rng.randint(0, deg, n)
    colptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    row = rng.randint(0, n, colptr[-1]).astype(np.int64)
    return row, colptr


@pytest.mark.parametrize("k", [-1, 2, 3])
def test_sample_neighbors_same_numpy_stream(k):
    row, colptr = _csc()
    nodes = np.asarray([0, 3, 5, 7, 11], np.int64)
    eids = np.arange(len(row), dtype=np.int64) * 10
    res = {}
    for P in (pj, pt):
        np.random.seed(11)
        res[P] = P.geometric.sample_neighbors(
            P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes),
            sample_size=k, eids=P.to_tensor(eids), return_eids=True)
    for a, b in zip(res[pt], res[pj]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_khop_and_reindex():
    row, colptr = _csc(1)
    nodes = np.asarray([1, 4, 9], np.int64)
    res = {}
    for P in (pj, pt):
        np.random.seed(5)
        kh = P.incubate.graph_khop_sampler(P.to_tensor(row),
                                           P.to_tensor(colptr),
                                           P.to_tensor(nodes), [3, 2])
        np.random.seed(5)
        nb, cnt = P.incubate.graph_sample_neighbors(
            P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes),
            sample_size=3)
        ri = P.geometric.reindex_graph(P.to_tensor(nodes), nb, cnt)
        rh = P.geometric.reindex_heter_graph(P.to_tensor(nodes), [nb, nb],
                                             [cnt, cnt])
        res[P] = list(kh) + list(ri) + list(rh)
    for a, b in zip(res[pt], res[pj]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_graph_send_recv_alias():
    x, src, dst, _ = _graph(4)
    got = pt.incubate.graph_send_recv(pt.to_tensor(x), src, dst,
                                      pool_type="mean")
    want = pj.incubate.graph_send_recv(pj.to_tensor(x), src, dst,
                                       pool_type="mean")
    _close(got, want)


def test_softmax_mask_fuse_and_identity_loss():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 5, 5).astype("float32")
    mask = np.where(rng.rand(2, 1, 5, 5) > 0.3, 0.0, -1e4).astype("float32")
    _close(pt.incubate.softmax_mask_fuse(pt.to_tensor(x), pt.to_tensor(mask)),
           pj.incubate.softmax_mask_fuse(pj.to_tensor(x), pj.to_tensor(mask)))
    _close(pt.incubate.softmax_mask_fuse_upper_triangle(pt.to_tensor(x)),
           pj.incubate.softmax_mask_fuse_upper_triangle(pj.to_tensor(x)))
    for red in (0, 1, 2, "sum", "mean", "none"):
        _close(pt.incubate.identity_loss(pt.to_tensor(x), red),
               pj.incubate.identity_loss(pj.to_tensor(x), red), 1e-5)
