"""The tape on torch autograd: `backward`, `grad`, hooks, create_graph,
`PyLayer`, `jacobian` / `hessian`, and the engine's in-place contracts,
each held against the JAX package's tape on the same inputs (CPU).

Oracles: `tests/test_autograd.py`, `test_inplace_ops.py`,
`test_pylayer_context.py` and the numerical half of `test_eager_cache.py`
of the JAX package, ported case by case (their nn.functional cases wait
for ROADMAP 13b)."""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt


@pytest.fixture(autouse=True)
def cpu():
    pt.set_device("cpu")
    yield


def both(fn):
    return fn(pt), fn(pj)


def close(a, b, rtol=1e-6):
    """Two Tensors / arrays / lists of them (None allowed) agree."""
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y, rtol)
        return
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    np.testing.assert_allclose(np.asarray(a.numpy() if hasattr(a, "numpy")
                                          else a),
                               np.asarray(b.numpy() if hasattr(b, "numpy")
                                          else b), rtol=rtol, atol=rtol)


def leaf(P, a):
    return P.to_tensor(np.asarray(a, np.float32), stop_gradient=False)


# ---------------------------------------------------------------- backward
def test_simple_chain():
    def fn(P):
        x = leaf(P, [2.0, 3.0])
        (x * x).sum().backward()
        return x.grad
    got, want = both(fn)
    close(got, want)
    close(got, np.array([4.0, 6.0]))


def test_grad_accumulation_and_clear():
    def fn(P):
        x = leaf(P, np.ones(3))
        (x * 2).sum().backward()
        (x * 3).sum().backward()
        g = x.grad
        x.clear_grad()
        return g, x.grad
    got, want = both(fn)
    close(got, want)
    assert got[1] is None


@pytest.mark.parametrize("name,fn,shapes", [
    ("broadcast_add", lambda P, a, b: a + b, [(3, 4), (4,)]),
    ("broadcast_mul", lambda P, a, b: a * b, [(2, 1, 4), (3, 1)]),
    ("matmul", lambda P, a, b: P.matmul(a, b), [(3, 4), (4, 2)]),
    ("tanh", lambda P, a: P.tanh(a), [(3, 3)]),
    ("exp", lambda P, a: P.exp(a), [(3, 3)]),
    ("softmax", lambda P, a: P.exp(a - P.logsumexp(a, -1, True)), [(2, 5)]),
    ("mean_axis", lambda P, a: P.mean(a, axis=0), [(3, 4)]),
    ("sum_sq", lambda P, a: P.sum(a * a, axis=1), [(3, 4)]),
    ("mlp", lambda P, x, w: P.maximum(P.matmul(x, w), 0.0).sum(1),
     [(4, 3), (3, 5)]),
    ("ce", lambda P, z, y: (P.logsumexp(z, -1) - P.take_along_axis(
        z, y, 1).squeeze(1)).mean(), [(4, 5), "labels"]),
])
def test_gradients_match_jax(name, fn, shapes):
    rng = np.random.RandomState(0)

    def run(P):
        ins = []
        for s in shapes:
            if s == "labels":
                ins.append(P.to_tensor(np.array([[0], [2], [1], [4]])))
            else:
                ins.append(leaf(P, rng.randn(*s) * 0.5))
        out = fn(P, *ins)
        out.backward(P.ones(out.shape) if out.ndim else None)
        return [t.grad for t in ins if not t.stop_gradient]
    rng = np.random.RandomState(0)
    got = run(pt)
    rng = np.random.RandomState(0)
    want = run(pj)
    close(got, want, 1e-5)


def test_indexing_grad():
    def fn(P):
        x = leaf(P, np.arange(6).reshape(2, 3))
        x[0].sum().backward()
        return x.grad
    got, want = both(fn)
    close(got, want)
    close(got, np.array([[1, 1, 1], [0, 0, 0]]))


def test_stop_gradient_and_detach():
    def fn(P):
        x = leaf(P, np.ones(3))
        y = P.to_tensor(np.ones(3, np.float32))
        (x * y).sum().backward()
        d = (x * 2).detach()
        return x.grad, y.grad, d.stop_gradient, (x.detach() * 3).stop_gradient
    got, want = both(fn)
    close(got[:2], want[:2])
    assert got[2:] == want[2:] == (True, True)


def test_no_grad_records_nothing():
    def fn(P):
        x = leaf(P, np.ones(3))
        with P.no_grad():
            y = (x * 2).sum()
        z = x * 2

        @P.no_grad()
        def f(t):
            return t * 3
        return y.stop_gradient, f(x).stop_gradient, z.stop_gradient
    got, want = both(fn)
    assert got == want == (True, True, False)
    assert pt.is_grad_enabled()
    pt.set_grad_enabled(False)
    try:
        assert (leaf(pt, [1.0]) * 2).is_leaf
    finally:
        pt.set_grad_enabled(True)
    with pt.no_grad():
        with pt.enable_grad():
            assert not (leaf(pt, [1.0]) * 2).stop_gradient


def test_multi_output_and_shared_subexpression():
    def fn(P):
        x = leaf(P, np.random.RandomState(1).rand(3, 4))
        vals, _ = P.topk(x, 2, axis=1)
        vals.sum().backward()
        y = leaf(P, [2.0])
        h = y * y
        (h + h).sum().backward()
        return x.grad, y.grad
    got, want = both(fn)
    close(got, want)
    assert float(got[0].numpy().sum()) == pytest.approx(6.0)


def test_backward_nonscalar_with_grad_and_leaf_backward():
    def fn(P):
        x = leaf(P, np.ones((2, 2)))
        y = x * 3
        y.backward(P.to_tensor(np.full((2, 2), 2.0, np.float32)))
        z = leaf(P, [1.0])
        z.backward()                       # a leaf: nothing to sweep
        return x.grad, z.grad
    got, want = both(fn)
    close(got, want)


def test_retain_graph():
    def fn(P):
        x = leaf(P, [1.0, 2.0])
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        return x.grad
    got, want = both(fn)
    close(got, want)
    x = leaf(pt, [1.0])
    y = (x * x).sum()
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()                       # the graph was freed


def test_autograd_backward_many_roots():
    def fn(P):
        x = leaf(P, [1.0, 2.0])
        a, b = (x * x).sum(), (x * 3).sum()
        P.autograd.backward([a, b], [None, P.to_tensor(2.0)])
        return x.grad
    got, want = both(fn)
    close(got, want)


# --------------------------------------------------------------- paddle.grad
def test_grad_api_leaves_dot_grad_alone():
    def fn(P):
        x = leaf(P, [3.0])
        (gx,) = P.grad(x * x, x)
        return gx, x.grad, gx.stop_gradient
    got, want = both(fn)
    close(got[0], want[0])
    assert got[1] is None and want[1] is None
    assert got[2] == want[2] is True


def test_grad_allow_unused_and_zeros():
    def fn(P):
        x, w = leaf(P, [3.0]), leaf(P, [5.0])
        y = (x * 2).sum()
        a = P.autograd.grad(y, [x, w], retain_graph=True, allow_unused=True)
        b = P.autograd.grad(y, [x, w])
        return a[0], a[1], b[0], b[1]
    got, want = both(fn)
    close(got, want)


def test_grad_with_grad_outputs_and_multiple_outputs():
    def fn(P):
        x = leaf(P, [1.0, 2.0, 3.0])
        y1, y2 = x * x, P.sin(x)
        return P.grad([y1, y2], [x], [P.to_tensor(np.array(
            [1.0, 0.5, 2.0], np.float32)), None])
    got, want = both(fn)
    close(got, want, 1e-5)


def test_double_grad_gradient_penalty():
    def fn(P):
        x = leaf(P, [2.0])
        (g,) = P.autograd.grad(x * x * x, x, create_graph=True)
        (g * g).sum().backward()
        return g, x.grad, g.stop_gradient
    got, want = both(fn)
    close(got[:2], want[:2])
    close(got[1], np.array([288.0]))
    assert got[2] == want[2] is False


def test_double_grad_matmul_matches_jax():
    rng = np.random.RandomState(0)
    xv, wv = rng.rand(3, 4), rng.rand(4, 2)

    def fn(P):
        x, w = leaf(P, xv), leaf(P, wv)
        (gx,) = P.autograd.grad(((x @ w) ** 2).sum(), x, create_graph=True)
        (gx ** 2).sum().backward()
        return x.grad, w.grad
    got, want = both(fn)
    close(got, want, 1e-5)


def test_double_grad_cubic_and_split_segments():
    """The numerical half of the JAX package's test_eager_cache.py:
    d2/dx2 of x^3 = 6x, and split() pieces keep their own sections."""
    def fn(P):
        x = leaf(P, [2.0, 3.0])
        y = (x * x * x).sum()
        (gx,) = P.autograd.grad(y, [x], create_graph=True)
        (ggx,) = P.autograd.grad(gx.sum(), [x])
        z = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
        parts = P.split(z, [1, 2], axis=1)
        return ggx, parts[0], parts[1]
    got, want = both(fn)
    close(got, want, 1e-5)
    close(got[0], np.array([12.0, 18.0]))


def test_sgd_loop_matches_jax():
    """The reference's cached-vs-uncached training loop, held here as a
    loss-for-loss match of a small eager MLP with SGD under no_grad."""
    rng = np.random.RandomState(0)
    x0, y0 = rng.rand(16, 8), rng.randint(0, 3, (16, 1))
    w0, w1 = rng.randn(8, 12) * 0.3, rng.randn(12, 3) * 0.3

    def fn(P):
        x = P.to_tensor(x0.astype(np.float32))
        y = P.to_tensor(y0)
        a, b = leaf(P, w0), leaf(P, w1)
        losses = []
        for _ in range(5):
            h = P.maximum(P.matmul(x, a), 0.0)
            z = P.matmul(h, b)
            loss = (P.logsumexp(z, -1) - P.take_along_axis(
                z, y, 1).squeeze(1)).mean()
            loss.backward()
            with P.no_grad():
                a.subtract_(a.grad * 0.5)
                b.subtract_(b.grad * 0.5)
            a.clear_grad()
            b.clear_grad()
            losses.append(float(loss))
        return losses, a, b
    got, want = both(fn)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[0][-1] < got[0][0]
    close(got[1:], want[1:], 1e-5)
    assert not got[1].stop_gradient and got[1].is_leaf


# ------------------------------------------------------------------- hooks
def test_register_hook_scales_grad_and_removes():
    def fn(P):
        x = leaf(P, [1.0, 2.0, 3.0])
        seen = []
        h = x.register_hook(lambda g: seen.append(g.numpy()) or g * 2)
        (x * x).sum().backward()
        g1 = x.grad
        h.remove()
        x.clear_grad()
        (x * x).sum().backward()
        return seen[0], g1, x.grad
    got, want = both(fn)
    close(got, want)


def test_hook_on_intermediate_and_order():
    def fn(P):
        x = leaf(P, [2.0])
        y = x * 3.0
        order = []
        y.register_hook(lambda g: order.append("a") or g * 10.0)
        y.register_hook(lambda g: order.append("b") or g + 1.0)
        (y * y).backward()          # dy = 12 -> 120 -> 121 -> dx = 363
        return x.grad, order, y.grad
    got, want = both(fn)
    close(got[0], want[0])
    close(got[0], np.array([363.0]))
    assert got[1] == want[1] == ["a", "b"]
    assert got[2] is None and want[2] is None      # non-leaf: no .grad


def test_hook_fires_once_with_the_final_gradient():
    def fn(P):
        x = leaf(P, [1.0, 2.0])
        h = x * 2.0
        seen = []
        h.register_hook(lambda g: seen.append(g.numpy().copy()))
        (h * 3.0 + h * h).sum().backward()
        return seen, x.grad
    got, want = both(fn)
    assert len(got[0]) == len(want[0]) == 1
    close(got[0][0], want[0][0])
    close(got[1], want[1])


def test_hook_on_stop_gradient_raises():
    for P in (pt, pj):
        x = P.to_tensor(np.ones(3, np.float32))
        with pytest.raises(RuntimeError, match="stop_gradient=True"):
            x.register_hook(lambda g: g)


# -------------------------------------------------------- in-place + tape
def test_inplace_gradient_flows_through_tape():
    def fn(P):
        x = leaf(P, [0.5, 1.0])
        y = x * 2.0
        y.tanh_()
        y.sum().backward()
        return x.grad, y
    got, want = both(fn)
    close(got, want, 1e-6)


def test_inplace_on_grad_leaf_raises_like_the_reference():
    for P in (pt, pj):
        x = leaf(P, [0.5])
        with pytest.raises(RuntimeError, match="leaf Tensor that requires "
                                               "grad cannot be used in an "
                                               "in-place operation"):
            x.tanh_()
        with pytest.raises(RuntimeError, match="leaf"):
            x[0] = 1.0


def test_inplace_under_no_grad_preserves_trainability():
    def fn(P):
        x = leaf(P, [2.0, -1.0])
        (x * x).sum().backward()
        with P.no_grad():
            x.clip_(0.0, 1.0)
            x.add_(P.to_tensor(np.array([0.5, 0.5], np.float32)))
        g = x.grad                       # the gradient stays with x
        x.clear_grad()
        (x * 3.0).sum().backward()
        return x.stop_gradient, x.is_leaf, x, g, x.grad
    got, want = both(fn)
    assert got[:2] == (False, True) and want[0] is False
    close(got[2:], want[2:])


def test_nonleaf_inplace_under_no_grad_keeps_its_producer():
    def fn(P):
        x = leaf(P, [1.0, 2.0])
        h = x * 2.0
        with P.no_grad():
            h.add_(1.0)
        (h * h).sum().backward()
        return h, x.grad, h.stop_gradient
    got, want = both(fn)
    close(got[:2], want[:2])
    assert got[2] == want[2] is False


def test_inplace_version_mismatch_raises():
    """Changing a tensor in place after an op recorded it raises in
    backward instead of differentiating a value that changed."""
    for P in (pt, pj):
        a = leaf(P, [1.0])
        y = a * 2.0
        z = y * 3.0
        y.tanh_()
        with pytest.raises(RuntimeError, match="version"):
            z.backward()


def test_inplace_version_mismatch_through_a_view():
    for P in (pt, pj):
        a = leaf(P, [1.0, 2.0])
        y = a * 2.0
        v = y.reshape([2, 1])
        y.exp_()
        with pytest.raises(RuntimeError, match="in-place modification"):
            v.sum().backward()


def test_rebound_trainable_leaf_raises_for_an_older_graph():
    for P in (pt, pj):
        w = leaf(P, [1.0, 2.0])
        y = (w * 2.0).sum()
        with P.no_grad():
            w.add_(1.0)
        with pytest.raises(RuntimeError, match="in-place modification"):
            y.backward()


def test_version_counter_and_later_graphs_are_fine():
    def fn(P):
        w = leaf(P, [1.0, 2.0])
        v0 = w._version
        with P.no_grad():
            w.scale_(2.0)
            w.add_(1.0)
        (w * w).sum().backward()
        return w._version - v0, w.grad
    got, want = both(fn)
    assert got[0] == want[0] == 2
    close(got[1], want[1])


# ------------------------------------------------------------------ PyLayer
def _cus_tanh(P):
    class CusTanh(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            y = P.tanh(x)
            ctx.save_for_backward(y)
            return y

        @staticmethod
        def backward(ctx, dy):
            (y,) = ctx.saved_tensor()
            return dy * (1 - P.square(y))
    return CusTanh


def test_pylayer_saved_tensor_callable():
    def fn(P):
        x = leaf(P, [0.3, -0.7])
        y = _cus_tanh(P).apply(x)
        y.sum().backward()
        return y, x.grad
    got, want = both(fn)
    close(got, want)


def test_pylayer_double():
    def fn(P):
        class Double(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, dy):
                return dy * 2
        x = leaf(P, [1.0, 2.0])
        Double.apply(x).sum().backward()
        return x.grad
    got, want = both(fn)
    close(got, want)


def test_pylayer_mark_non_differentiable():
    def fn(P):
        class SplitOut(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                a = x * 2.0
                aux = P.round(x)
                ctx.mark_non_differentiable(aux)
                return a, aux

            @staticmethod
            def backward(ctx, da, daux):
                return da * 2.0
        x = leaf(P, [1.4, 2.6])
        a, aux = SplitOut.apply(x)
        (a.sum() + aux.sum().astype("float32")).backward()
        return aux.stop_gradient, x.grad
    got, want = both(fn)
    assert got[0] is True and want[0] is True
    close(got[1], want[1])


@pytest.mark.parametrize("materialize", [True, False])
def test_pylayer_materialize_grads(materialize):
    def fn(P):
        seen = {}

        class TwoOut(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.set_materialize_grads(materialize)
                return x * 1.0, x * 3.0

            @staticmethod
            def backward(ctx, d0, d1):
                seen["d1"] = None if d1 is None else d1.numpy()
                return d0 * 1.0
        x = leaf(P, [2.0])
        y0, _ = TwoOut.apply(x)
        y0.sum().backward()
        return seen["d1"], x.grad
    got, want = both(fn)
    close(got, want)
    assert (got[0] is None) == (not materialize)


def test_pylayer_none_grad_and_mark_not_inplace():
    def fn(P):
        class TwoIn(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w):
                ctx.mark_not_inplace(x)
                return x * w

            @staticmethod
            def backward(ctx, dy):
                return dy * 2.0, None
        x, w = leaf(P, [3.0]), leaf(P, [5.0])
        TwoIn.apply(x, w).sum().backward()
        return x.grad, w.grad
    got, want = both(fn)
    close(got, want)


def test_pylayer_non_tensor_args_and_no_grad_path():
    def fn(P):
        class Scale(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k, bias=0.0):
                ctx.k = k
                return x * k + bias

            @staticmethod
            def backward(ctx, dy):
                return dy * ctx.k
        x = leaf(P, [1.0, 2.0])
        y = Scale.apply(x, 3.0, bias=1.0)
        y.sum().backward()
        with P.no_grad():
            z = Scale.apply(x, 2.0)
        return y, x.grad, z, z.stop_gradient
    got, want = both(fn)
    close(got[:3], want[:3])
    assert got[3] == want[3] is True


def _sq(P, once, save=True):
    class Sq(P.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            if save:
                ctx.save_for_backward(x)
            return x * x

        def _bw(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 2.0 * x
        backward = staticmethod(P.autograd.once_differentiable(_bw)
                                if once else _bw)
    return Sq


def test_pylayer_create_graph_through_saved_input():
    def fn(P):
        x = leaf(P, [3.0])
        y = _sq(P, once=False).apply(x)
        (g,) = P.autograd.grad(y.sum(), x, create_graph=True)
        (gg,) = P.autograd.grad(g.sum(), x)
        return g, gg
    got, want = both(fn)
    close(got, want)
    close(got[1], np.array([2.0]))


def test_pylayer_once_differentiable_defers_its_error():
    for P in (pt, pj):
        x = leaf(P, [2.0])
        Sq = _sq(P, once=True)
        (g,) = P.autograd.grad(Sq.apply(x).sum(), x)
        close(g, np.array([4.0]))
        (g2,) = P.autograd.grad(Sq.apply(x).sum(), x, create_graph=True)
        close(g2, np.array([4.0]))
        with pytest.raises(RuntimeError, match="once_differentiable"):
            P.autograd.grad(g2.sum(), x)


def test_once_differentiable_above_staticmethod_and_unrelated_branch():
    for P in (pt, pj):
        class Lin(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 3.0

            @P.autograd.once_differentiable
            @staticmethod
            def backward(ctx, dy):
                return dy * 3.0
        x = leaf(P, [2.0])
        loss = Lin.apply(x).sum() + (x * x).sum()
        (g,) = P.autograd.grad(loss, x, create_graph=True)
        close(g, np.array([7.0]))
        with pytest.raises(RuntimeError, match="once_differentiable"):
            P.autograd.grad(g.sum(), x)


def test_pylayer_none_grad_under_create_graph():
    def fn(P):
        class TwoIn(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w):
                ctx.save_for_backward(w)
                return x * w

            @staticmethod
            def backward(ctx, dy):
                (w,) = ctx.saved_tensor()
                return dy * w, None
        x, w = leaf(P, [3.0]), leaf(P, [5.0])
        y = TwoIn.apply(x, w) + w
        return P.autograd.grad(y.sum(), [x, w], create_graph=True,
                               allow_unused=True)
    got, want = both(fn)
    close(got, want)


def test_pylayer_arity_mismatch_raises_the_reference_message():
    for P in (pt, pj):
        class TwoIn(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w):
                return x * w

            @staticmethod
            def backward(ctx, dy):
                return dy * 2.0
        x, w = leaf(P, [3.0]), leaf(P, [5.0])
        y = TwoIn.apply(x, w)
        with pytest.raises(ValueError, match=r"TwoIn.backward returned 1 "
                                             r"gradient\(s\) but forward "
                                             r"took 2 tensor input"):
            y.sum().backward()


# -------------------------------------------------------- jacobian, hessian
def test_jacobian_and_hessian_match_jax():
    rng = np.random.RandomState(0)
    xv, wv = rng.rand(3).astype(np.float32), rng.rand(3, 2).astype(
        np.float32)

    def fn(P):
        x = P.to_tensor(xv)
        w = P.to_tensor(wv)
        j1 = P.autograd.jacobian(lambda a: P.tanh(P.matmul(a, w)), x)
        j2 = P.autograd.jacobian(lambda a, b: P.matmul(a, b), [x, w])
        h = P.autograd.hessian(lambda a: (P.sin(a) * a).sum(), x)
        return j1, j2[0], j2[1], h
    got, want = both(fn)
    close(got, want, 1e-5)


# ------------------------------------------------- PyLayer over a kernel op
def test_flash_pylayer_of_the_chip_smoke_on_the_plain_versions():
    """chip_smoke.py phase 21 (b)'s PyLayer (forward flash_fwd, backward
    flash_dq and flash_dkv) on CPU tensors, where the wrappers run their
    plain versions: output and gradients equal torch autograd through the
    plain forward."""
    import os
    import runpy
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flash_pylayer = runpy.run_path(os.path.join(root, "chip_smoke.py"),
                                   run_name="not_main")["flash_pylayer"]
    meta = fa.Meta(H=2, Hk=2, causal=True, scale=8 ** -0.5)
    g = torch.Generator().manual_seed(0)
    q0, k0, v0, do0 = (torch.randn(4, 16, 8, generator=g) for _ in range(4))
    q, k, v = (pt.to_tensor(t, stop_gradient=False) for t in (q0, k0, v0))
    launches = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o = flash_pylayer(meta).apply(q, k, v)
    o.backward(pt.to_tensor(do0))
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv) == launches
    refs = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    ref = fa.fwd_plain(*refs, None, meta)[0]
    ref.backward(do0)
    close([o, q.grad, k.grad, v.grad],
          [ref.detach()] + [t.grad for t in refs], 1e-5)
