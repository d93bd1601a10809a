"""The port's `incubate` (autograd, optimizers, the fused transformer,
ASP, checkpoint) against the JAX package's on the CPU, on the same seeded
numpy inputs, with the JAX Layers' weights carried across by
`set_state_dict` (their `state_dict` names are equal).

* `vjp`, `jvp`, `Jacobian`, `Hessian` (torch.func there, jax here):
  within 1e-5.
* `minimize_lbfgs` / `minimize_bfgs`: the iterate, objective, gradient and
  function-call count after 1, 3 and 6 iterations on Rosenbrock from
  (-1.2, 1) and on a quadratic, within 1e-4 relative (f32 line searches
  on two libraries); convergence to the minimum. `LookAhead` and
  `ModelAverage` over SGD: parameters within 1e-6 after 7 steps.
* The fused functionals (eval: no dropout) within 1e-5; the dropout draws
  of the port held by contract (the same seed, the same mask; the kept
  fraction). `FusedFeedForward`, `FusedLinear`,
  `FusedBiasDropoutResidualLayerNorm` and `FusedMultiTransformer`
  (forward, and decode steps over the caches) within 1e-5;
  `fused_linear_cross_entropy` and its gradients within 1e-5.
* ASP: `create_mask` equal to the reference's (ties included),
  `prune_model` and a decorated optimizer keep 2:4 and equal weights.
* `incubate.checkpoint`: an epoch range the JAX package saved resumes in
  the port (the two packages' files are one format) and the reverse.
"""
import numpy as np
import pytest

import paddle_tpu as pj
import paddle_tpu_torch as pt
from torch_jax_init import numpy_initializers

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture
def uncached(monkeypatch):
    """Closures of the reference's functionals hold per-call objects: run
    the JAX ops uncached, so a recycled id never serves another's
    program."""
    import paddle_tpu.core.tensor as T
    monkeypatch.setattr(T, "eager_op_cache_enabled", False)


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _carry(src, dst):
    assert list(dst.state_dict()) == list(src.state_dict())
    missing, unexpected = dst.set_state_dict(
        {k: _np(v) for k, v in src.state_dict().items()})
    assert not missing and not unexpected


# ------------------------------------------------------------- autograd
def test_vjp_jvp_jacobian_hessian():
    rng = np.random.RandomState(0)
    x = rng.rand(3).astype("float32")
    y = rng.rand(3).astype("float32")
    v = rng.rand(3).astype("float32")

    def f(a, b):
        return a * a * b + a.sin()

    res = {}
    for P in (pj, pt):
        ia = P.incubate.autograd
        xs = [P.to_tensor(x), P.to_tensor(y)]
        o, g = ia.vjp(f, xs, [P.to_tensor(v)])
        o2, t = ia.jvp(f, xs, [P.to_tensor(v), P.to_tensor(v)])
        J = ia.Jacobian(f, xs)
        H = ia.Hessian(lambda a: (a * a * a).sum(), P.to_tensor(x))
        o3, g1 = ia.vjp(lambda a: (a * a).sum(), P.to_tensor(x))
        res[P] = [o, *g, o2, t, J[:], H[:], o3, g1]
        assert J.shape == [3, 6] and H.shape == [3, 3]
    for a, b in zip(res[pt], res[pj]):
        _close(a, b)
    pt.incubate.autograd.enable_prim()
    assert pt.incubate.autograd.prim_enabled()
    pt.incubate.autograd.disable_prim()
    with pytest.raises(RuntimeError):
        pt.incubate.autograd.forward_grad(None, None)


def test_incubate_autograd_grad_alias():
    x = pt.to_tensor(np.float32([1.0, 2.0]), stop_gradient=False)
    g, = pt.incubate.autograd.grad([(x * x).sum()], [x])
    np.testing.assert_allclose(_np(g), [2.0, 4.0])


# ----------------------------------------------------------- minimizers
def _rosen(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


_A = np.asarray([[3., 1.], [1., 2.]], np.float32)
_B = np.asarray([1., -1.], np.float32)


def _quad(P):
    def q(x):
        return 0.5 * P.matmul(P.matmul(x.reshape([1, 2]), P.to_tensor(_A)),
                              x.reshape([2, 1])).sum() - \
            (P.to_tensor(_B) * x).sum()
    return q


@pytest.mark.parametrize("which", ["lbfgs", "bfgs"])
@pytest.mark.parametrize("problem", ["rosen", "quad"])
def test_minimizer_iterates(which, problem):
    x0 = np.asarray([-1.2, 1.0] if problem == "rosen" else [0.0, 0.0],
                    np.float32)
    for iters in (1, 3, 6):
        res = {}
        for P in (pj, pt):
            fn = getattr(P.incubate.optimizer.functional,
                         f"minimize_{which}")
            obj = _rosen if problem == "rosen" else _quad(P)
            res[P] = fn(obj, P.to_tensor(x0), max_iters=iters)
        assert int(_np(res[pt].num_func_calls)) == \
            int(_np(res[pj].num_func_calls))
        assert bool(_np(res[pt].is_converge)) == \
            bool(_np(res[pj].is_converge))
        for k in ("x", "fx", "g"):
            np.testing.assert_allclose(_np(getattr(res[pt], k)),
                                       _np(getattr(res[pj], k)),
                                       rtol=1e-4, atol=1e-5)


def test_minimizers_converge():
    r = pt.incubate.optimizer.functional.minimize_lbfgs(
        _rosen, pt.to_tensor(np.float32([-1.2, 1.0])), max_iters=1000)
    np.testing.assert_allclose(_np(r.x), [1.0, 1.0], atol=1e-2)
    r = pt.incubate.optimizer.functional.minimize_bfgs(
        _quad(pt), pt.to_tensor(np.zeros(2, np.float32)), max_iters=100)
    np.testing.assert_allclose(_np(r.x), np.linalg.solve(_A, _B), atol=1e-4)


def _net(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.Tanh(),
                           P.nn.Linear(8, 2))


def test_lookahead_and_model_average():
    rng = np.random.RandomState(1)
    xs = rng.rand(7, 5, 4).astype("float32")
    with numpy_initializers():
        pj.seed(0)
        jnet = _net(pj)
    tnet = _net(pt)
    _carry(jnet, tnet)
    res = {}
    for P, net in ((pj, jnet), (pt, tnet)):
        la = P.incubate.LookAhead(P.optimizer.SGD(0.1, parameters=
                                                  net.parameters()),
                                  alpha=0.5, k=3)
        ma = P.incubate.ModelAverage(0.15, parameters=net.parameters(),
                                     max_average_window=4)
        for x in xs:
            (net(P.to_tensor(x)) ** 2).mean().backward()
            la.step()
            la.clear_grad()
            ma.step()
        stepped = [p.numpy() for p in net.parameters()]
        with ma.apply():
            averaged = [p.numpy() for p in net.parameters()]
        restored = [p.numpy() for p in net.parameters()]
        res[P] = stepped + averaged + restored
        assert la.state_dict()["LookAhead"]["count"] == 7
    for a, b in zip(res[pt], res[pj]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ fused ops
def _fused_inputs(seed=2, B=2, S=5, H=8, nh=2, F=16):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.3).astype("float32")  # noqa: E731
    return dict(x=r(B, S, H), res=r(B, S, H), qkvw=r(3, nh, H // nh, H),
                qkvb=r(3, nh, H // nh), lw=r(H, H), lb=r(H), g=r(H) + 1,
                b=r(H), w1=r(H, F), b1=r(F), w2=r(F, H), b2=r(H),
                mask=np.triu(np.full((S, S), -1e4, "float32"), 1))


def _run_fused(P, d):
    Fn = P.incubate.nn.functional
    T = lambda k: P.to_tensor(d[k])  # noqa: E731
    out = [Fn.fused_matmul_bias(T("x"), T("lw"), T("lb")),
           Fn.fused_matmul_bias(T("x"), T("lw"), None, transpose_y=True),
           Fn.fused_linear(T("x"), T("lw"), T("lb")),
           Fn.fused_bias_dropout_residual_layer_norm(
               T("x"), T("res"), T("b"), T("g"), T("b"), training=False),
           Fn.fused_multi_head_attention(
               T("x"), T("qkvw"), T("lw"), pre_layer_norm=True,
               pre_ln_scale=T("g"), pre_ln_bias=T("b"), qkv_bias=T("qkvb"),
               linear_bias=T("lb"), attn_mask=T("mask"), training=False),
           Fn.fused_multi_head_attention(
               T("x"), T("qkvw"), T("lw"), ln_scale=T("g"), ln_bias=T("b"),
               training=False),
           Fn.fused_feedforward(T("x"), T("w1"), T("w2"), T("b1"), T("b2"),
                                ln2_scale=T("g"), ln2_bias=T("b"),
                                activation="gelu", training=False),
           Fn.fused_feedforward(T("x"), T("w1"), T("w2"), ln1_scale=T("g"),
                                ln1_bias=T("b"), pre_layer_norm=True,
                                activation="relu", training=False)]
    L = 2
    out.append(Fn.fused_multi_transformer(
        T("x"), [T("g")] * L, [T("b")] * L, [T("qkvw")] * L,
        [T("qkvb")] * L, [T("lw")] * L, [T("lb")] * L, [T("g")] * L,
        [T("b")] * L, [T("w1")] * L, [T("b1")] * L, [T("w2")] * L,
        [T("b2")] * L, attn_mask=T("mask")))
    return out


def test_fused_functionals(uncached):
    d = _fused_inputs()
    for a, b in zip(_run_fused(pt, d), _run_fused(pj, d)):
        _close(a, b)


def test_fused_dropout_contract():
    import torch
    Fn = pt.incubate.nn.functional
    ones = torch.ones((256, 256))
    draws = []
    for s in (3, 3, 4):
        pt.seed(s)
        draws.append(Fn._dropout(ones, 0.25, True, "upscale_in_train"))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    kept = (draws[0] != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.all(draws[0][draws[0] != 0] == 1 / 0.75)
    pt.seed(5)
    d = Fn._dropout(ones, 0.25, True, "downscale_in_infer")
    assert set(torch.unique(d).tolist()) == {0.0, 1.0}
    assert torch.equal(Fn._dropout(ones, 0.25, False, "downscale_in_infer"),
                       ones * 0.75)
    # the public functionals draw from the same generator
    x = pt.to_tensor(np.random.RandomState(0).rand(4, 8).astype("float32"))
    w = pt.to_tensor(np.eye(8, dtype="float32"))
    outs = []
    for s in (7, 7):
        pt.seed(s)
        outs.append(_np(Fn.fused_feedforward(x, w, w, dropout1_rate=0.5,
                                             training=True)))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_fused_linear_cross_entropy(uncached):
    rng = np.random.RandomState(3)
    h = rng.randn(2, 3, 8).astype("float32")
    w = (rng.randn(16, 8) * 0.3).astype("float32")
    lab = rng.randint(0, 16, (2, 3))
    res = {}
    for P in (pj, pt):
        ht = P.to_tensor(h, stop_gradient=False)
        wt = P.to_tensor(w, stop_gradient=False)
        out = [P.incubate.nn.functional.fused_linear_cross_entropy(
            ht, wt, P.to_tensor(lab), num_chunks=4, reduction=r)
            for r in ("mean", "sum", "none")]
        out[0].backward()
        res[P] = out + [ht.grad, wt.grad]
    for a, b in zip(res[pt], res[pj]):
        _close(a, b)


def _fmt(P, layers=2):
    return P.incubate.nn.FusedMultiTransformer(
        embed_dim=16, num_heads=4, dim_feedforward=32, num_layers=layers)


def test_fused_layers():
    rng = np.random.RandomState(4)
    x = rng.rand(2, 4, 16).astype("float32")
    r = rng.rand(2, 4, 16).astype("float32")
    makers = [
        lambda P: P.incubate.nn.FusedFeedForward(16, 32, dropout_rate=0.0),
        lambda P: P.incubate.nn.FusedFeedForward(
            16, 32, dropout_rate=0.0, activation="gelu",
            normalize_before=True),
        lambda P: P.incubate.nn.FusedLinear(16, 8),
    ]
    for make in makers:
        with numpy_initializers():
            pj.seed(0)
            jl = make(pj)
        tl = make(pt)
        _carry(jl, tl)
        jl.eval()
        tl.eval()
        _close(tl(pt.to_tensor(x)), jl(pj.to_tensor(x)))
    with numpy_initializers():
        jl = pj.incubate.nn.FusedBiasDropoutResidualLayerNorm(16, 0.0)
    tl = pt.incubate.nn.FusedBiasDropoutResidualLayerNorm(16, 0.0)
    _carry(jl, tl)
    jl.eval()
    tl.eval()
    _close(tl(pt.to_tensor(x), pt.to_tensor(r)),
           jl(pj.to_tensor(x), pj.to_tensor(r)))
    assert tl.extra_repr() == "embed_dim=16"


def test_fused_multi_transformer_forward_and_decode():
    with numpy_initializers():
        pj.seed(0)
        jm = _fmt(pj)
    tm = _fmt(pt)
    _carry(jm, tm)
    jm.eval()
    tm.eval()
    rng = np.random.RandomState(2)
    x = rng.rand(2, 4, 16).astype("float32")
    mask = np.triu(np.full((4, 4), -1e9, "float32"), 1)
    res = {}
    for P, m in ((pj, jm), (pt, tm)):
        xt = P.to_tensor(x)
        out = [m(xt, attn_mask=P.to_tensor(mask))]
        # prefill through fresh caches, then decode steps over them
        o, caches = m(xt[:, :3], attn_mask=P.to_tensor(mask[:3, :3]),
                      caches=[None, None])
        out.append(o)
        for t in range(3, 4):
            o, caches = m(xt[:, t:t + 1], caches=caches)
            out.append(o)
        out += [caches[0].k, caches[1].v]
        res[P] = out
        assert tuple(caches[0].k.shape) == (2, 4, 4, 4)
    for a, b in zip(res[pt], res[pj]):
        _close(a, b)
    # decoding over the caches equals the causal full-sequence forward
    np.testing.assert_allclose(_np(res[pt][2]), _np(res[pt][0])[:, 3:4],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        pt.incubate.nn.FusedMultiTransformer(16, 4, 32, num_layers=1,
                                             normalize_before=False)


# ------------------------------------------------------------------ ASP
def test_asp_masks_equal_the_reference():
    rng = np.random.RandomState(5)
    w = rng.rand(8, 18).astype("float32")
    w[0, :4] = 0.5                                  # ties
    w[1, 4:8] = np.float32([0.3, -0.3, 0.3, 0.1])
    for n, m in ((2, 4), (1, 4), (4, 8)):
        mt = pt.incubate.asp.create_mask(w, n, m)
        mj = pj.incubate.asp.create_mask(w, n, m)
        np.testing.assert_array_equal(mt, mj)
        assert pt.incubate.asp.check_sparsity(w * mt, n, m)
    assert pt.incubate.asp.calculate_density(w * mt) == \
        pj.incubate.asp.calculate_density(w * mj)
    assert pt.static.sparsity.decorate is pt.incubate.asp.decorate


def test_asp_prune_and_decorated_steps():
    rng = np.random.RandomState(6)
    x = rng.rand(16, 8).astype("float32")
    y = rng.randint(0, 4, 16)

    def make(P):
        return P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                               P.nn.Linear(16, 4))
    with numpy_initializers():
        pj.seed(2)
        jnet = make(pj)
    tnet = make(pt)
    _carry(jnet, tnet)
    res = {}
    for P, net in ((pj, jnet), (pt, tnet)):
        asp = P.incubate.asp
        asp.reset_excluded_layers()
        asp.set_excluded_layers(param_names=["2.weight"])
        pruned = asp.prune_model(net)
        asp.reset_excluded_layers()
        assert sorted(pruned) == ["0.weight"]
        o = asp.decorate(P.optimizer.SGD(0.1, parameters=net.parameters()))
        lf = P.nn.CrossEntropyLoss()
        for _ in range(3):
            lf(net(P.to_tensor(x)), P.to_tensor(y)).backward()
            o.step()
            o.clear_grad()
        assert asp.check_sparsity(net[0].weight.numpy())
        assert not asp.check_sparsity(net[2].weight.numpy())
        res[P] = [p.numpy() for p in net.parameters()]
    for a, b in zip(res[pt], res[pj]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    pt.static.sparsity.add_supported_layer("MyLayer")
    assert pt.incubate.asp._SUPPORTED_LAYERS[-1] == ("MyLayer", None)


# ----------------------------------------------------------- checkpoint
def _train_epochs(P, net, save_dir, upto, name="job"):
    seen = []
    o = P.optimizer.SGD(0.1, parameters=net.parameters())
    for ep in P.incubate.checkpoint.train_epoch_range(
            upto, name=name, save_dir=save_dir, layers=[net],
            optimizers=[o]):
        seen.append(ep)
        x = P.to_tensor(np.full((2, 4), ep + 1, "float32"))
        (net(x) ** 2).mean().backward()
        o.step()
        o.clear_grad()
    return seen


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, first):
    P1, P2 = (pj, pt) if first == "jax" else (pt, pj)
    with numpy_initializers():
        pj.seed(3)
        init = {k: _np(v) for k, v in pj.nn.Linear(4, 2).state_dict().items()}

    def linear(P):
        with numpy_initializers():
            net = P.nn.Linear(4, 2)
        net.set_state_dict(init)
        return net

    assert _train_epochs(P1, linear(P1), str(tmp_path), 2) == [0, 1]
    st = P2.incubate.checkpoint.ExeTrainStatus("job", str(tmp_path))
    assert st.last_epoch() == 1
    # the second package resumes at epoch 2 from the first one's weights
    resumed = linear(P2)
    assert _train_epochs(P2, resumed, str(tmp_path), 4) == [2, 3]
    assert P2.incubate.checkpoint.ExeTrainStatus(
        "job", str(tmp_path)).last_epoch() == 3
    # the same four epochs in one package
    ref = linear(P1)
    assert _train_epochs(P1, ref, str(tmp_path / "ref"), 4) == [0, 1, 2, 3]
    for a, b in zip(resumed.parameters(), ref.parameters()):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
