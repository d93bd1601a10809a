"""The port's `distribution` against the JAX package's on the CPU.

* Densities, entropies, KL (the closed forms, `register_kl` dispatch and
  the exponential-family Bregman fallback, whose gradient is torch's
  autograd here and jax.grad there) and every transform's forward,
  inverse and log-det-Jacobian, `TransformedDistribution` and
  `Independent`, on the same seeded numpy inputs: within 1e-5 (f32
  transcendental functions of two libraries).
* Samples are held by their contract (ROADMAP C.14): `jax.random`'s bits
  cannot be drawn in torch, so the same `paddle.seed` gives the same
  stream within the port, a different seed another, and the sample
  moments of 20,000 draws lie within 5 standard errors of the
  distribution's mean and within 10% of its variance (15% for the
  heavy-tailed Laplace and Gumbel).
* `mean`, `variance` and `cdf`, which the port adds, against scipy.stats
  at 1e-5.
"""
import numpy as np
import pytest
import scipy.stats as st

import paddle_tpu as pj
import paddle_tpu_torch as pt

TOL = 1e-5
N = 20000


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    pt.set_device("cpu")
    # the reference's closures hold the distribution or transform they
    # belong to; its eager-op cache keys such closures by identity, and an
    # id recycled after a test's objects are freed would serve another
    # object's executable. Each JAX op here runs uncached.
    import paddle_tpu.core.tensor as T
    monkeypatch.setattr(T, "eager_op_cache_enabled", False)


def _np(t):
    return np.asarray(t.numpy())


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


RNG = np.random.RandomState(0)
LOC = RNG.randn(3).astype("float32")
SCALE = (RNG.rand(3) + 0.5).astype("float32")
PROBS = (RNG.rand(3) * 0.8 + 0.1).astype("float32")
LOGITS = RNG.randn(2, 4).astype("float32")
ALPHA = (RNG.rand(3) * 2 + 0.5).astype("float32")
BETA = (RNG.rand(3) * 2 + 0.5).astype("float32")


def _dists(P):
    D = P.distribution
    return {
        "normal": (D.Normal(LOC, SCALE), RNG.randn(3).astype("float32")),
        "uniform": (D.Uniform(LOC - SCALE, LOC + SCALE),
                    (LOC + 0.3 * SCALE).astype("float32")),
        "bernoulli": (D.Bernoulli(PROBS), np.float32([1, 0, 1])),
        "beta": (D.Beta(ALPHA, BETA), np.float32([0.2, 0.5, 0.9])),
        "categorical": (D.Categorical(P.to_tensor(LOGITS)),
                        np.int64([3, 1])),
    }


@pytest.mark.parametrize("name", ["normal", "uniform", "bernoulli", "beta",
                                  "categorical"])
def test_log_prob_probs_entropy(name):
    dj, v = _dists(pj)[name]
    dt, _ = _dists(pt)[name]
    _close(dt.log_prob(pt.to_tensor(v)), dj.log_prob(pj.to_tensor(v)))
    _close(dt.probs(pt.to_tensor(v)), dj.probs(pj.to_tensor(v)))
    if name != "beta":          # the reference has no Beta entropy
        _close(dt.entropy(), dj.entropy())


def test_log_prob_gradient_through_value():
    outs = []
    for P in (pj, pt):
        v = P.to_tensor(np.float32([0.1, -0.3, 2.0]), stop_gradient=False)
        P.distribution.Normal(LOC, SCALE).log_prob(v).sum().backward()
        outs.append(v.grad)
    _close(outs[1], outs[0])


def test_kl_closed_forms():
    for name, (P_args, Q_args) in {
            "normal": ((LOC, SCALE), (LOC[::-1].copy(), SCALE * 2)),
            "categorical": ((LOGITS,), (LOGITS * 0.5 + 1,))}.items():
        res = []
        for P in (pj, pt):
            cls = P.distribution.Normal if name == "normal" else \
                P.distribution.Categorical
            p = cls(*[P.to_tensor(a) for a in P_args])
            q = cls(*[P.to_tensor(a) for a in Q_args])
            res.append(P.distribution.kl_divergence(p, q))
        _close(res[1], res[0])


def _normal_ef(P):
    class NormalEF(P.distribution.ExponentialFamily):
        """Normal as an exponential family: nat = (mu / s^2, -1/(2 s^2)),
        log-normalizer -n1^2 / (4 n2) - log(-2 n2) / 2."""

        def __init__(self, loc, scale):
            self.loc = P.to_tensor(np.asarray(loc, "float32"))
            self.scale = P.to_tensor(np.asarray(scale, "float32"))

        @property
        def _natural_parameters(self):
            s2 = self.scale * self.scale
            return (self.loc / s2, -0.5 / s2)

        def _log_normalizer(self, n1, n2):
            return -n1 * n1 / (4 * n2) - 0.5 * P.log(-2.0 * n2)

    return NormalEF


def test_expfamily_bregman_kl_and_dispatch():
    res = []
    for P in (pj, pt):
        ef = _normal_ef(P)
        res.append(P.distribution.kl_divergence(ef([0.0, 1.0], [1.0, 2.0]),
                                                ef([0.5, -1.0], [2.0, 1.0])))
    _close(res[1], res[0])
    mu_p, s_p = np.array([0.0, 1.0]), np.array([1.0, 2.0])
    mu_q, s_q = np.array([0.5, -1.0]), np.array([2.0, 1.0])
    expect = (np.log(s_q / s_p) + (s_p ** 2 + (mu_p - mu_q) ** 2) /
              (2 * s_q ** 2) - 0.5)
    np.testing.assert_allclose(_np(res[1]), expect, rtol=TOL)

    D = pt.distribution

    class A(D.Distribution):
        pass

    class B(A):
        pass

    D.register_kl(A, A)(lambda p, q: "aa")
    D.register_kl(B, A)(lambda p, q: "ba")
    assert D.kl_divergence(B(), A()) == "ba"
    assert D.kl_divergence(A(), A()) == "aa"
    assert D.kl_divergence(B(), B()) == "ba"
    with pytest.raises(NotImplementedError):
        D.kl_divergence(D.Uniform(0., 1.), D.Beta(1., 1.))


def _transforms(P):
    D = P.distribution
    return {
        "exp": D.ExpTransform(),
        "abs": D.AbsTransform(),
        "affine": D.AffineTransform(P.to_tensor(LOC), P.to_tensor(-SCALE)),
        "power": D.PowerTransform(P.to_tensor(np.float32(3.0))),
        "sigmoid": D.SigmoidTransform(),
        "tanh": D.TanhTransform(),
        "stick": D.StickBreakingTransform(),
        "reshape": D.ReshapeTransform((2, 3), (3, 2)),
        "independent": D.IndependentTransform(D.SigmoidTransform(), 1),
        "chain": D.ChainTransform([D.AffineTransform(
            P.to_tensor(np.float32(0.5)), P.to_tensor(np.float32(2.0))),
            D.TanhTransform(), D.ExpTransform()]),
        "stack": D.StackTransform([D.ExpTransform(), D.SigmoidTransform()],
                                  axis=0),
    }


@pytest.mark.parametrize("name", ["exp", "abs", "affine", "power",
                                  "sigmoid", "tanh", "stick", "reshape",
                                  "independent", "chain", "stack"])
def test_transforms(name):
    x = (np.random.RandomState(1).rand(2, 3) * 0.8 + 0.1).astype("float32")
    tj, tt = _transforms(pj)[name], _transforms(pt)[name]
    yj = tj.forward(pj.to_tensor(x))
    yt = tt.forward(pt.to_tensor(x))
    _close(yt, yj)
    _close(tt.inverse(yt), tj.inverse(yj))
    _close(tt.forward_log_det_jacobian(pt.to_tensor(x)),
           tj.forward_log_det_jacobian(pj.to_tensor(x)))
    if name not in ("abs", "stick"):
        _close(tt.inverse_log_det_jacobian(yt),
               tj.inverse_log_det_jacobian(yj))


def test_softmax_transform_and_transformed_distribution():
    x = np.random.RandomState(2).randn(2, 4).astype("float32")
    sj, stt = pj.distribution.SoftmaxTransform(), \
        pt.distribution.SoftmaxTransform()
    _close(stt.forward(pt.to_tensor(x)), sj.forward(pj.to_tensor(x)))
    with pytest.raises(NotImplementedError):
        stt.forward_log_det_jacobian(pt.to_tensor(x))
    v = (np.random.RandomState(3).rand(3) * 2 + 0.1).astype("float32")
    res = []
    for P in (pj, pt):
        D = P.distribution
        td = D.TransformedDistribution(D.Normal(LOC, SCALE),
                                       [D.ExpTransform()])
        chain = D.TransformedDistribution(
            D.Normal(LOC, SCALE), [D.AffineTransform(
                P.to_tensor(np.float32(1.0)), P.to_tensor(np.float32(2.0))),
                D.ExpTransform()])
        ind = D.Independent(D.Normal(P.to_tensor(np.stack([LOC, LOC])),
                                     P.to_tensor(np.stack([SCALE, SCALE]))),
                            1)
        res.append((td.log_prob(P.to_tensor(v)),
                    chain.log_prob(P.to_tensor(v)),
                    ind.log_prob(P.to_tensor(np.stack([v, v]))),
                    ind.entropy()))
    for a, b in zip(res[1], res[0]):
        _close(a, b)


def _moments(name):
    D = pt.distribution
    return {
        "normal": (lambda: D.Normal(0.5, 2.0), 0.5, 4.0),
        "uniform": (lambda: D.Uniform(-1.0, 3.0), 1.0, 16 / 12),
        "bernoulli": (lambda: D.Bernoulli(0.3), 0.3, 0.21),
        "beta": (lambda: D.Beta(2.0, 3.0), 0.4, 0.04),
        "gamma": (lambda: D.Gamma(0.5, 2.0), 0.25, 0.125),
        "gamma3": (lambda: D.Gamma(3.0, 0.5), 6.0, 12.0),
        "exponential": (lambda: D.Exponential(2.0), 0.5, 0.25),
        "laplace": (lambda: D.Laplace(1.0, 0.5), 1.0, 0.5),
        "gumbel": (lambda: D.Gumbel(0.0, 1.0), 0.5772157, np.pi ** 2 / 6),
        "poisson": (lambda: D.Poisson(3.0), 3.0, 3.0),
        "lognormal": (lambda: D.LogNormal(0.0, 0.25),
                      np.exp(0.03125), np.expm1(0.0625) * np.exp(0.0625)),
        "categorical": (lambda: D.Categorical(np.float32([0.0, 1.0, 2.0])),
                        None, None),
        "dirichlet": (lambda: D.Dirichlet(np.float32([1.0, 2.0, 3.0])),
                      None, None),
        "multinomial": (lambda: D.Multinomial(5, np.float32([.2, .3, .5])),
                        None, None),
    }[name]


@pytest.mark.parametrize("name", ["normal", "uniform", "bernoulli", "beta",
                                  "gamma", "gamma3", "exponential",
                                  "laplace", "gumbel", "poisson",
                                  "lognormal", "categorical", "dirichlet",
                                  "multinomial"])
def test_sample_stream_and_moments(name):
    make, mean, var = _moments(name)
    pt.seed(123)
    a = _np(make().sample((N,)))
    pt.seed(123)
    b = _np(make().sample((N,)))
    pt.seed(124)
    c = _np(make().sample((N,)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    if name == "categorical":
        p = np.exp([0.0, 1.0, 2.0]) / np.exp([0.0, 1.0, 2.0]).sum()
        mean, var = (p * np.arange(3)).sum(), \
            (p * np.arange(3) ** 2).sum() - (p * np.arange(3)).sum() ** 2
    if name == "dirichlet":
        assert a.shape == (N, 3)
        np.testing.assert_allclose(a.sum(-1), 1.0, rtol=1e-5)
        a = a[:, 2]
        mean, var = 0.5, 0.5 * 0.5 / 7
    if name == "multinomial":
        assert a.shape == (N, 3) and (a.sum(-1) == 5).all()
        a = a[:, 2]
        mean, var = 2.5, 5 * 0.25
    assert abs(a.mean() - mean) < 5 * np.sqrt(var / N), (a.mean(), mean)
    rel = 0.15 if name in ("laplace", "gumbel") else 0.1
    assert abs(a.var() - var) < rel * var, (a.var(), var)
    r = _np(make().rsample((4,))) if hasattr(make(), "rsample") else None
    assert r is None or r.shape[0] == 4


def test_sample_shapes_follow_the_reference_rule():
    """sample(shape) is shape + the parameters' broadcast batch shape
    (Categorical: + the logits' batch, without the class axis), as the
    reference's."""
    D = pt.distribution
    cases = {(5, 2, 3): [D.Normal(LOC, SCALE), D.Bernoulli(PROBS),
                         D.Uniform(LOC - SCALE, LOC + SCALE),
                         D.Beta(ALPHA, BETA), D.Gamma(ALPHA, BETA),
                         D.Laplace(LOC, SCALE), D.Gumbel(LOC, SCALE),
                         D.Exponential(SCALE), D.Poisson(SCALE),
                         D.LogNormal(LOC, SCALE)],
             (5, 2, 2): [D.Categorical(LOGITS)],
             (5, 2, 3, 4): [D.Dirichlet(np.ones((3, 4), "float32")),
                            D.Multinomial(3, np.full((3, 4), 0.25,
                                                     "float32"))]}
    for shape, dists in cases.items():
        for d in dists:
            assert tuple(d.sample((5, 2)).shape) == shape, type(d)
    dj = pj.distribution.Categorical(pj.to_tensor(LOGITS))
    assert tuple(dj.sample((5, 2)).shape) == (5, 2, 2)


def test_mean_variance_cdf_against_scipy():
    D = pt.distribution
    x = np.float32([0.3, 1.1, 2.5])
    cases = [
        (D.Normal(LOC, SCALE), st.norm(LOC, SCALE)),
        (D.Uniform(LOC - SCALE, LOC + SCALE),
         st.uniform(LOC - SCALE, 2 * SCALE)),
        (D.Exponential(SCALE), st.expon(scale=1 / SCALE)),
        (D.Laplace(LOC, SCALE), st.laplace(LOC, SCALE)),
        (D.Gumbel(LOC, SCALE), st.gumbel_r(LOC, SCALE)),
        (D.LogNormal(LOC, SCALE), st.lognorm(SCALE, scale=np.exp(LOC))),
    ]
    for d, ref in cases:
        np.testing.assert_allclose(_np(d.mean), ref.mean(), rtol=TOL)
        np.testing.assert_allclose(_np(d.variance), ref.var(), rtol=TOL)
        np.testing.assert_allclose(_np(d.cdf(x)), ref.cdf(x), rtol=TOL,
                                   atol=TOL)
    for d, ref in ((D.Gamma(ALPHA, BETA), st.gamma(ALPHA, scale=1 / BETA)),
                   (D.Beta(ALPHA, BETA), st.beta(ALPHA, BETA)),
                   (D.Poisson(SCALE), st.poisson(SCALE))):
        np.testing.assert_allclose(_np(d.mean), ref.mean(), rtol=TOL)
        np.testing.assert_allclose(_np(d.variance), ref.var(), rtol=TOL)
    xs = np.float32([0.5, 1.5, 3.0])
    for d, ref in ((D.Gamma(ALPHA, BETA), st.gamma(ALPHA, scale=1 / BETA)),
                   (D.Exponential(SCALE), st.expon(scale=1 / SCALE)),
                   (D.Laplace(LOC, SCALE), st.laplace(LOC, SCALE)),
                   (D.Gumbel(LOC, SCALE), st.gumbel_r(LOC, SCALE)),
                   (D.LogNormal(LOC, SCALE),
                    st.lognorm(SCALE, scale=np.exp(LOC)))):
        np.testing.assert_allclose(_np(d.log_prob(xs)), ref.logpdf(xs),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_np(d.entropy()), ref.entropy(),
                                   rtol=TOL, atol=TOL)
    conc = np.float32([1.0, 2.0, 3.0])
    dd = D.Dirichlet(conc)
    np.testing.assert_allclose(_np(dd.entropy()), st.dirichlet(conc).entropy(),
                               rtol=TOL)
    np.testing.assert_allclose(_np(D.Beta(ALPHA, BETA).entropy()),
                               st.beta(ALPHA, BETA).entropy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_np(D.Poisson(SCALE).log_prob(np.float32(
        [1, 0, 2]))), st.poisson(SCALE).logpmf([1, 0, 2]), rtol=TOL)
