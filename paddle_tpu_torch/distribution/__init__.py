"""paddle.distribution of the port (counterpart of
`paddle_tpu/distribution/`).

Parameters are torch tensors on the current place (a Tensor argument
keeps its own). Every `sample` / `rsample` draws from the port's
generator of that device (`core.random`): `jax.random`'s bits cannot be
reproduced in torch, so samples are held by their contract (ROADMAP
C.14, C.24): the same seed gives the same stream within the port, and
the moments match. Densities, entropies, KL and the transforms follow the
reference's formulas; `mean`, `variance` and, where it has a closed form,
`cdf` are added beside them. Gamma draws (Gamma, Beta, Dirichlet) use
Marsaglia and Tsang's rejection method on the port's generator, because
torch's own gamma sampler takes no generator.
"""
import math

import numpy as np
import torch

from ..core.device import current_device
from ..core.random import generator
from ..core.tensor import Tensor, _wrap, apply_op, to_tensor

__all__ = ["Distribution", "ExponentialFamily", "Normal", "Uniform",
           "Categorical", "Bernoulli", "Beta", "Dirichlet", "Gumbel",
           "Exponential", "Laplace", "Multinomial", "LogNormal", "Gamma",
           "Poisson", "Independent", "register_kl", "kl_divergence"]


def _d(x):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float32), device=current_device())


def _v(value, like):
    """A value argument as a Tensor on `like`'s device."""
    if isinstance(value, Tensor):
        return value
    return to_tensor(np.asarray(value, np.float32), place=like.device)


def _shape(shape, *params):
    return tuple(shape) + tuple(torch.broadcast_shapes(
        *[p.shape for p in params]))


def _g(t):
    return generator(t.device)


def _standard_gamma(alpha, shape):
    """Gamma(alpha, 1) draws of `shape` from the port's generator
    (Marsaglia and Tsang 2000; alpha < 1 boosted by U^(1/alpha))."""
    a = alpha.expand(shape).reshape(-1).to(torch.float32)
    g, dev = _g(alpha), alpha.device
    boost = a < 1
    aa = torch.where(boost, a + 1, a)
    d = aa - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(aa)
    todo = torch.arange(aa.numel(), device=dev)
    while todo.numel():
        dd, cc = d[todo], c[todo]
        x = torch.randn(todo.shape, generator=g, device=dev)
        v = (1 + cc * x) ** 3
        u = torch.rand(todo.shape, generator=g, device=dev)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v +
                        dd * torch.log(torch.clamp(v, min=1e-30)))
        out[todo[ok]] = (dd * v)[ok]
        todo = todo[~ok]
    u = torch.rand(out.shape, generator=g, device=dev)
    out = torch.where(boost, out * u ** (1.0 / a), out)
    return out.reshape(shape)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def probs(self, value):
        return apply_op(torch.exp, self.log_prob(value))

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError

    def cdf(self, value):
        raise NotImplementedError


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _d(loc)
        self.scale = _d(scale)

    def sample(self, shape=(), seed=0):
        shp = _shape(shape, self.loc, self.scale)
        z = torch.randn(shp, generator=_g(self.loc), device=self.loc.device)
        return _wrap(z * self.scale + self.loc)

    def rsample(self, shape=()):
        return self.sample(shape)

    def log_prob(self, value):
        def fn(v):
            var = self.scale ** 2
            return -((v - self.loc) ** 2) / (2 * var) - \
                torch.log(self.scale) - 0.5 * math.log(2 * math.pi)
        return apply_op(fn, _v(value, self.loc))

    def entropy(self):
        return _wrap(0.5 + 0.5 * math.log(2 * math.pi) +
                     torch.log(self.scale))

    def kl_divergence(self, other):
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return _wrap(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))

    @property
    def mean(self):
        return _wrap(self.loc.expand(_shape((), self.loc, self.scale)))

    @property
    def variance(self):
        return _wrap((self.scale ** 2).expand(
            _shape((), self.loc, self.scale)))

    def cdf(self, value):
        return apply_op(lambda v: 0.5 * (1 + torch.erf(
            (v - self.loc) / (self.scale * math.sqrt(2)))),
            _v(value, self.loc))


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _d(low)
        self.high = _d(high)

    def sample(self, shape=(), seed=0):
        shp = _shape(shape, self.low, self.high)
        u = torch.rand(shp, generator=_g(self.low), device=self.low.device)
        return _wrap(u * (self.high - self.low) + self.low)

    def log_prob(self, value):
        def fn(v):
            inside = (v >= self.low) & (v < self.high)
            return torch.where(inside, -torch.log(self.high - self.low),
                               v.new_full((), -np.inf))
        return apply_op(fn, _v(value, self.low))

    def entropy(self):
        return _wrap(torch.log(self.high - self.low))

    @property
    def mean(self):
        return _wrap((self.high + self.low) / 2)

    @property
    def variance(self):
        return _wrap((self.high - self.low) ** 2 / 12)

    def cdf(self, value):
        return apply_op(lambda v: torch.clamp(
            (v - self.low) / (self.high - self.low), 0, 1),
            _v(value, self.low))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _d(logits)

    def sample(self, shape=()):
        K = self.logits.shape[-1]
        batch = tuple(self.logits.shape[:-1])
        n = int(np.prod(shape)) if len(tuple(shape)) else 1
        p = torch.softmax(self.logits.float(), -1).reshape(-1, K)
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=_g(self.logits))
        return _wrap(draws.T.reshape(tuple(shape) + batch))

    def log_prob(self, value):
        def fn(v):
            logp = torch.log_softmax(self.logits, dim=-1)
            idx = v.to(torch.int64)[..., None]
            logp = logp.expand(idx.shape[:-1] + logp.shape[-1:])
            return torch.gather(logp, -1, idx)[..., 0]
        return apply_op(fn, value if isinstance(value, Tensor) else
                        to_tensor(np.asarray(value, np.int64),
                                  place=self.logits.device))

    def entropy(self):
        logp = torch.log_softmax(self.logits, dim=-1)
        return _wrap(-(torch.exp(logp) * logp).sum(-1))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs_ = _d(probs)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.probs_.shape)
        return _wrap(torch.bernoulli(self.probs_.expand(shp).float(),
                                     generator=_g(self.probs_)))

    def log_prob(self, value):
        def fn(v):
            p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
            return v * torch.log(p) + (1 - v) * torch.log(1 - p)
        return apply_op(fn, _v(value, self.probs_))

    def entropy(self):
        p = torch.clamp(self.probs_, 1e-7, 1 - 1e-7)
        return _wrap(-(p * torch.log(p) + (1 - p) * torch.log(1 - p)))

    @property
    def mean(self):
        return _wrap(self.probs_)

    @property
    def variance(self):
        return _wrap(self.probs_ * (1 - self.probs_))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha = _d(alpha)
        self.beta = _d(beta)

    def sample(self, shape=()):
        shp = _shape(shape, self.alpha, self.beta)
        x = _standard_gamma(self.alpha, shp)
        y = _standard_gamma(self.beta, shp)
        return _wrap(x / (x + y))

    def log_prob(self, value):
        def fn(v):
            return (self.alpha - 1) * torch.log(v) + \
                (self.beta - 1) * torch.log1p(-v) - \
                _betaln(self.alpha, self.beta)
        return apply_op(fn, _v(value, self.alpha))

    def entropy(self):
        a, b = self.alpha, self.beta
        return _wrap(_betaln(a, b) - (a - 1) * torch.digamma(a) -
                     (b - 1) * torch.digamma(b) +
                     (a + b - 2) * torch.digamma(a + b))

    @property
    def mean(self):
        return _wrap(self.alpha / (self.alpha + self.beta))

    @property
    def variance(self):
        s = self.alpha + self.beta
        return _wrap(self.alpha * self.beta / (s * s * (s + 1)))


class Dirichlet(Distribution):
    def __init__(self, concentration):
        self.concentration = _d(concentration)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.concentration.shape)
        g = _standard_gamma(self.concentration, shp)
        return _wrap(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        c = self.concentration

        def fn(v):
            return ((c - 1) * torch.log(v)).sum(-1) + \
                torch.lgamma(c.sum(-1)) - torch.lgamma(c).sum(-1)
        return apply_op(fn, _v(value, c))

    def entropy(self):
        c = self.concentration
        k = c.shape[-1]
        c0 = c.sum(-1)
        return _wrap(torch.lgamma(c).sum(-1) - torch.lgamma(c0) +
                     (c0 - k) * torch.digamma(c0) -
                     ((c - 1) * torch.digamma(c)).sum(-1))

    @property
    def mean(self):
        c = self.concentration
        return _wrap(c / c.sum(-1, keepdim=True))


_EULER = 0.57721566490153286061


class Gumbel(Distribution):
    def __init__(self, loc, scale):
        self.loc = _d(loc)
        self.scale = _d(scale)

    def sample(self, shape=()):
        shp = _shape(shape, self.loc, self.scale)
        u = torch.rand(shp, generator=_g(self.loc), device=self.loc.device)
        u = torch.clamp(u, torch.finfo(u.dtype).tiny, 1.0)
        return _wrap(-torch.log(-torch.log(u)) * self.scale + self.loc)

    def log_prob(self, value):
        def fn(v):
            z = (v - self.loc) / self.scale
            return -(z + torch.exp(-z)) - torch.log(self.scale)
        return apply_op(fn, _v(value, self.loc))

    def entropy(self):
        return _wrap(torch.log(self.scale) + 1 + _EULER)

    @property
    def mean(self):
        return _wrap(self.loc + self.scale * _EULER)

    @property
    def variance(self):
        return _wrap((math.pi ** 2 / 6) * self.scale ** 2)

    def cdf(self, value):
        return apply_op(lambda v: torch.exp(-torch.exp(
            -(v - self.loc) / self.scale)), _v(value, self.loc))


class Exponential(Distribution):
    def __init__(self, rate):
        self.rate = _d(rate)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.rate.shape)
        e = torch.empty(shp, device=self.rate.device).exponential_(
            generator=_g(self.rate))
        return _wrap(e / self.rate)

    def log_prob(self, value):
        return apply_op(lambda v: torch.log(self.rate) - self.rate * v,
                        _v(value, self.rate))

    def entropy(self):
        return _wrap(1 - torch.log(self.rate))

    @property
    def mean(self):
        return _wrap(1 / self.rate)

    @property
    def variance(self):
        return _wrap(self.rate ** -2)

    def cdf(self, value):
        return apply_op(lambda v: 1 - torch.exp(-self.rate * v),
                        _v(value, self.rate))


class Laplace(Distribution):
    def __init__(self, loc, scale):
        self.loc = _d(loc)
        self.scale = _d(scale)

    def sample(self, shape=()):
        shp = _shape(shape, self.loc, self.scale)
        u = torch.rand(shp, generator=_g(self.loc),
                       device=self.loc.device) - 0.5
        eps = torch.finfo(u.dtype).eps
        return _wrap(self.loc - self.scale * torch.sign(u) *
                     torch.log1p(-2 * torch.clamp(u.abs(), max=0.5 - eps)))

    def log_prob(self, value):
        return apply_op(lambda v: -math.log(2) - torch.log(self.scale) -
                        (v - self.loc).abs() / self.scale,
                        _v(value, self.loc))

    def entropy(self):
        return _wrap(1 + math.log(2) + torch.log(self.scale))

    @property
    def mean(self):
        return _wrap(self.loc.expand(_shape((), self.loc, self.scale)))

    @property
    def variance(self):
        return _wrap((2 * self.scale ** 2).expand(
            _shape((), self.loc, self.scale)))

    def cdf(self, value):
        def fn(v):
            z = (v - self.loc) / self.scale
            return 0.5 - 0.5 * torch.sign(z) * torch.expm1(-z.abs())
        return apply_op(fn, _v(value, self.loc))


class Multinomial(Distribution):
    def __init__(self, total_count, probs):
        self.total_count = total_count
        self.probs_ = _d(probs)

    def sample(self, shape=()):
        K = self.probs_.shape[-1]
        batch = tuple(self.probs_.shape[:-1])
        n = int(np.prod(shape)) if len(tuple(shape)) else 1
        p = self.probs_.float().reshape(-1, K)
        idx = torch.multinomial(p, n * int(self.total_count),
                                replacement=True, generator=_g(self.probs_))
        idx = idx.reshape(p.shape[0], n, int(self.total_count))
        counts = torch.zeros(p.shape[0], n, K, device=p.device)
        counts.scatter_add_(2, idx, torch.ones_like(idx, dtype=counts.dtype))
        return _wrap(counts.transpose(0, 1).reshape(tuple(shape) + batch +
                                                    (K,)))

    @property
    def mean(self):
        return _wrap(self.total_count * self.probs_)

    @property
    def variance(self):
        return _wrap(self.total_count * self.probs_ * (1 - self.probs_))


class LogNormal(Distribution):
    def __init__(self, loc, scale):
        self.base = Normal(loc, scale)

    def sample(self, shape=()):
        return apply_op(torch.exp, self.base.sample(shape))

    def log_prob(self, value):
        b = self.base
        return apply_op(lambda v: -((torch.log(v) - b.loc) ** 2) /
                        (2 * b.scale ** 2) - torch.log(b.scale) -
                        0.5 * math.log(2 * math.pi) - torch.log(v),
                        _v(value, b.loc))

    def entropy(self):
        b = self.base
        return _wrap(b.loc + 0.5 + 0.5 * math.log(2 * math.pi) +
                     torch.log(b.scale))

    @property
    def mean(self):
        b = self.base
        return _wrap(torch.exp(b.loc + b.scale ** 2 / 2))

    @property
    def variance(self):
        b = self.base
        s2 = b.scale ** 2
        return _wrap(torch.expm1(s2) * torch.exp(2 * b.loc + s2))

    def cdf(self, value):
        b = self.base
        return apply_op(lambda v: 0.5 * (1 + torch.erf(
            (torch.log(v) - b.loc) / (b.scale * math.sqrt(2)))),
            _v(value, b.loc))


class Gamma(Distribution):
    def __init__(self, concentration, rate):
        self.concentration = _d(concentration)
        self.rate = _d(rate)

    def sample(self, shape=()):
        shp = _shape(shape, self.concentration, self.rate)
        return _wrap(_standard_gamma(self.concentration, shp) / self.rate)

    def log_prob(self, value):
        a, r = self.concentration, self.rate
        return apply_op(lambda v: a * torch.log(r) + (a - 1) * torch.log(v)
                        - r * v - torch.lgamma(a), _v(value, a))

    def entropy(self):
        a, r = self.concentration, self.rate
        return _wrap(a - torch.log(r) + torch.lgamma(a) +
                     (1 - a) * torch.digamma(a))

    @property
    def mean(self):
        return _wrap(self.concentration / self.rate)

    @property
    def variance(self):
        return _wrap(self.concentration / self.rate ** 2)


class Poisson(Distribution):
    def __init__(self, rate):
        self.rate = _d(rate)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.rate.shape)
        return _wrap(torch.poisson(self.rate.expand(shp).float(),
                                   generator=_g(self.rate)))

    def log_prob(self, value):
        r = self.rate
        return apply_op(lambda v: v * torch.log(r) - r -
                        torch.lgamma(v + 1), _v(value, r))

    @property
    def mean(self):
        return _wrap(self.rate)

    @property
    def variance(self):
        return _wrap(self.rate)


_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    """Decorator registering a KL implementation for a pair of
    distribution classes. Dispatch walks both arguments' MROs, the most
    derived match first."""
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn
    return deco


def kl_divergence(p, q):
    for pc in type(p).__mro__:
        for qc in type(q).__mro__:
            fn = _KL_REGISTRY.get((pc, qc))
            if fn is not None:
                return fn(p, q)
    if isinstance(p, Normal) and isinstance(q, Normal):
        return p.kl_divergence(q)
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        lp = torch.log_softmax(p.logits, dim=-1)
        lq = torch.log_softmax(q.logits, dim=-1)
        return _wrap((torch.exp(lp) * (lp - lq)).sum(-1))
    if isinstance(p, ExponentialFamily) and isinstance(q, ExponentialFamily) \
            and type(p) is type(q):
        return _kl_expfamily(p, q)
    raise NotImplementedError(f"kl_divergence({type(p)}, {type(q)})")


class ExponentialFamily(Distribution):
    """Base of exponential-family distributions: a subclass gives
    `_natural_parameters` (a tuple of Tensors) and
    `_log_normalizer(*natural_params)`, and inherits a Bregman-divergence
    KL."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError


def _kl_expfamily(p, q):
    """KL(p || q) for members of one family: the Bregman divergence of the
    log-normalizer, its gradient at p's natural parameters taken by
    torch.autograd (the reference takes jax.grad)."""
    p_nat = [_d(t).detach() for t in p._natural_parameters]
    q_nat = [_d(t).detach() for t in q._natural_parameters]

    def lognorm(*nat):
        out = p._log_normalizer(*[_wrap(n) for n in nat])
        return out._data if isinstance(out, Tensor) else out

    with torch.enable_grad():
        xs = [n.clone().requires_grad_(True) for n in p_nat]
        grads = torch.autograd.grad(lognorm(*xs).sum(), xs)
    kl = lognorm(*q_nat) - lognorm(*p_nat)
    for g, pn, qn in zip(grads, p_nat, q_nat):
        kl = kl - g * (qn - pn)
    return _wrap(kl.detach())


class Independent(Distribution):
    """Reinterprets the `reinterpreted_batch_rank` rightmost batch dims of
    `base` as event dims."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return getattr(self.base, "rsample", self.base.sample)(shape)

    def _sum(self, t):
        return apply_op(lambda l: l.sum(tuple(range(l.dim() - self.rank,
                                                     l.dim())))
                        if self.rank else l, t)

    def log_prob(self, value):
        return self._sum(self.base.log_prob(value))

    def entropy(self):
        return self._sum(self.base.entropy())

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance


from .transform import (  # noqa: E402,F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform,
    SigmoidTransform, SoftmaxTransform, StackTransform,
    StickBreakingTransform, TanhTransform, Transform,
    TransformedDistribution,
)
