"""paddle.distribution (`paddle_tpu/distribution/__init__.py`; reference
`python/paddle/distribution/`: the Distribution base, Normal, Uniform,
Categorical, ..., the `kl_divergence` registry).

log_prob, prob, entropy, mean/variance and kl_divergence are the JAX
package's formulas in plain torch, on the device of the parameters (a
parameter given as a Python number or an array lands beside the tensor
ones, else on the creation place); where `torch.distributions` keeps
another convention (Geometric's support, ContinuousBernoulli's
normalizer, LKJCholesky's density) these follow the JAX package.
`sample` and `rsample` draw from the port's generator of that device
(`framework.random`, seeded by `paddle.seed`), so a draw repeats under a
seed; they give other numbers than the JAX package's threefry. rsample is
differentiable in the parameters (a reparameterized draw) where the
distribution has one. StudentT has no entropy (the base class raises), as
in the JAX package.
"""

import math

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import random as _rng

__all__ = [
    "Distribution", "Normal", "Uniform", "Categorical", "Bernoulli", "Beta",
    "Gamma", "Dirichlet", "Exponential", "Laplace", "LogNormal",
    "Multinomial", "Poisson", "Geometric", "Cauchy", "Gumbel",
    "StudentT", "Binomial", "Chi2", "ContinuousBernoulli",
    "ExponentialFamily", "Independent", "LKJCholesky",
    "MultivariateNormal", "TransformedDistribution",
    "kl_divergence", "register_kl",
]


def _device(*xs):
    """The device of the first tensor among xs, else the creation place."""
    for x in xs:
        if isinstance(x, Tensor):
            return x._data.device
        if isinstance(x, torch.Tensor):
            return x.device
    from paddle_tpu_torch.framework import device as _device_mod

    return _device_mod.place(None)


def _data(x, device=None):
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def _f32(*xs):
    """The parameters as f32 tensors on one device."""
    dev = _device(*xs)
    return [_data(x, dev).to(dev, torch.float32) for x in xs]


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


class Distribution:
    """Reference: `distribution/distribution.py` Distribution base."""

    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return apply(torch.exp, self.log_prob(value), _name="prob")

    def entropy(self):
        raise NotImplementedError

    def _extend(self, shape):
        return tuple(shape) + self._batch_shape + self._event_shape

    # the device every parameter lies on (`_param_device`, set by each
    # subclass), its generator and draws
    def _gen(self):
        return _rng.generator(self._param_device)

    def _uniform(self, shape, low=0.0, high=1.0):
        u = torch.rand(shape, generator=self._gen(),
                       device=self._param_device)
        return u * (high - low) + low if (low, high) != (0.0, 1.0) else u

    def _normal(self, shape):
        return torch.randn(shape, generator=self._gen(),
                           device=self._param_device)

    def _gamma(self, conc, shape):
        """Gamma(conc, 1) draws of `shape` (conc broadcast to it)."""
        return torch._standard_gamma(conc.expand(shape).contiguous(),
                                     generator=self._gen())

    def _value(self, value):
        return _data(value, self._param_device)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _f32(loc, scale)
        self._param_device = self.loc.device
        super().__init__(_bshape(self.loc, self.scale))

    @property
    def mean(self):
        return Tensor(self.loc.expand(self.batch_shape))

    @property
    def variance(self):
        return Tensor((self.scale ** 2).expand(self.batch_shape))

    def sample(self, shape=()):
        eps = self._normal(self._extend(shape))
        return Tensor(self.loc + self.scale * eps)

    rsample = sample

    def log_prob(self, value):
        v = self._value(value)
        var = self.scale ** 2
        return Tensor(-((v - self.loc) ** 2) / (2 * var)
                      - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        out = 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)
        return Tensor(out.expand(self.batch_shape))

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _f32(low, high)
        self._param_device = self.low.device
        super().__init__(_bshape(self.low, self.high))

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape))
        return Tensor(self.low + (self.high - self.low) * u)

    rsample = sample

    def log_prob(self, value):
        v = self._value(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return Tensor(torch.where(inside, lp, -math.inf))

    def entropy(self):
        out = torch.log(self.high - self.low)
        return Tensor(out.expand(self.batch_shape))


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None, name=None):
        if logits is None and probs is None:
            raise ValueError("need logits or probs")
        if logits is not None:
            (lg,) = _f32(logits)
            self.logits = torch.log_softmax(lg, dim=-1)
        else:
            (p,) = _f32(probs)
            self.logits = torch.log(p / p.sum(-1, keepdim=True))
        self._param_device = self.logits.device
        super().__init__(self.logits.shape[:-1])

    @property
    def probs(self):
        return Tensor(torch.exp(self.logits))

    def sample(self, shape=()):
        """shape + batch_shape class ids, int64, by inverse-CDF draws from
        the probabilities (torch.multinomial with replacement)."""
        k = self.logits.shape[-1]
        p = torch.exp(self.logits).reshape(-1, k)
        n = math.prod(shape)
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=self._gen())   # [batch, n]
        return Tensor(draws.T.reshape(tuple(shape) + self.batch_shape))

    def log_prob(self, value):
        v = self._value(value).long()
        k = self.logits.shape[-1]
        shape = torch.broadcast_shapes(v.shape, self.logits.shape[:-1])
        lg = self.logits.expand(shape + (k,))
        return Tensor(torch.gather(lg, -1, v.expand(shape)[..., None])[..., 0])

    def entropy(self):
        p = torch.exp(self.logits)
        return Tensor(-(p * self.logits).sum(-1))


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        (p,) = _f32(probs)
        self.probs_ = torch.clamp(p, 1e-7, 1 - 1e-7)
        self._param_device = self.probs_.device
        super().__init__(self.probs_.shape)

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape))
        return Tensor((u < self.probs_).to(torch.float32))

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(v * torch.log(self.probs_)
                      + (1 - v) * torch.log(1 - self.probs_))

    def entropy(self):
        p = self.probs_
        return Tensor(-(p * torch.log(p) + (1 - p) * torch.log(1 - p)))


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha, self.beta = _f32(alpha, beta)
        self._param_device = self.alpha.device
        super().__init__(_bshape(self.alpha, self.beta))

    def sample(self, shape=()):
        shape = self._extend(shape)
        x = self._gamma(self.alpha, shape)
        y = self._gamma(self.beta, shape)
        return Tensor(x / (x + y))

    def log_prob(self, value):
        v = self._value(value)
        lbeta = (torch.lgamma(self.alpha) + torch.lgamma(self.beta)
                 - torch.lgamma(self.alpha + self.beta))
        return Tensor((self.alpha - 1) * torch.log(v)
                      + (self.beta - 1) * torch.log1p(-v) - lbeta)


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        self.concentration, self.rate = _f32(concentration, rate)
        self._param_device = self.concentration.device
        super().__init__(_bshape(self.concentration, self.rate))

    def sample(self, shape=()):
        g = self._gamma(self.concentration, self._extend(shape))
        return Tensor(g / self.rate)

    def log_prob(self, value):
        v = self._value(value)
        a, b = self.concentration, self.rate
        return Tensor(a * torch.log(b) + (a - 1) * torch.log(v) - b * v
                      - torch.lgamma(a))


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        (self.concentration,) = _f32(concentration)
        self._param_device = self.concentration.device
        super().__init__(self.concentration.shape[:-1],
                         self.concentration.shape[-1:])

    def sample(self, shape=()):
        g = self._gamma(self.concentration, self._extend(shape))
        return Tensor(g / g.sum(-1, keepdim=True))

    def log_prob(self, value):
        v = self._value(value)
        a = self.concentration
        lnorm = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
        return Tensor(((a - 1) * torch.log(v)).sum(-1) - lnorm)


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        (self.rate,) = _f32(rate)
        self._param_device = self.rate.device
        super().__init__(self.rate.shape)

    def sample(self, shape=()):
        e = torch.empty(self._extend(shape),
                        device=self._param_device).exponential_(
            generator=self._gen())
        return Tensor(e / self.rate)

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(torch.log(self.rate) - self.rate * v)

    def entropy(self):
        return Tensor(1.0 - torch.log(self.rate))


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _f32(loc, scale)
        self._param_device = self.loc.device
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape), -1.0, 1.0)
        l = -torch.sign(u) * torch.log1p(-u.abs())
        return Tensor(self.loc + self.scale * l)

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(-torch.abs(v - self.loc) / self.scale
                      - torch.log(2 * self.scale))


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _f32(loc, scale)
        self._param_device = self.loc.device
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        eps = self._normal(self._extend(shape))
        return Tensor(torch.exp(self.loc + self.scale * eps))

    def log_prob(self, value):
        v = self._value(value)
        logv = torch.log(v)
        var = self.scale ** 2
        return Tensor(-((logv - self.loc) ** 2) / (2 * var) - logv
                      - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        (p,) = _f32(probs)
        self.probs_ = p / p.sum(-1, keepdim=True)
        self._param_device = self.probs_.device
        super().__init__(self.probs_.shape[:-1], self.probs_.shape[-1:])

    def sample(self, shape=()):
        """shape + batch_shape + [k] counts of total_count draws each."""
        k = self.probs_.shape[-1]
        p = self.probs_.reshape(-1, k)
        n = math.prod(shape)
        draws = torch.multinomial(p, n * self.total_count, replacement=True,
                                  generator=self._gen())
        draws = draws.reshape(p.shape[0], n, self.total_count)
        counts = torch.zeros(p.shape[0], n, k, device=p.device).scatter_add_(
            -1, draws, torch.ones_like(draws, dtype=torch.float32))
        return Tensor(counts.transpose(0, 1).reshape(
            tuple(shape) + self.batch_shape + (k,)))

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(
            torch.lgamma(torch.tensor(self.total_count + 1.0, device=v.device))
            - torch.lgamma(v + 1).sum(-1)
            + (v * torch.log(self.probs_)).sum(-1))


class Poisson(Distribution):
    def __init__(self, rate, name=None):
        (self.rate,) = _f32(rate)
        self._param_device = self.rate.device
        super().__init__(self.rate.shape)

    def sample(self, shape=()):
        rate = self.rate.expand(self._extend(shape)).contiguous()
        return Tensor(torch.poisson(rate, generator=self._gen()))

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(v * torch.log(self.rate) - self.rate
                      - torch.lgamma(v + 1))


class Geometric(Distribution):
    """Failures before the first success: support {0, 1, ...}."""

    def __init__(self, probs, name=None):
        (p,) = _f32(probs)
        self.probs_ = torch.clamp(p, 1e-7, 1 - 1e-7)
        self._param_device = self.probs_.device
        super().__init__(self.probs_.shape)

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape))
        return Tensor(torch.floor(torch.log1p(-u)
                                  / torch.log1p(-self.probs_)))

    def log_prob(self, value):
        v = self._value(value)
        return Tensor(v * torch.log1p(-self.probs_) + torch.log(self.probs_))


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _f32(loc, scale)
        self._param_device = self.loc.device
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape))
        c = torch.tan(math.pi * (u - 0.5))
        return Tensor(self.loc + self.scale * c)

    def log_prob(self, value):
        v = self._value(value)
        z = (v - self.loc) / self.scale
        return Tensor(-torch.log(math.pi * self.scale * (1 + z ** 2)))


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _f32(loc, scale)
        self._param_device = self.loc.device
        super().__init__(_bshape(self.loc, self.scale))

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape))
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return Tensor(self.loc + self.scale * g)

    def log_prob(self, value):
        z = (self._value(value) - self.loc) / self.scale
        return Tensor(-(z + torch.exp(-z)) - torch.log(self.scale))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self.df, self.loc, self.scale = _f32(df, loc, scale)
        self._param_device = self.df.device
        super().__init__(_bshape(self.df, self.loc, self.scale))

    def sample(self, shape=()):
        shape = self._extend(shape)
        chi2 = 2.0 * self._gamma(self.df / 2.0, shape)
        t = self._normal(shape) * torch.rsqrt(chi2 / self.df)
        return Tensor(self.loc + self.scale * t)

    def log_prob(self, value):
        v = self._value(value)
        d = self.df
        z = (v - self.loc) / self.scale
        return Tensor(
            torch.lgamma((d + 1) / 2) - torch.lgamma(d / 2)
            - 0.5 * torch.log(d * math.pi) - torch.log(self.scale)
            - (d + 1) / 2 * torch.log1p(z ** 2 / d))


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count, self.probs_ = _f32(total_count, probs)
        self._param_device = self.total_count.device
        super().__init__(_bshape(self.total_count, self.probs_))

    def sample(self, shape=()):
        shape = self._extend(shape)
        return Tensor(torch.binomial(
            self.total_count.expand(shape).contiguous(),
            self.probs_.expand(shape).contiguous(), generator=self._gen()))

    def log_prob(self, value):
        v = self._value(value)
        n, p = self.total_count, self.probs_
        return Tensor(
            torch.lgamma(n + 1) - torch.lgamma(v + 1) - torch.lgamma(n - v + 1)
            + v * torch.log(p) + (n - v) * torch.log1p(-p))


# -- KL divergence registry (reference `distribution/kl.py`) ----------------

_KL_REGISTRY = {}


def register_kl(p_cls, q_cls):
    def deco(fn):
        _KL_REGISTRY[(p_cls, q_cls)] = fn
        return fn

    return deco


def kl_divergence(p, q):
    fn = _KL_REGISTRY.get((type(p), type(q)))
    if fn is None:
        raise NotImplementedError(
            f"kl_divergence not registered for "
            f"({type(p).__name__}, {type(q).__name__})")
    return fn(p, q)


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    var_ratio = (p.scale / q.scale) ** 2
    t1 = ((p.loc - q.loc) / q.scale) ** 2
    return Tensor(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


@register_kl(Categorical, Categorical)
def _kl_categorical(p, q):
    pr = torch.exp(p.logits)
    return Tensor((pr * (p.logits - q.logits)).sum(-1))


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    r = torch.log((q.high - q.low) / (p.high - p.low))
    out = torch.where((q.low <= p.low) & (p.high <= q.high), r, math.inf)
    return Tensor(out)


@register_kl(Bernoulli, Bernoulli)
def _kl_bernoulli(p, q):
    a, b = p.probs_, q.probs_
    return Tensor(a * (torch.log(a) - torch.log(b))
                  + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)))


@register_kl(Exponential, Exponential)
def _kl_exponential(p, q):
    r = p.rate / q.rate
    return Tensor(torch.log(r) + q.rate / p.rate - 1)


class ExponentialFamily(Distribution):
    """Natural-parameter base (reference
    `distribution/exponential_family.py`): subclasses expose
    _natural_parameters / _log_normalizer; entropy comes from the Bregman
    identity H = A(eta) - <eta, grad A(eta)> + E[log h(x)], grad A by
    torch.autograd."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        nats = [_data(n).detach().to(torch.float32).requires_grad_(True)
                for n in self._natural_parameters]
        # grads of the sum equal the per-element dA/deta (A is elementwise
        # in eta), but the value must stay per-element
        with torch.enable_grad():
            a_val = self._log_normalizer(*nats)
            grads = torch.autograd.grad(a_val.sum(), nats)
        ent = (a_val.detach().expand(self.batch_shape).to(torch.float32)
               - self._mean_carrier_measure)
        total = torch.zeros(self.batch_shape, device=ent.device) + ent
        for n, g in zip(nats, grads):
            total = total - n.detach() * g
        return Tensor(total)


class Chi2(Gamma):
    """Chi-squared(df) == Gamma(df/2, 1/2) (reference
    `distribution/chi2.py`)."""

    def __init__(self, df, name=None):
        (self.df,) = _f32(df)
        super().__init__(self.df / 2.0, torch.full_like(self.df, 0.5))


class ContinuousBernoulli(Distribution):
    """reference `distribution/continuous_bernoulli.py`: density
    C(p) * p^x (1-p)^(1-x) on [0, 1] with the log-normalizer C(p)."""

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        (p,) = _f32(probs)
        self.probs = torch.clamp(p, 1e-6, 1 - 1e-6)
        self._lims = lims
        self._param_device = self.probs.device
        super().__init__(self.probs.shape)

    def _outside(self):
        lo, hi = self._lims
        return (self.probs < lo) | (self.probs > hi)

    def _safe(self):
        return torch.where(self._outside(), self.probs, self._lims[0])

    def _log_C(self):
        p = self.probs
        # log C(p) = log( 2 atanh(1-2p) / (1-2p) ), with the p -> 1/2
        # limit handled by a Taylor patch inside the cut region
        safe = self._safe()
        c = torch.log(2 * torch.atanh(1 - 2 * safe) / (1 - 2 * safe))
        x = p - 0.5
        taylor = math.log(2.0) + (4.0 / 3) * x * x  # C(1/2+x) ~ 2 + 8x^2/3
        return torch.where(self._outside(), c, taylor)

    @property
    def mean(self):
        p = self.probs
        safe = self._safe()
        m = safe / (2 * safe - 1) + 1 / (2 * torch.atanh(1 - 2 * safe))
        return Tensor(torch.where(self._outside(), m, 0.5 + (p - 0.5) / 3))

    def sample(self, shape=()):
        u = self._uniform(self._extend(shape), 1e-6, 1 - 1e-6)
        safe = self._safe()
        x = (torch.log1p(u * (2 * safe - 1) / (1 - safe))
             / torch.log(safe / (1 - safe)))
        return Tensor(torch.where(self._outside(), x, u))

    rsample = sample

    def log_prob(self, value):
        v = self._value(value)
        p = self.probs
        return Tensor(self._log_C() + v * torch.log(p)
                      + (1 - v) * torch.log1p(-p))

    def entropy(self):
        m = self.mean._data
        p = self.probs
        return Tensor(-(self._log_C() + m * torch.log(p)
                        + (1 - m) * torch.log1p(-p)))


class Independent(Distribution):
    """Reinterpret batch dims as event dims (reference
    `distribution/independent.py`): log_prob sums over the converted
    dims."""

    def __init__(self, base, reinterpreted_batch_rank, name=None):
        self.base = base
        self._rank = int(reinterpreted_batch_rank)
        bshape = base.batch_shape
        super().__init__(bshape[:len(bshape) - self._rank],
                         bshape[len(bshape) - self._rank:]
                         + tuple(base.event_shape))

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def _sum_tail(self, arr):
        for _ in range(self._rank):
            arr = torch.sum(arr, dim=-1)
        return arr

    def log_prob(self, value):
        return Tensor(self._sum_tail(_data(self.base.log_prob(value))))

    def entropy(self):
        return Tensor(self._sum_tail(_data(self.base.entropy())))


class MultivariateNormal(Distribution):
    """reference `distribution/multivariate_normal.py`: parameterized by
    covariance / precision / scale_tril; sampling and log_prob ride one
    Cholesky factor."""

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None):
        given = [a for a in (covariance_matrix, precision_matrix,
                             scale_tril) if a is not None]
        if len(given) != 1:
            raise ValueError("give exactly one of covariance_matrix / "
                             "precision_matrix / scale_tril")
        self.loc, m = _f32(loc, given[0])
        if scale_tril is not None:
            self._L = m
        elif covariance_matrix is not None:
            self._L = torch.linalg.cholesky(m)
        else:
            self._L = torch.linalg.cholesky(torch.linalg.inv(m))
        self._param_device = self.loc.device
        d = self.loc.shape[-1]
        super().__init__(self.loc.shape[:-1], (d,))

    @property
    def mean(self):
        return Tensor(self.loc)

    @property
    def covariance_matrix(self):
        return Tensor(self._L @ self._L.transpose(-1, -2))

    @property
    def variance(self):
        return Tensor(torch.sum(self._L * self._L, dim=-1))

    def sample(self, shape=()):
        eps = self._normal(tuple(shape) + tuple(self.loc.shape))
        return Tensor(self.loc + torch.einsum("...ij,...j->...i", self._L,
                                              eps))

    rsample = sample

    def _logdet(self):
        return torch.sum(torch.log(torch.diagonal(self._L, dim1=-2,
                                                  dim2=-1)), -1)

    def log_prob(self, value):
        v = self._value(value).to(torch.float32)
        diff = v - self.loc
        L = self._L.expand(diff.shape[:-1] + self._L.shape[-2:])
        sol = torch.linalg.solve_triangular(L, diff[..., None],
                                            upper=False)[..., 0]
        d = self.loc.shape[-1]
        return Tensor(-0.5 * torch.sum(sol * sol, -1) - self._logdet()
                      - 0.5 * d * math.log(2 * math.pi))

    def entropy(self):
        d = self.loc.shape[-1]
        out = 0.5 * d * (1 + math.log(2 * math.pi)) + self._logdet()
        return Tensor(out.expand(self.batch_shape))


class TransformedDistribution(Distribution):
    """base pushed through a chain of Transforms (reference
    `distribution/transformed_distribution.py`); log_prob subtracts the
    forward log-det-Jacobians."""

    def __init__(self, base, transforms, name=None):
        self.base = base
        self.transforms = list(transforms)
        super().__init__(base.batch_shape, base.event_shape)

    def sample(self, shape=()):
        x = self.base.sample(shape)
        for t in self.transforms:
            x = t.forward(x)
        return x

    rsample = sample

    def log_prob(self, value):
        v = value
        lp = 0.0
        for t in reversed(self.transforms):
            x = t.inverse(v)
            lp = lp - _data(t.forward_log_det_jacobian(x)).to(torch.float32)
            v = x
        return Tensor(_data(self.base.log_prob(v)) + lp)


class LKJCholesky(Distribution):
    """LKJ prior over correlation-matrix Cholesky factors (reference
    `distribution/lkj_cholesky.py`): onion-method sampling, density
    prod_i L_ii^(d - i - 1 + 2(eta - 1)) over the JAX package's
    normalizer."""

    def __init__(self, dim, concentration=1.0,
                 sample_method="onion", name=None):
        self.dim = int(dim)
        (self.concentration,) = _f32(concentration)
        self._param_device = self.concentration.device
        super().__init__(tuple(self.concentration.shape),
                         (self.dim, self.dim))

    def sample(self, shape=()):
        d = self.dim
        eta = self.concentration
        out_shape = tuple(shape) + self.batch_shape
        # onion method: row i built from a Beta-distributed radius and a
        # uniform direction on the sphere
        L = torch.zeros(out_shape + (d, d), device=self._param_device)
        L[..., 0, 0] = 1.0
        for i in range(1, d):
            a = torch.full(out_shape, i / 2.0, device=self._param_device)
            x = self._gamma(a, out_shape)
            y = self._gamma(eta + (d - 1 - i) / 2.0, out_shape)
            beta = x / (x + y)
            u = self._normal(out_shape + (i,))
            u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
            L[..., i, :i] = torch.sqrt(beta)[..., None] * u
            L[..., i, i] = torch.sqrt(1.0 - beta)
        return Tensor(L)

    def log_prob(self, value):
        L = self._value(value).to(torch.float32)
        d = self.dim
        eta = self.concentration
        order = torch.arange(1, d, dtype=torch.float32, device=L.device)
        expo = d - order - 1.0 + 2.0 * (eta[..., None] if eta.dim()
                                        else eta) - 2.0
        diag = torch.diagonal(L, dim1=-2, dim2=-1)[..., 1:]
        unnorm = torch.sum(expo * torch.log(diag), dim=-1)
        # normalizer (reference lkj_cholesky.py log-normalizer)
        i = order
        a = eta + (d - 1 - i) / 2.0
        lognorm = torch.sum(
            0.5 * i * math.log(math.pi) + torch.lgamma(a)
            - torch.lgamma(a + i / 2.0), dim=-1)
        return Tensor(unnorm - lognorm)
