"""The port's `distribution` (`paddle_tpu_torch/distribution`) against the JAX
package's on the CPU, on seeded numpy parameters and values in f32: every
class's log_prob and prob, entropy, mean and variance where the class has
them, and kl_divergence through the registry (with `register_kl` adding a
pair), within rtol 1e-5, atol 1e-6; StudentT.entropy raises
NotImplementedError in both. Draws: the same draw again after
`paddle.seed`, and the mean (and where finite the variance) of 2 x 10^5
draws within 5 standard errors of the distribution's own, from a fixed
seed so the test is deterministic; rsample is differentiable in the
parameters (a reparameterized draw)."""

import math

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
N_DRAWS = 200_000
SE = 5.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


_rng = np.random.default_rng(0)


def _pos(*shape, lo=0.5, hi=2.0):
    return (_rng.random(shape) * (hi - lo) + lo).astype(np.float32)


def _unit(*shape):
    return (_rng.random(shape) * 0.8 + 0.1).astype(np.float32)


def _normal(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


def _spd(d):
    a = _normal(d, d)
    return (a @ a.T + d * np.eye(d)).astype(np.float32)


def _simplex(*shape):
    p = _pos(*shape)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _lkj_value(d):
    """A correlation matrix's Cholesky factor."""
    a = _normal(d, d)
    c = a @ a.T + d * np.eye(d)
    s = np.sqrt(np.diag(c))
    return np.linalg.cholesky(c / s[:, None] / s[None, :]).astype(np.float32)


# name -> (constructor(M, *tensors), parameter arrays, value array,
# deterministic methods beyond log_prob / prob)
CASES = {
    "Normal": (lambda M, a, b: M.distribution.Normal(a, b),
               (_normal(3), _pos(3)), _normal(3),
               ("entropy", "mean", "variance")),
    "Uniform": (lambda M, a, b: M.distribution.Uniform(a, b),
                (_normal(3) - 2, _pos(3) + 1), _unit(3), ("entropy",)),
    "Categorical": (lambda M, a: M.distribution.Categorical(logits=a),
                    (_normal(3, 5),), np.asarray([0, 4, 2], np.int64),
                    ("entropy", "probs")),
    "Categorical_probs": (lambda M, a: M.distribution.Categorical(probs=a),
                          (_pos(3, 5),), np.asarray([1, 3, 0], np.int64),
                          ("entropy",)),
    "Bernoulli": (lambda M, a: M.distribution.Bernoulli(a), (_unit(4),),
                  np.asarray([0, 1, 1, 0], np.float32), ("entropy",)),
    "Beta": (lambda M, a, b: M.distribution.Beta(a, b), (_pos(3), _pos(3)),
             _unit(3), ()),
    "Gamma": (lambda M, a, b: M.distribution.Gamma(a, b),
              (_pos(3), _pos(3)), _pos(3), ()),
    "Dirichlet": (lambda M, a: M.distribution.Dirichlet(a), (_pos(2, 4),),
                  _simplex(2, 4), ()),
    "Exponential": (lambda M, a: M.distribution.Exponential(a), (_pos(3),),
                    _pos(3), ("entropy",)),
    "Laplace": (lambda M, a, b: M.distribution.Laplace(a, b),
                (_normal(3), _pos(3)), _normal(3), ()),
    "LogNormal": (lambda M, a, b: M.distribution.LogNormal(a, b),
                  (_normal(3), _pos(3)), _pos(3), ()),
    "Multinomial": (lambda M, a: M.distribution.Multinomial(6, a),
                    (_pos(2, 4),),
                    np.asarray([[1, 2, 0, 3], [6, 0, 0, 0]], np.float32),
                    ()),
    "Poisson": (lambda M, a: M.distribution.Poisson(a), (_pos(3),),
                np.asarray([0, 2, 5], np.float32), ()),
    "Geometric": (lambda M, a: M.distribution.Geometric(a), (_unit(3),),
                  np.asarray([0, 1, 7], np.float32), ()),
    "Cauchy": (lambda M, a, b: M.distribution.Cauchy(a, b),
               (_normal(3), _pos(3)), _normal(3), ()),
    "Gumbel": (lambda M, a, b: M.distribution.Gumbel(a, b),
               (_normal(3), _pos(3)), _normal(3), ()),
    "StudentT": (lambda M, a, b, c: M.distribution.StudentT(a, b, c),
                 (_pos(3, lo=2.5, hi=6), _normal(3), _pos(3)), _normal(3),
                 ()),
    "Binomial": (lambda M, a, b: M.distribution.Binomial(a, b),
                 (np.asarray([5, 8, 10], np.float32), _unit(3)),
                 np.asarray([2, 0, 10], np.float32), ()),
    "Chi2": (lambda M, a: M.distribution.Chi2(a), (_pos(3, lo=1, hi=5),),
             _pos(3), ()),
    "ContinuousBernoulli": (
        lambda M, a: M.distribution.ContinuousBernoulli(a),
        (np.asarray([0.2, 0.4995, 0.5003, 0.8], np.float32),),
        _unit(4), ("entropy", "mean")),
    "MultivariateNormal_cov": (
        lambda M, a, b: M.distribution.MultivariateNormal(
            a, covariance_matrix=b), (_normal(4), _spd(4)),
        _normal(4), ("entropy", "mean", "variance", "covariance_matrix")),
    "MultivariateNormal_prec": (
        lambda M, a, b: M.distribution.MultivariateNormal(
            a, precision_matrix=b), (_normal(4), _spd(4)), _normal(4),
        ("entropy",)),
    "MultivariateNormal_tril": (
        lambda M, a, b: M.distribution.MultivariateNormal(
            a, scale_tril=b), (_normal(4), np.linalg.cholesky(_spd(4))),
        _normal(4), ("entropy",)),
    "Independent": (lambda M, a, b: M.distribution.Independent(
        M.distribution.Normal(a, b), 1), (_normal(2, 3), _pos(2, 3)),
        _normal(2, 3), ("entropy", "mean", "variance")),
    "LKJCholesky": (lambda M: M.distribution.LKJCholesky(4, 1.5), (),
                    _lkj_value(4), ()),
}


def _get(dist, name):
    v = getattr(dist, name)
    return v() if callable(v) else v


@pytest.mark.parametrize("case", sorted(CASES))
def test_deterministic_methods_match(case):
    ctor, params, value, extra = CASES[case]
    dists = [ctor(M, *[M.to_tensor(p) for p in params]) for M in (P, J)]
    assert tuple(dists[0].batch_shape) == tuple(dists[1].batch_shape)
    assert tuple(dists[0].event_shape) == tuple(dists[1].event_shape)
    for meth in ("log_prob", "prob"):
        got, want = (getattr(d, meth)(M.to_tensor(value))
                     for d, M in zip(dists, (P, J)))
        _close(got, want)
    for name in extra:
        _close(_get(dists[0], name), _get(dists[1], name))


def test_student_t_has_no_entropy_in_either():
    for M in (P, J):
        with pytest.raises(NotImplementedError):
            M.distribution.StudentT(M.to_tensor(3.0)).entropy()


def _kl_pairs(M):
    D = M.distribution
    t = M.to_tensor
    return {
        "Normal": (D.Normal(t(_KL["n"][0]), t(_KL["n"][1])),
                   D.Normal(t(_KL["n"][2]), t(_KL["n"][3]))),
        "Categorical": (D.Categorical(logits=t(_KL["c"][0])),
                        D.Categorical(logits=t(_KL["c"][1]))),
        "Uniform": (D.Uniform(t(_KL["u"][0]), t(_KL["u"][1])),
                    D.Uniform(t(_KL["u"][2]), t(_KL["u"][3]))),
        "Bernoulli": (D.Bernoulli(t(_KL["b"][0])),
                      D.Bernoulli(t(_KL["b"][1]))),
        "Exponential": (D.Exponential(t(_KL["e"][0])),
                        D.Exponential(t(_KL["e"][1]))),
    }


_KL = {"n": (_normal(3), _pos(3), _normal(3), _pos(3)),
       "c": (_normal(2, 6), _normal(2, 6)),
       # the second pair's support holds the first's in two of three
       "u": (np.asarray([0.0, 0.0, -1.0], np.float32),
             np.asarray([1.0, 2.0, 1.0], np.float32),
             np.asarray([-1.0, 0.5, -2.0], np.float32),
             np.asarray([2.0, 3.0, 2.0], np.float32)),
       "b": (_unit(3), _unit(3)), "e": (_pos(3), _pos(3))}


@pytest.mark.parametrize("pair", ["Normal", "Categorical", "Uniform",
                                  "Bernoulli", "Exponential"])
def test_kl_divergence_matches(pair):
    (p1, q1), (p2, q2) = _kl_pairs(P)[pair], _kl_pairs(J)[pair]
    got = P.distribution.kl_divergence(p1, q1)
    want = J.distribution.kl_divergence(p2, q2)
    gv, wv = _np(got), _np(want)
    assert np.array_equal(np.isinf(gv), np.isinf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=RTOL, atol=ATOL)
    if pair == "Normal":
        _close(p1.kl_divergence(q1), got)


def test_register_kl_and_unregistered_pair():
    D = P.distribution

    class Mine(D.Normal):
        pass

    @D.register_kl(Mine, D.Normal)
    def _kl(p, q):
        return P.to_tensor(np.float32(7.0))

    assert float(D.kl_divergence(Mine(0.0, 1.0), D.Normal(0.0, 1.0))) == 7.0
    with pytest.raises(NotImplementedError, match="Gamma"):
        D.kl_divergence(D.Gamma(1.0, 1.0), D.Gamma(1.0, 1.0))


def test_exponential_family_entropy_by_autograd():
    """An exponential-family subclass (the exponential distribution in
    natural form: eta = -rate, A(eta) = -log(-eta)) gets its entropy from
    the Bregman identity in both packages: 1 - log(rate)."""
    rate = _pos(4)

    def make(M, jnp_like):
        class Expo(M.distribution.ExponentialFamily):
            def __init__(self, r):
                self.r = r
                super().__init__(r.shape)

            @property
            def _natural_parameters(self):
                return (-self.r,)

            def _log_normalizer(self, eta):
                return -jnp_like.log(-eta)

        return Expo

    import jax.numpy as jnp

    got = make(P, torch)(torch.from_numpy(rate)).entropy()
    want = make(J, jnp)(jnp.asarray(rate)).entropy()
    _close(got, want)
    _close(got, 1.0 - np.log(rate))


class _Affine:
    """y = 2 x + 1 over the package's Tensor ops."""

    def __init__(self, M):
        self.M = M

    def forward(self, x):
        return x * 2.0 + 1.0

    def inverse(self, y):
        return (y - 1.0) / 2.0

    def forward_log_det_jacobian(self, x):
        return self.M.full_like(x, math.log(2.0))


def test_transformed_distribution_matches():
    loc, scale, value = _normal(3), _pos(3), _normal(3)
    got, want = (M.distribution.TransformedDistribution(
        M.distribution.Normal(M.to_tensor(loc), M.to_tensor(scale)),
        [_Affine(M)]).log_prob(M.to_tensor(value)) for M in (P, J))
    _close(got, want)


# draws: (constructor on the port, true mean, true variance or None) for
# scalar parameters; each checked over N_DRAWS
def _moment_cases():
    D = P.distribution
    ab, cb = 2.0, 3.0
    return {
        "Normal": (lambda: D.Normal(0.5, 2.0), 0.5, 4.0),
        "Uniform": (lambda: D.Uniform(-1.0, 3.0), 1.0, 16 / 12),
        "Bernoulli": (lambda: D.Bernoulli(0.3), 0.3, 0.21),
        "Beta": (lambda: D.Beta(ab, cb), ab / (ab + cb),
                 ab * cb / ((ab + cb) ** 2 * (ab + cb + 1))),
        "Gamma": (lambda: D.Gamma(3.0, 2.0), 1.5, 0.75),
        "Exponential": (lambda: D.Exponential(2.0), 0.5, 0.25),
        "Laplace": (lambda: D.Laplace(1.0, 0.5), 1.0, 0.5),
        "LogNormal": (lambda: D.LogNormal(0.0, 0.5), math.exp(0.125),
                      (math.exp(0.25) - 1) * math.exp(0.25)),
        "Poisson": (lambda: D.Poisson(3.5), 3.5, 3.5),
        "Geometric": (lambda: D.Geometric(0.25), 3.0, 12.0),
        "Gumbel": (lambda: D.Gumbel(1.0, 2.0), 1.0 + 2.0 * 0.5772156649,
                   math.pi ** 2 / 6 * 4.0),
        "StudentT": (lambda: D.StudentT(6.0, 1.0, 2.0), 1.0, 4.0 * 1.5),
        "Binomial": (lambda: D.Binomial(10.0, 0.3), 3.0, 2.1),
        "Chi2": (lambda: D.Chi2(4.0), 4.0, 8.0),
    }


@pytest.mark.parametrize("case", sorted(_moment_cases()))
def test_draws_repeat_under_seed_and_meet_their_moments(case):
    make, mean, var = _moment_cases()[case]
    P.seed(123)
    a = _np(make().sample([N_DRAWS])).astype(np.float64)
    P.seed(123)
    b = _np(make().sample([N_DRAWS]))
    np.testing.assert_array_equal(a, b)
    assert abs(a.mean() - mean) <= SE * math.sqrt(var / N_DRAWS), \
        (a.mean(), mean)
    # the sample variance's standard error from the fourth central moment
    m4 = float(((a - a.mean()) ** 4).mean())
    assert abs(a.var() - var) <= SE * math.sqrt((m4 - var ** 2) / N_DRAWS), \
        (a.var(), var)


def test_vector_draws_meet_their_moments():
    D = P.distribution
    P.seed(7)
    # Categorical: class frequencies
    p = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    c = _np(D.Categorical(probs=P.to_tensor(p)).sample([N_DRAWS]))
    freq = np.bincount(c, minlength=4) / N_DRAWS
    assert np.all(np.abs(freq - p) <= SE * np.sqrt(p * (1 - p) / N_DRAWS))
    # Multinomial: mean counts n p
    m = _np(D.Multinomial(5, P.to_tensor(p)).sample([N_DRAWS // 4]))
    assert m.shape == (N_DRAWS // 4, 4) and np.all(m.sum(-1) == 5)
    assert np.all(np.abs(m.mean(0) - 5 * p)
                  <= SE * np.sqrt(5 * p * (1 - p) / (N_DRAWS // 4)))
    # Dirichlet: mean a / sum(a)
    a = np.asarray([1.0, 2.0, 3.0], np.float32)
    x = _np(D.Dirichlet(P.to_tensor(a)).sample([N_DRAWS]))
    mu = a / a.sum()
    var = mu * (1 - mu) / (a.sum() + 1)
    assert np.allclose(x.sum(-1), 1.0, atol=1e-5)
    assert np.all(np.abs(x.mean(0) - mu) <= SE * np.sqrt(var / N_DRAWS))
    # MultivariateNormal: mean and covariance
    cov = np.asarray([[2.0, 0.5], [0.5, 1.0]], np.float32)
    z = _np(D.MultivariateNormal(P.to_tensor(np.asarray([1.0, -1.0],
                                                        np.float32)),
                                 covariance_matrix=P.to_tensor(cov)).sample(
        [N_DRAWS])).astype(np.float64)
    assert np.all(np.abs(z.mean(0) - [1.0, -1.0])
                  <= SE * np.sqrt(np.diag(cov) / N_DRAWS))
    emp = np.cov(z.T)
    se = np.sqrt((cov ** 2 + np.outer(np.diag(cov), np.diag(cov))) / N_DRAWS)
    assert np.all(np.abs(emp - cov) <= SE * se)
    # Cauchy: the median is loc, P(X <= loc) = 1/2
    y = _np(D.Cauchy(0.5, 2.0).sample([N_DRAWS]))
    assert abs((y <= 0.5).mean() - 0.5) <= SE * math.sqrt(0.25 / N_DRAWS)
    # ContinuousBernoulli: its own mean
    cb = D.ContinuousBernoulli(0.2)
    w = _np(cb.sample([N_DRAWS]))
    assert abs(w.mean() - float(_np(cb.mean))) <= SE * math.sqrt(
        w.var() / N_DRAWS)
    # LKJCholesky(d 3, eta 2): unit rows, and each off-diagonal
    # correlation of L L^T has mean 0 and variance 1 / (2 eta + d - 1)
    L = _np(D.LKJCholesky(3, 2.0).sample([N_DRAWS // 4])).astype(np.float64)
    corr = L @ np.swapaxes(L, -1, -2)
    assert np.allclose(np.diagonal(corr, axis1=-2, axis2=-1), 1.0, atol=1e-5)
    r = corr[:, 0, 1]
    v = 1.0 / (2 * 2.0 + 3 - 1)
    assert abs(r.mean()) <= SE * math.sqrt(v / len(r))
    assert abs(r.var() - v) <= SE * math.sqrt(2 * v * v / len(r)) * 1.5


def test_rsample_is_differentiable_in_the_parameters():
    loc = P.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
    scale = P.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    P.seed(0)
    s = P.distribution.Normal(loc, scale).rsample([8])
    s.sum().backward()
    np.testing.assert_allclose(_np(loc.grad), np.full(3, 8.0))
    P.seed(0)
    eps = _np(P.distribution.Normal(0.0, 1.0).sample([8, 3]))
    np.testing.assert_allclose(_np(scale.grad), eps.sum(0), rtol=1e-5)
