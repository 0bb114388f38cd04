"""The port's creation and math ops (`paddle_tpu_torch.ops.creation`,
`ops.math`) against the JAX package's, one parametrised case per public
callable (`torch_op_cases`): the same numpy inputs through both, on the
CPU; forward values to f32 rtol 1e-5 / atol 1e-6 (`tests/op_test.py`'s
bars) under the dtype map int32 -> int64, float32 -> float64 (ROADMAP §C),
and the gradient of sum(out * w) to 1e-5 where the op is differentiable.

The random ops are held to seed reproducibility and to their moments, not
to the JAX package's bits (threefry and torch's generators differ)."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as P
import torch_op_cases as T
from paddle_tpu_torch.framework import device as port_device
import torch

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


VALUE = [c for c in T.cases("creation", "math") if c.check != "random"]


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)


# --------------------------------------------------------------------------
# random ops: one draw is repeated bit for bit after reseeding, another seed
# gives other bits, and a large draw's moments sit within 6 standard errors
# of the distribution's
# --------------------------------------------------------------------------

N = 40000


def _mean_ok(x, mean, var):
    x = np.asarray(x, np.float64).reshape(-1)
    assert abs(x.mean() - mean) <= 6 * np.sqrt(var / x.size), (x.mean(), mean)


def _var_ok(x, var, kurt_excess=0.0):
    x = np.asarray(x, np.float64).reshape(-1)
    se = var * np.sqrt((2 + kurt_excess) / x.size)
    assert abs(x.var() - var) <= 6 * se, (x.var(), var)


def _probs():
    return P.to_tensor(np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]],
                                np.float32))


RANDOM = {
    "rand": (lambda: P.rand([N]), lambda x: (_mean_ok(x, .5, 1 / 12),
                                             _var_ok(x, 1 / 12, -1.2))),
    "randn": (lambda: P.randn([N]), lambda x: (_mean_ok(x, 0, 1),
                                               _var_ok(x, 1))),
    "uniform": (lambda: P.uniform([N], min=2.0, max=4.0),
                lambda x: (_mean_ok(x, 3, 1 / 3), _var_ok(x, 1 / 3, -1.2))),
    "normal": (lambda: P.normal(1.0, 2.0, [N]),
               lambda x: (_mean_ok(x, 1, 4), _var_ok(x, 4))),
    "randint": (lambda: P.randint(0, 10, [N]),
                lambda x: (_mean_ok(x, 4.5, 8.25),
                           np.testing.assert_array_equal(np.unique(x),
                                                         np.arange(10)))),
    "randint_like": (lambda: P.randint_like(P.zeros([N], "int64"), 3, 7),
                     lambda x: (_mean_ok(x, 4.5, 1.25),
                                np.testing.assert_array_equal(
                                    np.unique(x), np.arange(3, 7)))),
    "randperm": (lambda: P.randperm(50),
                 lambda x: np.testing.assert_array_equal(np.sort(x),
                                                         np.arange(50))),
    "bernoulli": (lambda: P.bernoulli(P.full([N], 0.3)),
                  lambda x: _mean_ok(x, .3, .21)),
    "multinomial": (lambda: P.multinomial(_probs(), 3000, replacement=True),
                    lambda x: [np.testing.assert_allclose(
                        np.bincount(row, minlength=3) / 3000, p, atol=0.035)
                        for row, p in zip(x, _probs().numpy())]),
    "standard_normal": (lambda: P.standard_normal([N]),
                        lambda x: (_mean_ok(x, 0, 1), _var_ok(x, 1))),
    "poisson": (lambda: P.poisson(P.full([N], 3.0)),
                lambda x: (_mean_ok(x, 3, 3), _var_ok(x, 3, 1 / 3))),
    "exponential_": (lambda: P.exponential_(P.zeros([N]), lam=2.0),
                     lambda x: (_mean_ok(x, .5, .25),
                                _var_ok(x, .25, 6.0))),
    "standard_gamma": (lambda: P.standard_gamma(P.full([N], 2.0)),
                       lambda x: (_mean_ok(x, 2, 2), _var_ok(x, 2, 3.0))),
    "binomial": (lambda: P.binomial(P.full([N], 10.0), P.full([N], 0.4)),
                 lambda x: (_mean_ok(x, 4, 2.4),
                            np.testing.assert_equal(x.dtype, np.int64))),
    "dpsgd": (lambda: P.dpsgd(P.zeros([N]), P.zeros([N]), learning_rate=1.0,
                              clip=1.0, batch_size=1.0, sigma=2.0),
              lambda x: (_mean_ok(x, 0, 4), _var_ok(x, 4))),
}


def test_every_random_op_has_a_check():
    names = {c.name for c in T.cases("creation", "math")
             if c.check == "random"}
    assert names == set(RANDOM)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_is_seeded_and_has_its_moments(name):
    draw, moments = RANDOM[name]
    P.seed(123)
    a = draw().numpy()
    state = P.get_rng_state()
    b = draw().numpy()
    P.seed(123)
    np.testing.assert_array_equal(draw().numpy(), a)
    P.set_rng_state(state)
    np.testing.assert_array_equal(draw().numpy(), b)
    P.seed(124)
    assert not np.array_equal(draw().numpy(), a)
    moments(a)
