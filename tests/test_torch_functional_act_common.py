"""The port's activations, common functionals and norms
(`nn.functional.activation`, `.common`, `.norm`) against the JAX
package's, one parametrised case per public callable (`torch_op_cases`):
the same numpy inputs through both on the CPU, forward values to f32 rtol
1e-5 / atol 1e-6, the gradient of sum(out * w) to 1e-5. `interpolate`'s
modes that jax.image.resize departs from (align_corners, align_mode,
bicubic, area, downsampling) are held to a numpy oracle of Paddle's
formulas (the `upsample` case), as is `unfold` with four paddings.

The random functionals (the dropouts, rrelu in training, gumbel_softmax,
feature_alpha_dropout, fractional pooling with no random_u) draw from
torch's generators, not threefry: they are held to seed reproducibility
and to their statistics, and their inference forms to the JAX package."""

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


VALUE = [c for c in T.cases("functional.activation", "functional.common",
                            "functional.norm") if c.check != "random"]


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)


# --------------------------------------------------------------------------
# the random functionals
# --------------------------------------------------------------------------

N = 40000


def _mean_ok(x, mean, var):
    x = np.asarray(x, np.float64).reshape(-1)
    assert abs(x.mean() - mean) <= 6 * np.sqrt(var / x.size), (x.mean(), mean)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _dropout_moments(y):
    # ones in: a kept element is 1 / (1 - 0.3), a dropped one 0
    y = y.reshape(-1)
    vals = np.unique(y)
    assert len(vals) == 2 and vals[0] == 0 and abs(vals[1] - 1 / 0.7) < 1e-6
    _mean_ok(y == 0, 0.3, 0.21)


def _channel_dropout(axis_len):
    def check(y):
        kept = y.reshape(y.shape[0] * y.shape[1], -1) if axis_len == 1 \
            else np.moveaxis(y, -1, 1).reshape(y.shape[0] * y.shape[-1], -1)
        rows = np.unique(kept, axis=1)
        assert rows.shape[1] == 1   # a whole channel kept or dropped
        _mean_ok(rows[:, 0] == 0, 0.3, 0.21)
    return check


def _selu_moments(y):
    # standard normal in, alpha dropout keeps mean 0 and variance 1
    y = y.reshape(-1)
    assert abs(y.mean()) < 0.05 and abs(y.var() - 1.0) < 0.05, (
        y.mean(), y.var())


def _rrelu(y):
    # -1 in: the slope of each element uniform in [1/8, 1/3)
    s = -y.reshape(-1)
    assert s.min() >= 1 / 8 and s.max() < 1 / 3
    _mean_ok(s, (1 / 8 + 1 / 3) / 2, (1 / 3 - 1 / 8) ** 2 / 12)


_LOGITS = np.log(np.array([0.1, 0.2, 0.7], np.float32))


def _gumbel(y):
    # hard one-hot rows; the Gumbel-max trick picks class i with p_i
    assert np.all(y.sum(-1) == 1) and set(np.unique(y)) <= {0.0, 1.0}
    freq = y.mean(0)
    for f, p in zip(freq, [0.1, 0.2, 0.7]):
        assert abs(f - p) <= 6 * np.sqrt(p * (1 - p) / y.shape[0]), freq


def _fractional(y):
    assert y.shape == (1, 2, 3, 4)


F = P.nn.functional
RANDOM = {
    "dropout": (lambda: F.dropout(P.ones([N]), 0.3), _dropout_moments),
    "dropout2d": (lambda: F.dropout2d(P.ones([40, 50, 2, 2]), 0.3),
                  _channel_dropout(1)),
    "dropout3d": (lambda: F.dropout3d(P.ones([40, 2, 2, 2, 50]), 0.3,
                                      data_format="NDHWC"),
                  _channel_dropout(-1)),
    "alpha_dropout": (lambda: F.alpha_dropout(P.to_tensor(_x(N)), 0.2),
                      _selu_moments),
    "feature_alpha_dropout": (lambda: F.feature_alpha_dropout(
        P.to_tensor(_x(400, 100, 4)), 0.2), _selu_moments),
    "rrelu": (lambda: F.rrelu(P.full([N], -1.0), training=True), _rrelu),
    "gumbel_softmax": (lambda: F.gumbel_softmax(
        P.to_tensor(np.tile(_LOGITS, (N, 1))), hard=True), _gumbel),
    "fractional_max_pool2d": (lambda: F.fractional_max_pool2d(
        P.to_tensor(_x(1, 2, 7, 9)), [3, 4]), _fractional),
}


def test_every_random_functional_has_a_check():
    names = {c.name for c in T.CASES if c.check == "random"
             and c.module.startswith("functional.")}
    assert names <= set(RANDOM)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_functional_is_seeded_and_has_its_statistics(name):
    draw, stats = RANDOM[name]
    P.seed(11)
    a = draw().numpy()
    state = P.get_rng_state()
    b = draw().numpy()
    P.seed(11)
    np.testing.assert_array_equal(draw().numpy(), a)
    P.set_rng_state(state)
    np.testing.assert_array_equal(draw().numpy(), b)
    P.seed(12)
    assert not np.array_equal(draw().numpy(), a)
    stats(a)


@pytest.mark.parametrize("mod, call", [
    ("dropout", lambda F, x: F.dropout(x, 0.3, training=False)),
    ("dropout", lambda F, x: F.dropout(x, 0.3, training=False,
                                       mode="downscale_in_infer")),
    ("dropout2d", lambda F, x: F.dropout2d(x, 0.4, training=False)),
    ("dropout3d", lambda F, x: F.dropout3d(x[None], 0.4, training=False)),
    ("alpha_dropout", lambda F, x: F.alpha_dropout(x, 0.4, training=False)),
    ("feature_alpha_dropout",
     lambda F, x: F.feature_alpha_dropout(x, 0.4, training=False)),
    ("dropout", lambda F, x: F.dropout(x, 0.0)),
])
def test_random_functional_in_inference_matches_the_jax_package(mod, call):
    x = _x(2, 3, 4, 5, seed=3)
    got = call(P.nn.functional, P.to_tensor(x)).numpy()
    ref = np.asarray(call(paddle_tpu.nn.functional,
                          paddle_tpu.to_tensor(x)).numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_dropout_gradient_flows_through_the_kept_elements():
    x = P.to_tensor(_x(1000), stop_gradient=False)
    P.seed(5)
    y = F.dropout(x, 0.5)
    y.sum().backward()
    keep = y.numpy() != 0
    np.testing.assert_allclose(x.grad.numpy(), np.where(keep, 2.0, 0.0))
