"""The port's search, linalg and logic ops (`paddle_tpu_torch.ops.search`,
`ops.linalg`, `ops.logic`) against the JAX package's, one parametrised
case per public callable (`torch_op_cases`): the same numpy inputs through
both on the CPU, forward values to f32 rtol 1e-5 / atol 1e-6 under the
dtype map (ROADMAP §C), the gradient of sum(out * w) to 1e-5 where the op
is differentiable; decompositions (qr, svd, eig, eigh, eigvals,
pca_lowrank) up to the sign of each vector and eig's order."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as P
import torch_op_cases as T
from paddle_tpu_torch.framework import device as port_device


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


VALUE = [c for c in T.cases("search", "linalg", "logic")
         if c.check != "random"]


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)


def test_top_p_sampling_is_seeded_and_keeps_the_nucleus():
    """Random: held to seed reproducibility and to its support and
    frequencies, not to the JAX package's bits."""
    probs = np.array([[0.5, 0.3, 0.15, 0.05]] * 4000, np.float32)
    x = P.to_tensor(probs)
    ps = P.to_tensor(np.full((4000, 1), 0.7, np.float32))
    P.seed(7)
    sc, ids = P.top_p_sampling(x, ps)
    P.seed(7)
    np.testing.assert_array_equal(P.top_p_sampling(x, ps)[1].numpy(),
                                  ids.numpy())
    ids = ids.numpy().reshape(-1)
    assert ids.dtype == np.int64 and set(ids) <= {0, 1}
    freq = np.mean(ids == 0)
    assert abs(freq - 0.625) < 6 * np.sqrt(0.625 * 0.375 / ids.size), freq
    np.testing.assert_allclose(sc.numpy().reshape(-1), probs[0][ids])
    ref_sc, ref_ids = paddle_tpu.top_p_sampling(paddle_tpu.to_tensor(probs),
                                                paddle_tpu.to_tensor(
                                                    np.full((4000, 1), 0.7,
                                                            np.float32)))
    assert set(np.asarray(ref_ids.numpy()).reshape(-1)) <= {0, 1}
