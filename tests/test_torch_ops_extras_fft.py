"""The rest of the port's top-level op surface against the JAX package's:
`ops/extras`, `ops/legacy_ps` and the `fft` namespace, one parametrised
case per public callable (`torch_op_cases`), the same numpy inputs through
both on the CPU; forward values to f32 rtol 1e-5 / atol 1e-6 under the
dtype map (ROADMAP §C), the gradient of sum(out * w) to 1e-5 where the op
is differentiable. Where the JAX package raises (from_dlpack of a capsule)
the port is held to numpy. The sampling ops of legacy_ps draw from numpy's
RandomState in both packages and are compared value for value. Also: the
`linalg` namespace re-exports the port's linalg ops."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
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


VALUE = T.cases("extras", "legacy_ps", "fft")


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)


def test_linalg_namespace_is_the_jax_packages():
    import paddle_tpu.linalg as ref

    assert sorted(P.linalg.__all__) == sorted(ref.__all__)
    from paddle_tpu_torch.ops import linalg as ops_linalg

    assert P.linalg.inv is P.linalg.inverse
    for name in P.linalg.__all__:
        assert getattr(P.linalg, name) is getattr(
            ops_linalg, "inverse" if name == "inv" else name)


def test_fftfreq_with_no_place_lands_on_the_creation_place():
    assert P.fft.fftfreq(4).place == P.to_tensor([1.0]).place


def test_take_raises_on_an_index_out_of_range():
    x = P.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert P.take(x, P.to_tensor([-1, 0])).tolist() == [4.0, 1.0]
    with pytest.raises(IndexError, match="out of range"):
        P.take(x, P.to_tensor([4]))
