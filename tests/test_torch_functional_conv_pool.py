"""The port's convolutions and pooling (`nn.functional.conv`,
`nn.functional.pooling`) against the JAX package's, one parametrised case
per public callable (`torch_op_cases`), f32 on the CPU in both packages at
the f32 bars (rtol 1e-5 / atol 1e-6, gradients 1e-5). Where the JAX
package departs from Paddle (ceil_mode, divisor_override and exclusive
"SAME" averages, transposed convolutions with string padding or groups,
max-pool indices with padding) the port is held to a numpy oracle of
Paddle's formula, and the JAX package's outputs must differ from it."""

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


VALUE = T.cases("functional.conv", "functional.pooling")


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)
