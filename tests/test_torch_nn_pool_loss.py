"""The port's pooling layers and the first losses (through the triplet
losses) against the JAX package's: the cases of group `pool_loss` of
`torch_layer_cases`, each checked by `torch_layer_parity` (the JAX
layer's weights carried across, outputs, input and parameter gradients
and buffers to f32 rtol 1e-5 / atol 1e-6). The table and the check that
every layer class has a case are described in
`test_torch_nn_layers.py`."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

import paddle_tpu_torch as P
import torch_layer_cases as L
from paddle_tpu_torch.framework import device as port_device
from torch_layer_parity import check_value

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


@pytest.mark.parametrize("c", L.group("pool_loss"), ids=lambda c: c.id)
def test_layer_matches_the_jax_package(c):
    check_value(c)
