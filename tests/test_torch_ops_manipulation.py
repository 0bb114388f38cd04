"""The port's manipulation ops (`paddle_tpu_torch.ops.manipulation`)
against the JAX package's, one parametrised case per public callable
(`torch_op_cases`): the same numpy inputs through both on the CPU, forward
values to f32 rtol 1e-5 / atol 1e-6 under the dtype map (ROADMAP §C), the
gradient of sum(out * w) to 1e-5 where the op is differentiable."""

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


VALUE = T.cases("manipulation")


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)
