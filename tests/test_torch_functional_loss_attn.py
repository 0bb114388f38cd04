"""The port's losses, `extra_fns` and the rest of flash attention
(`nn.functional.loss`, `.extra_fns`, `flash_attn_unpadded`,
`flash_attn_varlen_qkvpacked`, `sdp_kernel`) against the JAX package's,
one parametrised case per public callable (`torch_op_cases`): the same
numpy inputs through both on the CPU, forward values to f32 rtol 1e-5 /
atol 1e-6, the gradient of sum(out * w) to 1e-5."""

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


VALUE = [c for c in T.cases("functional.loss", "functional.extra_fns",
                            "functional.flash_attention")
         if c.check != "random"]


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_matches_the_jax_package(c):
    T.check_against(paddle_tpu, P, c)
