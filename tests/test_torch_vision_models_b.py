"""`vision.models` of the port against the JAX package's, part b: DenseNet
(DenseNet-121), in float64 on both sides: after its 120 ReLUs a batch-
norm output within ~1e-6 of zero lands on the other side of the kink
between XLA's convolution and the port's in f32, which moves a gradient
by up to 4e-3. ShuffleNetV2 with swish (x1.0), in float64 too: in f32
its deep stack of depthwise convolutions leaves gradients 1.2-1.4x the
f32 bar apart by rounding alone. Each constructor's logits and every parameter's gradient,
and its state-dict names and order (`torch_vision_parity.check`)."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch

import paddle_tpu_torch as P
import torch_vision_parity as V
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

CASES = [
    ("densenet121", (1, 3, 32, 32), {"num_classes": 10, "dtype": "float64"}),
    ("shufflenet_v2_swish", (2, 3, 64, 64),
     {"num_classes": 10, "dtype": "float64"}),
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


@pytest.mark.parametrize("name,shape,kw", CASES, ids=[c[0] for c in CASES])
def test_constructor_matches_the_jax_model(name, shape, kw):
    V.check(name, shape, **kw)
