"""`vision.models` of the port against the JAX package's, part a: ResNet
(BasicBlock: ResNet-18; BottleneckBlock with groups and width:
ResNeXt-50 32x4d), VGG (VGG-11 with batch norm), AlexNet and LeNet. Each
constructor's logits and every parameter's gradient, and its state-dict
names and order (`torch_vision_parity.check`)."""

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
    ("resnet18", (2, 3, 64, 64), {"num_classes": 10}),
    ("resnext50_32x4d", (1, 3, 32, 32), {"num_classes": 10}),
    ("vgg11", (1, 3, 32, 32), {"num_classes": 10, "batch_norm": True}),
    ("alexnet", (2, 3, 64, 64), {"num_classes": 10}),
    ("LeNet", (2, 1, 28, 28), {}),
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
