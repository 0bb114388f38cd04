"""The port's op table (`torch_op_cases`) on an NVIDIA card against the
port's own results on the CPU: every case that is not random, forward and
gradient. Marked `cuda`; the tests skip where there is no card. This file
imports neither JAX nor the reference package, so the card's machine runs
it without them, from the repo's root:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_eager_cuda.py

Bars: rtol 1e-4, atol 1e-5, ten times the CPU parity bars: cuBLAS,
cuSOLVER and the card's reductions sum in other orders than the CPU's, and
the decompositions (lstsq, pinv, cond) amplify that.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import torch_op_cases as T
from paddle_tpu_torch.framework import device as port_device

pytestmark = pytest.mark.cuda

CARD_RTOL, CARD_ATOL = 1e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the port's card path runs only on a card")
    prev = port_device._current
    yield torch.device("cuda", torch.cuda.current_device())
    port_device._current = prev


VALUE = [c for c in T.CASES if c.check != "random"]


@pytest.mark.parametrize("c", VALUE, ids=lambda c: c.id)
def test_op_on_the_card_matches_the_port_on_the_cpu(card, c):
    paddle.set_device("cpu")
    ref, ref_grads = T.run(paddle, c)
    paddle.set_device("gpu")
    got, got_grads = T.run(paddle, c)
    T.compare(c, ref, got, rtol=CARD_RTOL, atol=CARD_ATOL)
    for i, r, g in zip(c.grad, ref_grads or (), got_grads or ()):
        np.testing.assert_allclose(g, r, rtol=CARD_RTOL, atol=CARD_ATOL,
                                   err_msg=f"{c.id} grad of input {i}")


def test_creation_with_no_place_lands_on_the_current_card(card):
    port_device._current = None
    for t in (paddle.to_tensor([1.0, 2.0]), paddle.zeros([2]),
              paddle.randn([2]), paddle.arange(3)):
        assert t.place == card
    paddle.set_device("gpu:0")
    assert paddle.get_device() == "gpu:0"
