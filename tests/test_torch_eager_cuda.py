"""The port's op table (`torch_op_cases`) on an NVIDIA card against the
port's own results on the CPU: every case that is not random, forward and
gradient. Marked `cuda`; the tests skip where there is no card. This file
imports neither JAX nor the reference package, so the card's machine runs
it without them, from the repo's root:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_eager_cuda.py

Bars: rtol 1e-4, atol 1e-5, ten times the CPU parity bars: cuBLAS,
cuSOLVER and the card's reductions sum in other orders than the CPU's, and
the decompositions (lstsq, pinv, cond) amplify that. The fixture turns
TF32 off for cuBLAS and cuDNN while a test runs (f32 convolutions and
matmuls would otherwise round their inputs to 10 bits) and restores the
caller's settings after it.

Also: `nn.functional.rms_norm` on the card launches B9 forward and B10
backward on the gate, and nothing off it.

The layer table (`torch_layer_cases`, one case per nn layer class) runs
here too: each value case's layer built on the CPU from a seed, its state
loaded into the same layer on the card, outputs, input and parameter
gradients and buffers against the CPU run at the same bars. `nn.RMSNorm`
launches B9/B10 and `nn.MultiHeadAttention` B1-B3 on their gates only.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import torch_layer_cases as L
import torch_op_cases as T
from paddle_tpu_torch.framework import device as port_device

pytestmark = pytest.mark.cuda

CARD_RTOL, CARD_ATOL = 1e-4, 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the port's card path runs only on a card")
    prev = port_device._current
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = tf32
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_launches_b9_and_b10_on_the_gate_only(card, dtype):
    from paddle_tpu_torch.kernels import rms_norm as rn

    paddle.set_device("gpu")
    F = paddle.nn.functional
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((64, 256)).astype(np.float32),
                         stop_gradient=False)
    w = paddle.to_tensor(rng.standard_normal(256).astype(np.float32),
                         stop_gradient=False)
    xd, wd = x.astype(dtype), w.astype(dtype)
    rn.reset_launches()
    F.rms_norm(xd, wd).astype("float32").sum().backward()
    assert rn.launches == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}
    odd = paddle.to_tensor(rng.standard_normal((4, 260)).astype(np.float32))
    F.rms_norm(odd, paddle.ones([260]))
    F.rms_norm(xd, w.astype("float16"))
    F.rms_norm(xd)
    assert rn.launches == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}


LAYERS = [c for c in L.CASES if c.check == "value"]


@pytest.mark.parametrize("c", LAYERS, ids=lambda c: c.id)
def test_layer_on_the_card_matches_the_port_on_the_cpu(card, c):
    paddle.set_device("cpu")
    paddle.seed(11)
    state = {k: v.numpy() for k, v in c.make(paddle).state_dict().items()}
    ref = L.run(paddle, c, state=state)[1:]
    paddle.set_device("gpu")
    layer, *got = L.run(paddle, c, state=state)
    assert all(p.place == card for p in layer.parameters())
    L.compare(c, ref, got, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_layer_launches_b9_and_b10_on_the_gate_only(card, dtype):
    from paddle_tpu_torch.kernels import rms_norm as rn

    paddle.set_device("gpu")
    rng = np.random.default_rng(1)
    norm = paddle.nn.RMSNorm(256).to(dtype=dtype)
    x = paddle.to_tensor(rng.standard_normal((4, 16, 256)).astype(
        np.float32)).astype(dtype)
    x.stop_gradient = False
    rn.reset_launches()
    norm(x).astype("float32").sum().backward()
    assert rn.launches == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}
    assert norm.weight.grad is not None and x.grad is not None
    paddle.nn.RMSNorm(260)(paddle.ones([2, 260]))   # H % 8 != 0: off the gate
    assert rn.launches == {"rms_norm_fwd": 1, "rms_norm_bwd": 1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_head_attention_launches_b1_to_b3_on_the_gate_only(card,
                                                                 dtype):
    from paddle_tpu_torch.kernels import flash_attention as fa

    paddle.set_device("gpu")
    rng = np.random.default_rng(2)
    mha = paddle.nn.MultiHeadAttention(256, 2).to(dtype=dtype)  # head_dim 128
    x = paddle.to_tensor(rng.standard_normal((2, 64, 256)).astype(
        np.float32)).astype(dtype)
    x.stop_gradient = False
    fa.reset_launches()
    mha(x).astype("float32").sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    mask = paddle.zeros([2, 1, 64, 64])
    mha(x, attn_mask=mask)                                 # a mask: plain
    paddle.nn.MultiHeadAttention(8, 2).to(dtype=dtype)(
        paddle.ones([1, 4, 8]).astype(dtype))              # head_dim 4
    assert fa.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
