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

The A10c/A10d layers: BERT launches B1-B3 only with no mask and no
dropout in training, ViT launches them in training, GPT's layer weights
generate through B5 and B4 (`gpt_params_from_layer`), and every
`vision.models` family's logits on the card match the CPU's.
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


# the A10c/A10d layers on the card (GPT/BERT as nn.Layers, the vision zoo)
def _bert(dropout, layers=2):
    from paddle_tpu_torch.models import bert_tiny

    return bert_tiny(hidden_size=128, num_attention_heads=2,   # head_dim 64
                     intermediate_size=256, num_hidden_layers=layers,
                     hidden_dropout_prob=dropout)


def test_bert_launches_b1_to_b3_on_the_gate_only(card):
    """No mask and no dropout in training (or eval()): B1 a layer forward,
    B2/B3 a layer backward; a mask or dropout in training: none."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import BertPretrainingLoss

    paddle.set_device("gpu")
    rng = np.random.default_rng(3)
    ids = paddle.to_tensor(rng.integers(0, 1024, (2, 32)).astype(np.int64))
    mlm = paddle.to_tensor(rng.integers(0, 1024, (2, 32)).astype(np.int64))
    model = _bert(0.0)
    fa.reset_launches()
    BertPretrainingLoss()(model(ids), mlm).backward()
    assert fa.launches == {"flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}
    mask = paddle.ones([2, 32], dtype="int64")
    model(ids, attention_mask=mask)                      # a mask: plain
    dropped = _bert(0.1)
    dropped(ids)                                         # dropout: plain
    assert fa.launches["flash_fwd"] == 2
    dropped.eval()
    with paddle.no_grad():
        dropped(ids)                                     # eval(): B1
    assert fa.launches["flash_fwd"] == 4


def test_vit_launches_b1_to_b3_in_training(card):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.vision.models import vit_tiny

    paddle.set_device("gpu")
    model = vit_tiny(embed_dim=128, num_heads=2, depth=2)    # head_dim 64
    x = paddle.to_tensor(np.random.default_rng(4).standard_normal(
        (2, 3, 32, 32)).astype(np.float32))
    fa.reset_launches()
    model(x).sum().backward()
    assert fa.launches == {"flash_fwd": 2, "flash_bwd_dq": 2,
                           "flash_bwd_dkv": 2}


def test_gpt_generate_from_layers_launches_b4_and_b5(card):
    """The layer model's own attention is masked (plain); its weights
    through gpt_params_from_layer generate on B5 (prefill) and B4
    (decode), greedily equal to the layer model's argmax."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import (Gpt, GPTGenArgs, gpt_generate,
                                         gpt_params_from_layer, gpt_tiny)

    paddle.set_device("gpu")
    layer = gpt_tiny(hidden_size=128, num_attention_heads=2,
                     intermediate_size=256)
    layer.eval()
    prompt = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(
        np.int32)
    fa.reset_launches()
    at.reset_launches()
    with paddle.no_grad():
        layer(paddle.to_tensor(prompt.astype(np.int64)))
    assert fa.launches["flash_fwd"] == 0
    model = Gpt(GPTGenArgs.from_config(layer.gpt.cfg),
                gpt_params_from_layer(layer))
    out = gpt_generate(model, prompt, max_new_tokens=4).cpu().numpy()
    L = layer.gpt.cfg.num_hidden_layers
    assert at.launches["window_attention"] == L            # one a layer
    assert at.launches["decode_attention"] == L * 3        # 3 decode steps
    with paddle.no_grad():
        logits = layer(paddle.to_tensor(out[:, :-1].astype(np.int64)))
    np.testing.assert_array_equal(logits.numpy()[:, 11:].argmax(-1),
                                  out[:, 12:])


ZOO = [("resnet18", (2, 3, 64, 64), {"num_classes": 10}),
       ("resnext50_32x4d", (1, 3, 32, 32), {"num_classes": 10}),
       ("vgg11", (1, 3, 32, 32), {"num_classes": 10, "batch_norm": True}),
       ("alexnet", (2, 3, 64, 64), {"num_classes": 10}),
       ("LeNet", (2, 1, 28, 28), {}),
       ("densenet121", (1, 3, 32, 32), {"num_classes": 10}),
       ("googlenet", (2, 3, 64, 64), {"num_classes": 10}),
       ("inception_v3", (1, 3, 75, 75), {"num_classes": 10}),
       ("vit_tiny", (2, 3, 32, 32), {}),
       ("mobilenet_v1", (2, 3, 64, 64), {"scale": 0.25, "num_classes": 10}),
       ("mobilenet_v2", (2, 3, 64, 64), {"scale": 0.25, "num_classes": 10}),
       ("mobilenet_v3_small", (2, 3, 64, 64), {"scale": 0.5,
                                               "num_classes": 10}),
       ("mobilenet_v3_large", (2, 3, 64, 64), {"scale": 0.35,
                                               "num_classes": 10}),
       ("shufflenet_v2_x0_25", (2, 3, 64, 64), {"num_classes": 10}),
       ("squeezenet1_1", (2, 3, 64, 64), {"num_classes": 10})]


@pytest.mark.parametrize("name,shape,kw", ZOO, ids=[z[0] for z in ZOO])
def test_zoo_forward_on_the_card_matches_the_port_on_the_cpu(card, name,
                                                             shape, kw):
    """Every vision.models family in eval(), built on the CPU from a seed,
    its state loaded into the same model on the card: the logits to the
    card bars (max |d| <= rtol * max |cpu| + atol)."""
    from paddle_tpu_torch.vision import models

    def logits(out):   # GoogLeNet: (logits, None, None) in eval()
        return (out[0] if isinstance(out, (tuple, list)) else out).numpy()

    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    paddle.set_device("cpu")
    paddle.seed(0)
    cpu_model = getattr(models, name)(**kw).eval()
    state = {k: v.numpy() for k, v in cpu_model.state_dict().items()}
    with paddle.no_grad():
        want = logits(cpu_model(paddle.to_tensor(x)))
    paddle.set_device("gpu")
    model = getattr(models, name)(**kw)
    model.set_state_dict(state)
    model.eval()
    assert all(p.place == card for p in model.parameters())
    with paddle.no_grad():
        got = logits(model(paddle.to_tensor(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CARD_RTOL * np.abs(want).max() + \
        CARD_ATOL
