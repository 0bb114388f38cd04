"""`vision.models` of the port against the JAX package's, part c: ViT
(vit_tiny), MobileNet v1 (scale 0.25), v2 (scale 0.25) and v3 (small,
scale 0.5), ShuffleNetV2 (x0.25) and SqueezeNet (1.0 and 1.1). Each
constructor's logits and every parameter's gradient, and its state-dict
names and order (`torch_vision_parity.check`); and the clip activations'
gradients at their clip points."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
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
    ("vit_tiny", (2, 3, 32, 32), {}),
    ("mobilenet_v1", (2, 3, 64, 64), {"scale": 0.25, "num_classes": 10}),
    ("mobilenet_v2", (2, 3, 64, 64), {"scale": 0.25, "num_classes": 10}),
    ("mobilenet_v3_small", (2, 3, 64, 64), {"scale": 0.5, "num_classes": 10}),
    ("shufflenet_v2_x0_25", (2, 3, 64, 64), {"num_classes": 10}),
    ("squeezenet1_0", (2, 3, 64, 64), {"num_classes": 10}),
    ("squeezenet1_1", (2, 3, 64, 64), {"num_classes": 10}),
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


@pytest.mark.parametrize("fn,points", [
    ("relu6", (0.0, 6.0)), ("hardtanh", (-1.0, 1.0)),
    ("hardsigmoid", (-3.0, 3.0)), ("hardswish", (-3.0, 3.0))])
def test_clip_activations_have_paddles_gradient_at_their_clip_points(
        fn, points):
    """MobileNetV2 feeds ReLU6 exact zeros (a batch norm of a zero
    patch), MobileNetV3 hardswish/hardsigmoid. At a clip point Paddle's
    gradient is 0; so is the port's. The JAX package's relu6 agrees; its
    jnp.clip-based hardtanh, hardsigmoid and hardswish give 0.5 there (a
    departure from Paddle, ROADMAP §C), which this test asserts still
    holds."""
    import paddle_tpu

    slope = {"hardsigmoid": {"slope": 1.0 / 6.0, "offset": 0.5}}.get(fn, {})
    x = np.array(points + (0.25,), np.float32)
    t = P.to_tensor(x, stop_gradient=False)
    getattr(P.nn.functional, fn)(t, **slope).sum().backward()
    got = t.grad.numpy()
    # hardswish = x * clip(x + 3, 0, 6) / 6: its clip's share vanishes at
    # -3 and 3, leaving 0 and 1 there
    want = [0.0, 1.0] if fn == "hardswish" else [0.0, 0.0]
    np.testing.assert_allclose(got[:2], want, atol=1e-6)
    jt = paddle_tpu.to_tensor(x, stop_gradient=False)
    getattr(paddle_tpu.nn.functional, fn)(jt, **slope).sum().backward()
    ref = np.asarray(jt.grad.numpy())
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-6)
    if fn == "relu6":
        np.testing.assert_array_equal(got, ref)
    else:
        assert not np.allclose(got[:2], ref[:2]), \
            f"{fn}: the JAX package now agrees with Paddle at the clip points"
