"""The port's diffusion UNet (`paddle_tpu_torch/models/unet.py`) against
the JAX package's (`paddle_tpu/models/unet.py`) on the CPU, and the shape
helpers a dynamic-batch export runs through.

  - `unet_tiny` and its gate variant (`torch_unet_parity.CONFIGS`): the
    same weights (`layer_from_numpy`) and inputs; the output within 1e-5 of
    its largest magnitude and every parameter's gradient of sum(out * w)
    within ||port - jax|| <= 1e-5 ||jax||. The JAX side runs once a config
    (a module-scoped fixture), functionalized under one
    `jax.jit(jax.value_and_grad)`; its attention is the plain reference on
    the CPU, the port's the plain attention (tiny) or B1's custom op with
    its plain version (gate);
  - `Upsample2x`'s nearest 2x equal to the JAX package's, bit for bit;
  - state-dict names, shapes and order equal to the JAX package's;
  - `ops._common.int_shape` keeps a `torch.SymInt` as it is, so a layer
    that reshapes, transposes, unsqueezes, concatenates and interpolates
    exports with a dynamic batch and serves batches 1-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
import torch_unet_parity as U
from paddle_tpu import jit as pjit
from paddle_tpu.models import unet as junet
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.ops._common import int_shape

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

LOGIT_BAR, GRAD_BAR = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


@pytest.fixture(scope="module", params=sorted(U.CONFIGS))
def pair(request):
    """(config, port model, port out, port grads, JAX out, JAX grads)."""
    ref, port, _ = U.build(**U.CONFIGS[request.param])
    x, t = U.inputs(2)
    w = np.random.default_rng(2).standard_normal(
        (2, 4, U.SIZE, U.SIZE)).astype("float32")

    out = port(P.to_tensor(x), P.to_tensor(t))
    (out * P.to_tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}

    pure_fn, params, buffers = pjit.functionalize(ref)

    def loss(params):
        o, _ = pure_fn(params, buffers, jax.random.key(0), jnp.asarray(x),
                       jnp.asarray(t))
        return jnp.sum(o * w), o

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return (request.param, port, out.numpy(), grads, np.asarray(want),
            {k: np.asarray(v) for k, v in jgrads.items()})


def test_output_matches_the_jax_unet(pair):
    _, _, got, _, want, _ = pair
    assert got.shape == want.shape == (2, 4, U.SIZE, U.SIZE)
    assert np.abs(got - want).max() <= LOGIT_BAR * np.abs(want).max()


def test_every_gradient_matches_the_jax_unet(pair):
    _, port, _, grads, _, want = pair
    assert set(grads) == set(want) and len(want) == 128
    worst = max((np.linalg.norm(grads[n] - g) / np.linalg.norm(g), n)
                for n, g in want.items())
    assert worst[0] <= GRAD_BAR, worst


def test_the_gate_variant_runs_b1s_op_and_the_tiny_one_does_not(pair):
    """On the CPU the gate variant's attention goes through B1's custom op
    (its plain version); unet_tiny's head_dim 16 takes the plain path."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    name, port, *_ = pair
    calls = []
    op = fa._flash_fwd_op
    fa._flash_fwd_op = lambda *a: calls.append(a) or op(*a)
    try:
        x, t = U.inputs(1)
        with P.no_grad():
            port(P.to_tensor(x), P.to_tensor(t))
    finally:
        fa._flash_fwd_op = op
    # level 1: one attention down, two up, one in the middle
    assert len(calls) == (4 if name == "gate" else 0)


def test_state_dict_names_shapes_and_order_match_the_jax_unet():
    ref, port, _ = U.build()
    assert [(k, list(v.shape)) for k, v in port.state_dict().items()] == \
        [(k, list(v.shape)) for k, v in ref.state_dict().items()]
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]


def test_upsample2x_nearest_matches_the_jax_package_exactly():
    import paddle_tpu

    x = np.random.default_rng(3).standard_normal((2, 3, 5, 7)).astype(
        "float32")
    got = P.nn.functional.interpolate(P.to_tensor(x), scale_factor=2,
                                      mode="nearest").numpy()
    want = paddle_tpu.nn.functional.interpolate(
        paddle_tpu.to_tensor(x), scale_factor=2, mode="nearest").numpy()
    assert got.shape == (2, 3, 10, 14)
    np.testing.assert_array_equal(got, want)
    # and through the layer, weights carried across
    paddle_tpu.seed(0)
    ref = junet.Upsample2x(3)
    port = tunet.Upsample2x(3)
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    np.testing.assert_allclose(port(P.to_tensor(x)).numpy(),
                               ref(paddle_tpu.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_int_shape_keeps_a_symbolic_dim_and_fixes_the_rest():
    assert int_shape([np.int64(2), 3, P.to_tensor(4)]) == (2, 3, 4)
    assert int_shape(np.int32(5)) == (5,)
    assert int_shape(P.to_tensor([6, 7])) == (6, 7)
    seen = {}

    class M(torch.nn.Module):
        def forward(self, x):
            seen["shape"] = int_shape([x.shape[0], np.int64(2),
                                       x.shape[1] // 2])
            return x.reshape(seen["shape"])

    torch.export.export(M(), (torch.zeros(3, 4),), strict=False,
                        dynamic_shapes=({0: torch.export.Dim("b")},))
    assert isinstance(seen["shape"][0], torch.SymInt)
    assert seen["shape"][1:] == (2, 2)
    assert all(type(d) is int for d in seen["shape"][1:])


class _Shapes(P.nn.Layer):
    """reshape, transpose, unsqueeze, concat and interpolate on the batch
    the input brings (AttentionBlock's and ResnetBlock's shape work)."""

    def __init__(self):
        super().__init__()
        self.fc = P.nn.Linear(6, 6)

    def forward(self, x, t):
        b, c, h, w = x.shape
        y = P.reshape(x, [b, c, h * w])
        y = P.transpose(y, [0, 2, 1])
        y = P.reshape(self.fc(y), [b, h, w, c])
        y = P.transpose(y, [0, 3, 1, 2])
        y = y + P.unsqueeze(P.unsqueeze(t, -1), -1)
        y = P.concat([y, x], axis=1)
        return P.nn.functional.interpolate(y, scale_factor=2, mode="nearest")


def test_a_dynamic_batch_traces_through_the_shape_ops(tmp_path):
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.hapi.model import InputSpec

    P.seed(0)
    m = _Shapes()
    prefix = str(tmp_path / "shapes")
    P.jit.save(m, prefix, input_spec=[
        InputSpec(["batch", 6, 3, 5], "float32"),
        InputSpec(["batch", 6], "float32")])
    cfg = inference.Config(prefix)
    cfg.disable_gpu()
    pred = inference.create_predictor(cfg)
    for b in (1, 2, 3):
        rng = np.random.default_rng(b)
        x = rng.standard_normal((b, 6, 3, 5)).astype("float32")
        t = rng.standard_normal((b, 6)).astype("float32")
        out = pred.run([x, t])[0]
        want = m(P.to_tensor(x), P.to_tensor(t)).numpy()
        assert tuple(out.shape) == (b, 12, 6, 10)
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
