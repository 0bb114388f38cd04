"""The parity checks the nn layer test files share (`test_torch_nn_*.py`):
one layer case of `torch_layer_cases` through the JAX package and the
port on the CPU, with the JAX layer's weights carried across."""

import numpy as np

import paddle_tpu
import paddle_tpu_torch as P
import torch_layer_cases as L
from paddle_tpu_torch.models.weights import layer_from_numpy


def state_of(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def check_value(c):
    """The JAX layer built from a seed, its state dict loaded into the
    port's (names, shapes and order equal), both called on the case's
    inputs: outputs, input and parameter gradients and buffers to f32
    rtol 1e-5 / atol 1e-6 (or the port against the case's numpy oracle
    where the JAX package departs from Paddle's formula)."""
    paddle_tpu.seed(11)
    ref_layer = c.make(paddle_tpu)
    state = state_of(ref_layer)
    ref = L.run(paddle_tpu, c, state=state)[1:]
    port_layer = layer_from_numpy(c.make(P), state)
    assert [(k, list(v.shape)) for k, v in port_layer.state_dict().items()] \
        == [(k, list(v.shape)) for k, v in ref_layer.state_dict().items()]
    assert [n for n, _ in port_layer.named_parameters()] == \
        [n for n, _ in ref_layer.named_parameters()]
    got = L.run(P, c, state=state)[1:]
    if c.ref_fixed is not None:
        expect = c.ref_fixed(*c.make_inputs())
        assert not all(np.allclose(r, e, rtol=L.RTOL, atol=L.ATOL)
                       for r, e in zip(ref[0], expect)), \
            f"{c.id}: the JAX package now agrees with Paddle's formula"
        for i, (e, g) in enumerate(zip(expect, got[0])):
            L.close(e, g, f"{c.id} output {i}")
        return
    L.compare(c, ref, got)


def check_random(c):
    """A random layer: the same seed gives the same output, another seed
    another; the output has the case's statistics; the inference form
    equals the JAX package's."""
    x = c.make_inputs()[0]
    outs = []
    for _ in range(2):
        P.seed(5)
        outs.append(L.run(P, c, with_grad=False)[1][0])
    np.testing.assert_array_equal(outs[0], outs[1])
    P.seed(6)
    assert not np.array_equal(L.run(P, c, with_grad=False)[1][0], outs[0])
    L.RANDOM_STATS[c.name](x, outs[0])
    paddle_tpu.seed(11)
    state = state_of(c.make(paddle_tpu))
    ref = L.run(paddle_tpu, c, state=state, train=False)[1:]
    got = L.run(P, c, state=state, train=False)[1:]
    L.compare(c, ref, got)
