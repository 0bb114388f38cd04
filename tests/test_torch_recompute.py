"""The port's `distributed.fleet.recompute` against the JAX package's on the
CPU:

  - `fleet.recompute` of a two-Linear block against the plain backward,
    on the port and on the JAX package (`tests/test_fleet.py:161`), the
    input's gradient too, and `recompute_sequential`;
  - the layer-built Llama (`LlamaConfig.tiny(num_hidden_layers=2)`) with
    `recompute=True` against the JAX model on the same weights: the loss
    relative and each parameter's gradient ||d|| / ||ref|| within 1e-5
    (f32), and equal to the port's own run without recompute;
  - dropout inside a recomputed block: the replay draws the bits the
    forward drew (the framework generator and the model-parallel
    tracker's state restored), so the gradients equal those of the same
    block without recompute; with `preserve_rng_state=False` they do not;
  - a block recomputed under auto_cast replays in the forward's scope;
  - under `no_grad` the function runs once, with no replay.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.layers.mpu.random import (
    get_rng_state_tracker)
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.weights import layer_from_numpy

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BAR = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _block_grads(M, recompute, x, state):
    lin1, lin2 = M.nn.Linear(8, 8), M.nn.Linear(8, 8)
    lin1.set_state_dict(state[0])
    lin2.set_state_dict(state[1])

    def block(h):
        return lin2(M.nn.functional.relu(lin1(h)))

    xt = M.to_tensor(x)
    xt.stop_gradient = False
    y = recompute(block, xt) if recompute else block(xt)
    loss = (y * y).sum()
    loss.backward()
    return (float(loss.numpy()), lin1.weight.grad.numpy(),
            lin2.bias.grad.numpy(), xt.grad.numpy())


def test_recompute_matches_plain_backward_and_the_jax_package():
    J.seed(11)
    state = [{k: v.numpy() for k, v in J.nn.Linear(8, 8).state_dict().items()}
             for _ in range(2)]
    x = np.random.default_rng(0).normal(size=(4, 8)).astype("float32")
    plain = _block_grads(P, None, x, state)
    port = _block_grads(P, fleet.recompute, x, state)
    ref = _block_grads(J, jfleet.recompute, x, state)
    assert abs(port[0] - plain[0]) <= 1e-6 * abs(plain[0])
    for got, want, base in zip(port[1:], ref[1:], plain[1:]):
        np.testing.assert_array_equal(got, base)
        assert _rel(got, want) <= BAR


def test_recompute_sequential_chunks_a_sequential():
    P.seed(3)
    net = P.nn.Sequential(P.nn.Linear(8, 8), P.nn.ReLU(), P.nn.Linear(8, 8),
                          P.nn.ReLU())
    x = P.to_tensor(np.random.default_rng(1).normal(size=(2, 8))
                    .astype("float32"))
    want = net(x)
    (want * want).sum().backward()
    g = net[0].weight.grad.numpy().copy()
    net.clear_gradients()
    got = fleet.recompute_sequential({"segments": 2}, net, x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    (got * got).sum().backward()
    np.testing.assert_array_equal(net[0].weight.grad.numpy(), g)


def _llama(M, mod, state=None, **kw):
    cfg = mod.LlamaConfig.tiny(num_hidden_layers=2, **kw)
    M.seed(0)
    m = mod.LlamaForCausalLM(cfg)
    if state is not None:
        layer_from_numpy(m, state)
    return m


def test_layer_llama_with_recompute_trains_as_the_jax_model():
    ref = _llama(J, jllama, recompute=True)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = _llama(P, tllama, state, recompute=True)
    plain = _llama(P, tllama, state)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 512, (2, 16)).astype(np.int64)
    labels = rng.integers(0, 512, (2, 16)).astype(np.int64)
    rl = ref(J.to_tensor(ids), labels=J.to_tensor(labels))
    rl.backward()
    losses = []
    for m in (port, plain):
        loss = m(P.to_tensor(ids), labels=P.to_tensor(labels))
        loss.backward()
        losses.append(float(loss.numpy()))
    assert abs(losses[0] - float(rl.numpy())) <= BAR * abs(float(rl.numpy()))
    assert losses[0] == losses[1]
    rgrads = {k: p.grad.numpy() for k, p in ref.named_parameters()}
    for (k, p), (_, q) in zip(port.named_parameters(),
                              plain.named_parameters()):
        assert _rel(p.grad.numpy(), rgrads[k]) <= BAR, k
        np.testing.assert_array_equal(p.grad.numpy(), q.grad.numpy())


def _dropout_run(recompute, preserve=True):
    P.seed(5)
    get_rng_state_tracker().reset()
    lin = P.nn.Linear(16, 16)
    seen = []

    def block(h):
        out = P.nn.functional.dropout(lin(h), p=0.5, training=True)
        seen.append((out.numpy() == 0))
        return out

    x = P.to_tensor(np.random.default_rng(2).normal(size=(4, 16))
                    .astype("float32"))
    x.stop_gradient = False
    y = fleet.recompute(block, x, preserve_rng_state=preserve) \
        if recompute else block(x)
    (y * y).sum().backward()
    return seen, lin.weight.grad.numpy(), x.grad.numpy()


def test_the_replay_draws_the_forwards_dropout_bits():
    seen, gw, gx = _dropout_run(True)
    assert len(seen) == 2                        # forward, then the replay
    np.testing.assert_array_equal(seen[0], seen[1])
    assert 0 < seen[0].mean() < 1
    base_seen, base_gw, base_gx = _dropout_run(False)
    np.testing.assert_array_equal(seen[0], base_seen[0])
    np.testing.assert_array_equal(gw, base_gw)
    np.testing.assert_array_equal(gx, base_gx)
    loose, _, _ = _dropout_run(True, preserve=False)
    assert not np.array_equal(loose[0], loose[1])


def test_the_tracker_state_is_restored_for_the_replay():
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add("model_parallel_rng", 1234)
    draws = []

    def block(h):
        with tracker.rng_state():
            mask = P.nn.functional.dropout(P.ones([64]), p=0.5)
        draws.append(mask.numpy())
        return h * 2.0

    x = P.to_tensor(np.ones((3,), "float32"))
    x.stop_gradient = False
    y = fleet.recompute(block, x)
    y.sum().backward()
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(x.grad.numpy(), np.full((3,), 2.0))
    tracker.reset()


def test_without_grad_the_function_runs_once():
    calls = []

    def block(h):
        calls.append(1)
        return h + 1.0

    with P.no_grad():
        out = fleet.recompute(block, P.to_tensor(np.zeros((2,), "float32")))
    assert calls == [1] and out.stop_gradient


def test_the_replay_runs_in_the_forwards_auto_cast_scope():
    """A block recomputed under auto_cast replays in bf16 as its forward
    ran, though the backward runs outside the scope: the gradients equal
    those of the same block without recompute."""
    grads = []
    for rc in (False, True):
        P.seed(7)
        lin = P.nn.Linear(16, 16)
        x = P.to_tensor(np.random.default_rng(3).normal(size=(4, 16))
                        .astype("float32"))
        x.stop_gradient = False
        with P.amp.auto_cast(dtype="bfloat16"):
            y = fleet.recompute(lin, x) if rc else lin(x)
        assert y.dtype == P.bfloat16
        (y.astype("float32") ** 2).sum().backward()
        grads.append((lin.weight.grad.numpy(), x.grad.numpy()))
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a, b)
