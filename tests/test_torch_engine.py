"""The port's `distributed.Engine` against the JAX package's `Engine` on the
CPU, both at dp=1, the JAX model's weights carried across: 5 train_batch
steps of `bert_tiny` under AdamW (with apply_decay_param_fun), SGD,
Momentum with Nesterov and Adam (L2), the losses and the parameters after
`sync_to_model` (f32 rtol 1e-5 / atol 1e-6; the Adam family's by
`ADAM_BAR`); a CNN with BatchNorm (the engine's buffers, the model's left
as they were until sync). The engine's options, AMP, eval and predict,
and what raises: `test_torch_engine_options.py`."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.weights import layer_from_numpy
from torch_engine_parity import (ATOL, BOTH, RTOL, STEPS, _bert_batch,
                                 _bert_models, _cnn, _float, _optimizer,
                                 _params_match, _state)

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


@pytest.fixture(scope="module")
def bert_state():
    paddle_tpu.seed(0)
    return _state(jbert.bert_tiny())


@pytest.mark.parametrize("kind", ["adamw", "sgd", "momentum", "adam"])
def test_five_bert_steps_match_the_jax_engine(bert_state, kind):
    models = _bert_models(bert_state)
    inputs, labels = _bert_batch()
    losses = {}
    for name, M, E in BOTH:
        mod = tbert if name == "port" else jbert
        m = models[name]
        eng = E(m, loss=mod.BertPretrainingLoss(),
                optimizer=_optimizer(M, kind, m), dp=1, sharding_stage=2)
        losses[name] = [_float(eng.train_batch(inputs, labels))
                        for _ in range(STEPS)]
        if name == "port":
            # the model is untouched until sync_to_model
            np.testing.assert_array_equal(
                m.bert.pooler.weight.numpy(),
                bert_state["bert.pooler.weight"])
        eng.sync_to_model()
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)
    assert losses["port"][-1] < losses["port"][0]
    _params_match(models["port"], models["jax"],
                  lr=1e-3 if kind.startswith("adam") else None,
                  start=bert_state)


def test_a_cnn_with_batch_norm_keeps_its_buffers_in_the_engine():
    paddle_tpu.seed(3)
    ref = _cnn(paddle_tpu)
    state = _state(ref)
    port = layer_from_numpy(_cnn(P), state)
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((4, 3, 8, 8)).astype(np.float32),
                rng.integers(0, 5, (4,)).astype(np.int64)) for _ in range(3)]
    engines, losses = {}, {}
    for (name, M, E), m in zip(BOTH, (port, ref)):
        opt = M.optimizer.Momentum(0.1, momentum=0.9,
                                   parameters=m.parameters())
        engines[name] = E(m, loss=M.nn.CrossEntropyLoss(), optimizer=opt,
                          dp=1)
        losses[name] = [_float(engines[name].train_batch([x], [y]))
                        for x, y in batches]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL)
    pbuf, jbuf = engines["port"].state[2], engines["jax"].state[2]
    assert list(pbuf) == list(jbuf) and len(pbuf) == 4
    for k in jbuf:
        np.testing.assert_allclose(pbuf[k].numpy(), np.asarray(jbuf[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        # the model's own buffers are as they were
        np.testing.assert_array_equal(dict(port.named_buffers())[k].numpy(),
                                      state[k])
    engines["port"].sync_to_model()
    for k, b in port.named_buffers():
        np.testing.assert_array_equal(b.numpy(), pbuf[k].numpy())
    # the synced model in eval() gives predict_batch's outputs
    x = batches[0][0]
    pred = engines["port"].predict_batch([x])
    port.eval()
    np.testing.assert_allclose(port(P.to_tensor(x)).numpy(), pred.numpy(),
                               rtol=RTOL, atol=ATOL)
    port.train()
