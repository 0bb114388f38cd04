"""The port `Engine`'s options against the JAX `Engine` on the CPU (dp=1,
the JAX model's weights carried across, `torch_engine_parity`): the three
grad clips with a need_clip=False parameter, accumulate_steps 2 with and
without averaging, an LR scheduler stepped once a batch, `fit`, amp O1
(bf16, rel 1e-2), eval_batch and predict_batch; remat and
the engine's dropout seed (the port alone: the packages' dropout bits
differ); and what raises on one card (naming A9) or as in the JAX
engine."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.distributed import Engine as TEngine
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.weights import layer_from_numpy
from torch_engine_parity import (BOTH, RTOL, ATOL, _bert_batch,
                                 _bert_models, _float, _mlp, _mlp_batches,
                                 _run_mlp, _state)

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


@pytest.mark.parametrize("clip", ["global_norm", "norm", "value"])
def test_grad_clips_and_need_clip(clip):
    def make(M, m):
        c = {"global_norm": lambda: M.nn.ClipGradByGlobalNorm(0.1),
             "norm": lambda: M.nn.ClipGradByNorm(0.05),
             "value": lambda: M.nn.ClipGradByValue(0.01)}[clip]()
        m[2].bias.need_clip = False
        return M.optimizer.Momentum(0.5, momentum=0.9, use_nesterov=True,
                                    parameters=m.parameters(), grad_clip=c)

    _run_mlp(make)


@pytest.mark.parametrize("avg", [True, False])
def test_accumulate_steps_two(avg):
    def make(M, m):
        return M.optimizer.AdamW(1e-2, parameters=m.parameters())

    _run_mlp(make, dict(accumulate_steps=2, accumulate_avg=avg))


def test_an_lr_scheduler_steps_once_a_batch():
    scheds = {}

    def make(M, m):
        s = M.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        scheds[M.__name__] = s
        return M.optimizer.SGD(s, parameters=m.parameters())

    _run_mlp(make)
    for s in scheds.values():
        assert s.last_epoch == 4 and s() == pytest.approx(0.025)


def test_remat_gives_the_same_steps_with_dropout():
    """remat reruns the forward in backward: the dropout masks are drawn
    again from the same generator state, so the steps are the same."""
    inputs, labels = _bert_batch(seed=4)
    runs = []
    for remat in (False, True):
        P.seed(0)
        m = tbert.bert_tiny(hidden_dropout_prob=0.1)
        eng = TEngine(m, loss=tbert.BertPretrainingLoss(),
                      optimizer=P.optimizer.AdamW(1e-3,
                                                  parameters=m.parameters()),
                      dp=1, seed=5, remat=remat)
        losses = [_float(eng.train_batch(inputs, labels)) for _ in range(3)]
        runs.append((losses, {k: v.numpy() for k, v in
                              eng.state[0].items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        np.testing.assert_array_equal(v, runs[1][1][k], err_msg=k)


def test_dropout_draws_from_the_engines_seed(bert_state):
    inputs, labels = _bert_batch(seed=5)

    def run(seed):
        m = tbert.bert_tiny(hidden_dropout_prob=0.1)
        layer_from_numpy(m, bert_state)
        eng = TEngine(m, loss=tbert.BertPretrainingLoss(),
                      optimizer=P.optimizer.SGD(0.1,
                                                parameters=m.parameters()),
                      dp=1, seed=seed)
        return [_float(eng.train_batch(inputs, labels)) for _ in range(2)]

    assert run(7) == run(7)
    assert run(7) != run(8)


@pytest.mark.parametrize("kw,match", [
    (dict(dp=2), "A9"), (dict(mp=2), "A9"), (dict(mesh=object()), "A9"),
    (dict(devices=["cuda:0", "cuda:1"]), "A9"),
    (dict(mp_spec_fn=lambda name, shape: None), "A9"),
    (dict(strategy=object()), "A9")])
def test_what_needs_more_than_one_card_raises_naming_a9(kw, match):
    m = _mlp(P)
    with pytest.raises(NotImplementedError, match=match):
        TEngine(m, loss=P.nn.CrossEntropyLoss(),
                optimizer=P.optimizer.SGD(parameters=m.parameters()), **kw)


@pytest.mark.parametrize("make,err", [
    (lambda m: P.optimizer.Adam(parameters=m.parameters(),
                                multi_precision=True), NotImplementedError),
    (lambda m: P.optimizer.AdamW(parameters=m.parameters(),
                                 lr_ratio=lambda p: 1.0),
     NotImplementedError),
    (lambda m: P.optimizer.Adagrad(parameters=m.parameters()), TypeError)])
def test_what_the_jax_engine_refuses_raises(make, err):
    m = _mlp(P)
    with pytest.raises(err):
        TEngine(m, loss=P.nn.CrossEntropyLoss(), optimizer=make(m), dp=1)


def test_argument_checks_and_a_ragged_batch():
    m = _mlp(P)
    opt = P.optimizer.SGD(parameters=m.parameters())
    with pytest.raises(ValueError, match="amp_level"):
        TEngine(m, optimizer=opt, amp_level="O3")
    with pytest.raises(ValueError, match="accumulate_steps"):
        TEngine(m, optimizer=opt, accumulate_steps=0)
    eng = TEngine(m, loss=P.nn.CrossEntropyLoss(), optimizer=opt,
                  accumulate_steps=3)
    x, y = _mlp_batches(1)[0]
    with pytest.raises(ValueError, match="must divide"):
        eng.train_batch([x], [y])
    with pytest.raises(RuntimeError, match="without an optimizer"):
        TEngine(m, loss=P.nn.CrossEntropyLoss()).train_batch([x], [y])


def test_fit_over_a_data_loader():
    m = _mlp(P)
    eng = TEngine(m, loss=P.nn.CrossEntropyLoss(),
                  optimizer=P.optimizer.SGD(0.05, parameters=m.parameters()))
    x = np.concatenate([b[0] for b in _mlp_batches()])
    y = np.concatenate([b[1] for b in _mlp_batches()])
    ds = P.io.TensorDataset([P.to_tensor(x), P.to_tensor(y)])
    losses = eng.fit(P.io.DataLoader(ds, batch_size=8), epochs=2)
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_amp_o1_matches_the_jax_engine_to_bf16(bert_state):
    models = _bert_models(bert_state)
    inputs, labels = _bert_batch(seed=6)
    losses = {}
    for name, M, E in BOTH:
        mod = tbert if name == "port" else jbert
        m = models[name]
        eng = E(m, loss=mod.BertPretrainingLoss(),
                optimizer=M.optimizer.AdamW(1e-3, parameters=m.parameters()),
                dp=1, amp_level="O1")
        losses[name] = [_float(eng.train_batch(inputs, labels))
                        for _ in range(3)]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-2)


def test_eval_and_predict_batch_match_the_jax_engine(bert_state):
    models = _bert_models(bert_state, hidden_dropout_prob=0.1)
    inputs, labels = _bert_batch(seed=7)
    res = {}
    for name, M, E in BOTH:
        mod = tbert if name == "port" else jbert
        m = models[name]
        eng = E(m, loss=mod.BertPretrainingLoss(),
                optimizer=M.optimizer.SGD(0.1, parameters=m.parameters()),
                dp=1)
        ev = _float(eng.eval_batch(inputs, labels))
        mlm, nsp = eng.predict_batch(inputs)
        res[name] = (ev, np.asarray(mlm.numpy() if hasattr(mlm, "numpy")
                                    else mlm),
                     np.asarray(nsp.numpy() if hasattr(nsp, "numpy")
                                else nsp))
        assert m.training  # eval and predict restore train()
    for got, want in zip(res["port"], res["jax"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
