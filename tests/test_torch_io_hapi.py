"""The port's io, metric and hapi against the JAX package's on the CPU.

The behaviours of `tests/test_io_hapi.py` on the port: the loaders and
samplers, the worker processes (order kept, a worker's exception raised in
the parent, `worker_info`, iterable datasets), the synthetic MNIST (the
same arrays as the JAX package's) and the metrics (against the JAX ones).
Then BASELINE config 1: LeNet `Model.fit` on MNIST, 5 steps with
shuffle=False from the JAX LeNet's weights, each step's loss against the
JAX `fit`'s (rel 1e-4); `evaluate` and `predict` against the JAX
package's; a `.pdparams`/`.pdopt` pair written by each package, loaded by
the other, and one more step in both."""

import os

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.io import (BatchSampler, DataLoader, Dataset,
                                 DistributedBatchSampler, IterableDataset)

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


class RangeDataset(Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.float32([i]), np.int64([i % 2])

    def __len__(self):
        return self.n


def test_dataloader_batches_shuffle_and_drop_last():
    batches = list(DataLoader(RangeDataset(10), batch_size=4))
    assert len(batches) == 3 and batches[0][0].shape == [4, 1]
    assert batches[0][0].place.type == "cpu"
    assert isinstance(batches[0][0], P.Tensor)
    assert batches[0][1].dtype == P.int64
    loader = DataLoader(RangeDataset(10), batch_size=4, shuffle=True,
                        drop_last=True)
    got = list(loader)
    assert len(got) == 2 == len(loader)
    seen = sorted(v for b in got for v in b[0].numpy().ravel())
    assert len(set(seen)) == 8


def test_samplers_match_the_jax_package():
    ds = RangeDataset(10)
    ref = paddle_tpu.io
    assert list(BatchSampler(ds, batch_size=3)) == \
        list(ref.BatchSampler(ds, batch_size=3))
    assert len(BatchSampler(ds, batch_size=3, drop_last=True)) == 3
    for rank in range(4):
        for shuffle in (False, True):
            kw = dict(batch_size=2, num_replicas=4, rank=rank,
                      shuffle=shuffle)
            a = DistributedBatchSampler(RangeDataset(16), **kw)
            b = ref.DistributedBatchSampler(RangeDataset(16), **kw)
            a.set_epoch(3)
            b.set_epoch(3)
            assert list(a) == list(b) and len(a) == len(b)
    one = DistributedBatchSampler(RangeDataset(6), batch_size=2)
    assert (one.nranks, one.local_rank) == (1, 0)   # no process group
    assert list(P.io.SequenceSampler(ds)) == list(range(10))
    w = list(P.io.WeightedRandomSampler([0.0, 1.0, 0.0], 5))
    assert w == [1] * 5


def test_datasets_compose_and_split():
    a = P.io.TensorDataset([P.to_tensor(np.arange(6.0).reshape(3, 2)),
                            P.to_tensor(np.arange(3))])
    assert len(a) == 3 and a[1][0].numpy().tolist() == [2.0, 3.0]
    cat = P.io.ConcatDataset([RangeDataset(3), RangeDataset(2)])
    assert len(cat) == 5 and cat[4][0].tolist() == [1.0]
    sub = P.io.Subset(RangeDataset(10), [7, 2])
    assert [int(sub[i][0][0]) for i in range(2)] == [7, 2]
    parts = P.io.random_split(RangeDataset(10), [7, 3])
    assert sorted(len(p) for p in parts) == [3, 7]


def test_mnist_is_the_jax_packages_synthetic_sample():
    from paddle_tpu.vision.datasets import MNIST as RefMNIST

    for mode in ("train", "test"):
        got, ref = P.vision.datasets.MNIST(mode=mode), RefMNIST(mode=mode)
        np.testing.assert_array_equal(got.images, ref.images)
        np.testing.assert_array_equal(got.labels, ref.labels)
        img, label = got[0]
        assert img.shape == (1, 28, 28) and 0 <= int(label[0]) < 10
    assert issubclass(P.vision.datasets.FashionMNIST,
                      P.vision.datasets.MNIST)


class _PidDs(Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.asarray([i], "int64"), np.asarray([os.getpid()], "int64")


class _BoomDs(Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.asarray([i], "float32")


def test_multiprocess_loader_forks_and_preserves_order():
    ids, pids = [], set()
    for x, pid in DataLoader(_PidDs(), batch_size=2, num_workers=4):
        ids.extend(int(v) for v in x.numpy().ravel())
        pids.update(int(v) for v in pid.numpy().ravel())
    assert ids == list(range(16))
    assert os.getpid() not in pids and len(pids) > 1
    assert P.io._default_mp_ctx() == paddle_tpu.io._default_mp_ctx()


def test_multiprocess_loader_propagates_worker_exception():
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(DataLoader(_BoomDs(), batch_size=2, num_workers=2))


def test_worker_init_fn_and_worker_info():
    class Probe(Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            info = P.io.get_worker_info()
            assert info is not None and info.num_workers == 2
            return np.asarray([info.id], "int64")

    inits = []
    out = [int(b.numpy()) for b in DataLoader(
        Probe(), batch_size=1, num_workers=2,
        worker_init_fn=lambda wid: inits.append(wid))]
    assert set(out) <= {0, 1} and len(out) == 4
    assert P.io.get_worker_info() is None


class _Stream(IterableDataset):
    def __iter__(self):
        for i in range(20):
            yield np.asarray([i], "int64")


def test_iterable_datasets_single_and_multiprocess():
    def run(num_workers, drop_last):
        loader = DataLoader(_Stream(), batch_size=3,
                            num_workers=num_workers, drop_last=drop_last)
        return [b.numpy().ravel().tolist() for b in loader]

    assert run(3, False) == run(0, False)
    assert run(3, True) == run(0, True)
    assert len(run(3, True)) == 6
    got = sorted(int(v) for b in DataLoader(_Stream(), batch_size=2,
                                            num_workers=2)
                 for v in b.numpy().ravel())
    assert got == list(range(20))
    with pytest.raises(TypeError):
        len(DataLoader(_Stream(), batch_size=2))


def _metric_runs(M):
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(12, 5)).astype(np.float32)
    label = rng.integers(0, 5, (12, 1)).astype(np.int64)
    prob = rng.uniform(size=(12,)).astype(np.float32)
    binary = rng.integers(0, 2, (12,)).astype(np.int64)
    out = {}
    acc = M.metric.Accuracy(topk=(1, 3))
    for s in (slice(0, 6), slice(6, 12)):
        acc.update(acc.compute(M.to_tensor(pred[s]), M.to_tensor(label[s])))
    out["acc"] = acc.accumulate()
    out["acc_name"] = acc.name()
    for cls in ("Precision", "Recall", "Auc"):
        m = getattr(M.metric, cls)()
        m.update(M.to_tensor(prob), M.to_tensor(binary))
        out[cls] = m.accumulate()
    out["accuracy"] = float(M.metric.accuracy(M.to_tensor(pred),
                                              M.to_tensor(label), k=2))
    return out


def test_metrics_match_the_jax_package():
    ref, got = _metric_runs(paddle_tpu), _metric_runs(P)
    assert got["acc_name"] == ref["acc_name"]
    for k in ("acc", "Precision", "Recall", "Auc", "accuracy"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    m = P.metric.Accuracy()
    m.update(m.compute(P.to_tensor([[0.1, 0.9], [0.8, 0.2]], "bfloat16"),
                       P.to_tensor([[1], [1]], "int64")))
    assert abs(m.accumulate() - 0.5) < 1e-6   # bf16 read as its values


# --------------------------------------------------------------------------
# BASELINE config 1: LeNet on MNIST through Model.fit
# --------------------------------------------------------------------------


def _model(M, state=None, lr=1e-3):
    net = M.vision.models.LeNet()
    if state is not None:
        net.set_state_dict(state)
    model = M.Model(net)
    opt = M.optimizer.Adam(learning_rate=lr, parameters=net.parameters())
    model.prepare(opt, M.nn.CrossEntropyLoss(), M.metric.Accuracy())
    return model


def _recorder(M):
    class Losses(M.hapi.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["batch_loss"])

    return Losses()


@pytest.fixture(scope="module")
def lenet_runs():
    """The JAX LeNet's initial weights, then 5 `fit` steps (batch 64,
    shuffle=False) in each package from them, evaluate and predict on 128
    test samples."""
    prev = port_device._current
    P.set_device("cpu")
    paddle_tpu.seed(42)
    ref = _model(paddle_tpu)
    state = {k: np.asarray(v.numpy())
             for k, v in ref.network.state_dict().items()}
    train = paddle_tpu.vision.datasets.MNIST(mode="train")
    test = paddle_tpu.io.Subset(paddle_tpu.vision.datasets.MNIST(
        mode="test"), list(range(128)))
    runs = {}
    for M in (paddle_tpu, P):
        model = ref if M is paddle_tpu else _model(P, state)
        rec = _recorder(M)
        ds = train if M is paddle_tpu else P.vision.datasets.MNIST(
            mode="train")
        model.fit(ds, batch_size=64, epochs=1, num_iters=5, shuffle=False,
                  verbose=0, callbacks=[rec])
        evald = test if M is paddle_tpu else P.io.Subset(
            P.vision.datasets.MNIST(mode="test"), list(range(128)))
        runs[M.__name__] = dict(
            model=model, losses=rec.losses,
            eval=model.evaluate(evald, batch_size=64, verbose=0),
            pred=model.predict(evald, batch_size=64, stack_outputs=True),
            monitor=model._monitor)
    port_device._current = prev
    return runs


def test_lenet_fit_losses_match_the_jax_fit(lenet_runs):
    ref, got = lenet_runs["paddle_tpu"], lenet_runs["paddle_tpu_torch"]
    assert len(got["losses"]) == len(ref["losses"]) == 5
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    assert got["monitor"].steps == 5
    assert got["monitor"].last["samples_per_sec"] > 0


def test_lenet_evaluate_and_predict_match_the_jax_package(lenet_runs):
    ref, got = lenet_runs["paddle_tpu"], lenet_runs["paddle_tpu_torch"]
    assert set(got["eval"]) == set(ref["eval"]) == {"loss", "acc"}
    np.testing.assert_allclose(got["eval"]["loss"], ref["eval"]["loss"],
                               rtol=1e-4)
    assert abs(got["eval"]["acc"] - ref["eval"]["acc"]) <= 1 / 128
    assert got["pred"][0].shape == (128, 10)
    np.testing.assert_allclose(got["pred"][0], ref["pred"][0], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pdparams_and_pdopt_load_across_packages(lenet_runs, writer,
                                                 tmp_path):
    """`Model.save` in one package; the other loads the `.pdparams` into
    a fresh LeNet (`Model.load`) and the `.pdopt` into a fresh Adam; one
    more `train_batch` in both gives the same loss and weights."""
    names = {"jax": "paddle_tpu", "port": "paddle_tpu_torch"}
    src_mod = paddle_tpu if writer == "jax" else P
    dst_mod = P if writer == "jax" else paddle_tpu
    src = lenet_runs[names[writer]]["model"]
    path = str(tmp_path / "lenet")
    src.save(path)
    dst = _model(dst_mod)
    dst.load(path)
    dst._optimizer.set_state_dict(dst_mod.load(path + ".pdopt"))
    assert dst._optimizer._step_count == 5
    for k, v in src.network.state_dict().items():
        np.testing.assert_array_equal(dst.network.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)
    ds = paddle_tpu.vision.datasets.MNIST(mode="train")
    x = np.stack([ds[i][0] for i in range(64, 96)])
    y = np.stack([ds[i][1] for i in range(64, 96)])
    out = []
    for model, M in ((src, src_mod), (dst, dst_mod)):
        loss = model.train_batch([M.to_tensor(x)], [M.to_tensor(y)])[0][0]
        out.append((float(np.asarray(loss).reshape(-1)[0]),
                    model.network.state_dict()["fc.2.weight"].numpy()))
    assert abs(out[1][0] - out[0][0]) <= 1e-4 * abs(out[0][0])
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-4, atol=1e-6)


def test_model_save_for_inference_waits_for_its_slice(tmp_path):
    """Model.save(training=False) writes the weights through jit.save
    (ported with ROADMAP A10e) in the JAX package's layout: a pickle of
    numpy arrays and a .pdmodel naming the class."""
    import pickle

    model = _model(P)
    model.save(str(tmp_path / "m"), training=False)
    with open(str(tmp_path / "m.pdmodel"), "rb") as f:
        assert pickle.load(f) == {"class": "LeNet"}
    with open(str(tmp_path / "m.pdiparams"), "rb") as f:
        state = pickle.load(f)
    want = model.network.state_dict()
    assert list(state) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k], v.numpy())
    assert P.summary(model.network)["total_params"] == \
        sum(p.size for p in model.network.parameters()) == 61610
    assert P.flops(model.network, [1, 1, 28, 28]) == \
        paddle_tpu.flops(paddle_tpu.vision.models.LeNet(), [1, 1, 28, 28])
