"""The port's nn layers against the JAX package's, one parametrised case per
layer class of `paddle_tpu.nn` (`torch_layer_cases`): the JAX layer is
built from a seed, its state dict carried into the port's layer as numpy
(`models.weights.layer_from_numpy`), and the same numpy inputs go through
both on the CPU: the outputs, the input gradients, every parameter's
gradient and the buffers after the call (BatchNorm's running statistics)
to f32 rtol 1e-5 / atol 1e-6. The state dicts' names, shapes and order,
and the parameters' order, equal the JAX layer's (`torch_layer_parity`).

This file holds the activations, the common layers, the containers and
the base class; the other groups of the table run in
`test_torch_nn_conv_norm.py`, `test_torch_nn_pool_loss.py`,
`test_torch_nn_loss_rnn.py` and `test_torch_nn_transformer.py`, so that
xdist spreads them. The random layers' training forms are held to seed
reproducibility and to their statistics, their inference forms to the JAX
package. Also: each initializer's distribution, and the behaviours of
`tests/test_nn_layers.py` (hooks, containers, BatchNorm train/eval, the
state-dict round trip)."""

import inspect
import math

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as P
import torch_layer_cases as L
from paddle_tpu.nn.layer.layers import Layer as RefLayer
from paddle_tpu_torch.framework import device as port_device
from torch_layer_parity import check_random, check_value
import torch

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


def test_every_layer_class_has_a_case():
    ref = {n for n in dir(paddle_tpu.nn) if inspect.isclass(
        getattr(paddle_tpu.nn, n)) and issubclass(getattr(paddle_tpu.nn, n),
                                                  RefLayer)}
    assert len(ref) == 139
    assert set(L.by_name()) == ref and len(L.CASES) == 139
    assert sum(len(L.group(g)) for g in L.GROUPS) == 139
    assert ref <= set(dir(P.nn))


CASES = L.group("common")


@pytest.mark.parametrize("c", [c for c in CASES if c.check == "value"],
                         ids=lambda c: c.id)
def test_layer_matches_the_jax_package(c):
    check_value(c)


@pytest.mark.parametrize("c", [c for c in CASES if c.check == "random"],
                         ids=lambda c: c.id)
def test_random_layer_seed_statistics_and_inference_form(c):
    check_random(c)


# --------------------------------------------------------------------------
# initializers: the port's draws against the distribution the JAX package's
# draw from (bits differ: torch's generators are not threefry)
# --------------------------------------------------------------------------

I = P.nn.initializer
N = (256, 512)   # fans 256 / 512 for a 2-D weight


def _draw(init, shape=N):
    return init(list(shape), "float32").numpy().astype(np.float64)


def _moments(x, mean, std):
    n = x.size
    assert abs(x.mean() - mean) <= 6 * std / math.sqrt(n), (x.mean(), mean)
    assert abs(x.std() / std - 1) < 0.02, (x.std(), std)


@pytest.mark.parametrize("name,init,mean,std", [
    ("Normal", lambda: I.Normal(0.5, 2.0), 0.5, 2.0),
    ("XavierNormal", lambda: I.XavierNormal(), 0.0, math.sqrt(2 / 768)),
    ("XavierNormal.fans", lambda: I.XavierNormal(fan_in=10, fan_out=30,
                                                 gain=2.0),
     0.0, 2.0 * math.sqrt(2 / 40)),
    ("KaimingNormal", lambda: I.KaimingNormal(), 0.0, math.sqrt(2 / 256)),
    ("KaimingNormal.leaky", lambda: I.KaimingNormal(
        negative_slope=0.5, nonlinearity="leaky_relu"), 0.0,
     math.sqrt(2 / 1.25) / math.sqrt(256)),
])
def test_normal_initializers_draw_their_distribution(name, init, mean, std):
    _moments(_draw(init()), mean, std)


@pytest.mark.parametrize("name,init,limit", [
    ("Uniform", lambda: I.Uniform(-0.3, 0.3), 0.3),
    ("XavierUniform", lambda: I.XavierUniform(), math.sqrt(6 / 768)),
    ("KaimingUniform", lambda: I.KaimingUniform(), math.sqrt(2)
     * math.sqrt(3 / 256)),
    ("KaimingUniform.conv", lambda: I.KaimingUniform(), None),
])
def test_uniform_initializers_keep_their_bounds(name, init, limit):
    shape = N
    if limit is None:   # a conv weight: fan_in = in_channels * receptive
        shape = (64, 16, 3, 3)
        limit = math.sqrt(2) * math.sqrt(3 / (16 * 9))
    x = _draw(init(), shape)
    assert x.min() >= -limit and x.max() <= limit
    assert x.min() < -0.98 * limit and x.max() > 0.98 * limit
    _moments(x, 0.0, limit / math.sqrt(3))


def test_fans_and_gains_equal_the_jax_packages():
    ref = paddle_tpu.nn.initializer
    for shape in ([5], [3, 7], [4, 2, 3, 3], [6, 2, 5]):
        assert I.Initializer()._compute_fans(shape) == \
            ref.Initializer()._compute_fans(shape)
    for nl, prm in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                    ("leaky_relu", None), ("selu", None), ("linear", None)):
        assert I.calculate_gain(nl, prm) == ref.calculate_gain(nl, prm)


def test_truncated_normal_stays_in_its_bounds():
    x = _draw(I.TruncatedNormal(1.0, 2.0, a=-1.0, b=2.0))
    assert x.min() >= -1.0 and x.max() <= 2.0
    # the mean of N(1, 2) truncated to [-1, 2]: mu + sigma * (phi(a') -
    # phi(b')) / (Phi(b') - Phi(a')), a' = -1, b' = 0.5
    phi = lambda z: math.exp(-z * z / 2) / math.sqrt(2 * math.pi)  # noqa
    Phi = lambda z: 0.5 * (1 + math.erf(z / math.sqrt(2)))  # noqa
    mean = 1.0 + 2.0 * (phi(-1) - phi(0.5)) / (Phi(0.5) - Phi(-1))
    assert abs(x.mean() - mean) < 0.01


def test_orthogonal_dirac_assign_constant_bilinear_by_value():
    for shape in ((6, 4), (4, 6), (3, 2, 2)):
        q = _draw(I.Orthogonal(gain=2.0), shape).reshape(shape[0], -1)
        small = q @ q.T if shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(small, 4.0 * np.eye(len(small)),
                                   atol=1e-5)
    ref = paddle_tpu.nn.initializer
    for make, shape in ((lambda m: m.Dirac(groups=2), [4, 2, 3, 3]),
                        (lambda m: m.Constant(0.25), [3, 4]),
                        (lambda m: m.Bilinear(), [2, 2, 4, 4]),
                        (lambda m: m.Assign(np.arange(6.0).reshape(2, 3)),
                         [3, 2])):
        np.testing.assert_array_equal(
            make(I)(shape, "float32").numpy(),
            np.asarray(make(ref)(shape, "float32")))
    assert I.Constant(1.0)([2], "bfloat16").dtype == P.bfloat16


def test_parameters_are_drawn_from_the_framework_generator():
    P.seed(3)
    a = P.nn.Linear(4, 5).weight.numpy()
    P.seed(3)
    np.testing.assert_array_equal(P.nn.Linear(4, 5).weight.numpy(), a)
    assert not np.array_equal(P.nn.Linear(4, 5).weight.numpy(), a)


# --------------------------------------------------------------------------
# behaviours of tests/test_nn_layers.py
# --------------------------------------------------------------------------


def test_hooks_run_and_remove():
    lin = P.nn.Linear(3, 2)
    seen = []
    pre = lin.register_forward_pre_hook(lambda l, ins: seen.append("pre"))
    post = lin.register_forward_post_hook(
        lambda l, ins, out: out * 2.0)
    x = P.ones([1, 3])
    y = lin(x)
    np.testing.assert_allclose(y.numpy(), 2.0 * (x.numpy() @ lin.weight.numpy()
                                                 + lin.bias.numpy()),
                               rtol=1e-6)
    assert seen == ["pre"]
    pre.remove()
    post.remove()
    lin(x)
    assert seen == ["pre"]


def test_containers_index_slice_and_mutate():
    seq = P.nn.Sequential(P.nn.Linear(2, 3), P.nn.ReLU(), P.nn.Linear(3, 1))
    assert len(seq) == 3 and isinstance(seq[1], P.nn.ReLU)
    assert len(seq[:2]) == 2
    assert len(seq.parameters()) == 4
    ll = P.nn.LayerList([P.nn.Linear(2, 2) for _ in range(3)])
    ll.append(P.nn.Linear(2, 2))
    ll.insert(0, P.nn.Linear(2, 2))
    del ll[1]
    assert len(ll) == 4 and [n for n, _ in ll.named_children()] == \
        ["0", "1", "2", "3"]
    d = P.nn.LayerDict({"a": P.nn.ReLU()})
    d["b"] = P.nn.Tanh()
    assert list(d.keys()) == ["a", "b"] and "b" in d
    d.pop("a")
    assert len(d) == 1
    pl = P.nn.ParameterList([P.nn.Layer().create_parameter([2])])
    pl.append(P.nn.Layer().create_parameter([3]))
    assert [p.shape for p in pl] == [[2], [3]]


def test_batch_norm_train_updates_running_stats_and_eval_uses_them():
    bn = P.nn.BatchNorm1D(3, momentum=0.9)
    ref = paddle_tpu.nn.BatchNorm1D(3, momentum=0.9)
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    for layer, M in ((bn, P), (ref, paddle_tpu)):
        layer(M.to_tensor(x))
    for name in ("_mean", "_variance"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn._mean.numpy(), 0.1 * x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(bn._variance.numpy(),
                               0.9 + 0.1 * x.var(0, ddof=1), rtol=1e-5)
    bn.eval()
    ref.eval()
    before = bn._mean.numpy().copy()
    y = bn(P.to_tensor(x)).numpy()
    np.testing.assert_array_equal(bn._mean.numpy(), before)
    np.testing.assert_allclose(y, ref(paddle_tpu.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_state_dict_round_trip_and_errors(tmp_path):
    net = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.BatchNorm1D(3))
    path = str(tmp_path / "net.pdparams")
    P.save(net.state_dict(), path)
    other = P.nn.Sequential(P.nn.Linear(4, 3), P.nn.BatchNorm1D(3))
    missing, unexpected = other.set_state_dict(P.load(path))
    assert missing == [] and unexpected == []
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              other.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    with pytest.raises(ValueError, match="shape mismatch"):
        other.set_state_dict({"0.weight": np.zeros((3, 4), np.float32)})
    bad = dict(net.state_dict())
    bad.pop("0.bias")
    bad["extra"] = np.zeros(1, np.float32)
    assert other.set_state_dict(bad) == (["0.bias"], ["extra"])


def test_cast_and_move_keep_parameters_trainable_leaves():
    lin = P.nn.Linear(4, 3)
    opt = P.optimizer.SGD(0.1, parameters=lin.parameters())
    lin.to(dtype="bfloat16")
    assert lin.weight.dtype == P.bfloat16 and not lin.weight.stop_gradient
    assert lin.weight._data.is_leaf
    lin.float()
    w0 = lin.weight.numpy().copy()
    lin(P.ones([2, 4])).sum().backward()
    opt.step()   # reads the cast parameter afresh
    assert lin.weight.dtype == P.float32
    np.testing.assert_allclose(lin.weight.numpy(),
                               w0 - 0.1 * lin.weight.grad.numpy(), rtol=1e-6)
    lin.to(device="cpu")
    assert lin.weight.place.type == "cpu" and lin.weight._data.is_leaf
