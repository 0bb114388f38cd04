"""The port's SOT (`paddle_tpu_torch/jit/sot.py`) against the JAX
package's, on the CPU: the 27 cases of `tests/test_sot.py`, each function
translated by both packages' `symbolic_translate` and run on the same numpy
inputs (f32, atol 1e-6), with the same capture, hit, guard-restart and
fallback counts and the same bytecode diagnoses. The port replays a
segment through `apply` as one function over torch tensors, so torch's
autograd differentiates it; the gradients are held too.

`test_ref_departs_stale_ids`: the JAX SOT bakes the first call's token ids
into the embedding op (its `F.embedding` closes over the ids instead of
passing them to the dispatch waist), so a second call on other ids replays
stale ones. The port passes the ids to `apply`, and its replay equals the
eager layer on the new ids.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import device as port_device

torch.set_num_threads(1)

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    T.set_device("cpu")
    yield
    port_device._current = prev


def t(P, x, sg=True):
    out = P.to_tensor(np.asarray(x, dtype=np.float32))
    out.stop_gradient = sg
    return out


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.float64)
    return np.asarray(x, np.float64)


def _linear(P, i, o, seed=0):
    rng = np.random.default_rng(seed)
    lin = P.nn.Linear(i, o)
    lin.weight.set_value(P.to_tensor(
        rng.normal(size=(i, o)).astype(np.float32)))
    lin.bias.set_value(P.to_tensor(rng.normal(size=(o,)).astype(np.float32)))
    return lin


def both(case):
    """Run `case(P)` on the JAX package and on the port; the returned
    values agree within ATOL."""
    def test():
        ref = case(J)
        got = case(T)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), _np(r), atol=ATOL, rtol=0)
    test.__name__, test.__doc__ = case.__name__, case.__doc__
    return test


def _st(P):
    return P.jit.sot.symbolic_translate


# -- capture and replay -------------------------------------------------------

@both
def test_simple_parity_and_hit(P):
    def f(x, y):
        return (x * y + 2.0).sum()

    sf = _st(P)(f)
    x, y = t(P, [1.0, 2.0, 3.0]), t(P, [4.0, 5.0, 6.0])
    first = sf(x, y)
    second = sf(x, y)
    expect = f(x, y)
    np.testing.assert_allclose(first.numpy(), expect.numpy(), rtol=1e-6)
    np.testing.assert_allclose(second.numpy(), expect.numpy(), rtol=1e-6)
    assert sf.stats["captures"] == 1
    assert sf.stats["hits"] == 1
    return [first, second]


@both
def test_python_control_flow_break_continue(P):
    def f(xs):
        acc = xs * 0.0
        for i in range(10):
            if i == 7:
                break
            if i % 2 == 1:
                continue
            acc = acc + xs * float(i)
        return acc

    sf = _st(P)(f)
    x = t(P, [1.0, 2.0])
    a, b = sf(x), sf(x)
    np.testing.assert_allclose(a.numpy(), f(x).numpy())
    np.testing.assert_allclose(b.numpy(), f(x).numpy())
    assert sf.stats["hits"] == 1
    return [a, b]


@both
def test_shape_change_recaptures(P):
    def f(x):
        return x.sum()

    sf = _st(P)(f)
    a = sf(t(P, [1.0, 2.0]))
    b = sf(t(P, [1.0, 2.0, 3.0]))
    assert sf.stats["captures"] == 2
    c = sf(t(P, [1.0, 2.0]))
    assert sf.stats["hits"] == 1
    return [a, b, c]


@both
def test_multi_output_and_pytree_result(P):
    def f(x):
        s = x.sum()
        return {"sum": s, "double": x * 2.0, "const": 7}

    sf = _st(P)(f)
    x = t(P, [1.0, 2.0])
    sf(x)
    out = sf(x)
    assert out["const"] == 7
    np.testing.assert_allclose(out["sum"].numpy(), 3.0)
    np.testing.assert_allclose(out["double"].numpy(), [2.0, 4.0])
    return [out["sum"], out["double"], sf.stats["hits"]]


# -- guards -------------------------------------------------------------------

@both
def test_tensor_branch_both_arms(P):
    def f(x):
        if (x.sum() > 0.0):  # Tensor.__bool__ -> guard
            return x * 2.0
        return x - 1.0

    sf = _st(P)(f)
    pos, neg = t(P, [1.0, 2.0]), t(P, [-1.0, -2.0])
    a, b = sf(pos), sf(neg)
    assert sf.stats["captures"] == 2
    assert sf.stats["guard_restarts"] >= 1
    c, d = sf(pos), sf(neg)
    np.testing.assert_allclose(c.numpy(), [2.0, 4.0])
    np.testing.assert_allclose(d.numpy(), [-2.0, -3.0])
    assert sf.stats["captures"] == 2
    assert sf.stats["hits"] == 2
    return [a, b, c, d, sf.stats["guard_restarts"]]


@both
def test_item_guard(P):
    def f(x):
        scale = float(x.max())  # a materialized scalar: equality guard
        return x * scale

    sf = _st(P)(f)
    x = t(P, [1.0, 2.0])
    sf(x)
    out = sf(x)
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])
    assert sf.stats["hits"] == 1
    y = sf(t(P, [1.0, 3.0]))  # same key, another max: recapture
    np.testing.assert_allclose(y.numpy(), [3.0, 9.0])
    assert sf.stats["captures"] == 2
    return [out, y]


@both
def test_guard_after_ops_mid_function(P):
    calls = []

    def f(x):
        h = x * 3.0
        if h.sum() > 10.0:
            calls.append("big")
            return h + 1.0
        return h - 1.0

    sf = _st(P)(f)
    outs = [sf(t(P, v)) for v in ([1.0, 1.0], [9.0, 9.0], [1.0, 1.0],
                                  [9.0, 9.0])]
    np.testing.assert_allclose(outs[2].numpy(), [2.0, 2.0])
    np.testing.assert_allclose(outs[3].numpy(), [28.0, 28.0])
    assert sf.stats["captures"] == 2
    return outs


# -- externals and layers -----------------------------------------------------

@both
def test_layer_param_update_flows_into_replay(P):
    lin = _linear(P, 3, 2)
    sf = _st(P)(lin)
    x = t(P, np.ones((4, 3)))
    first = sf(x)
    hit = sf(x)
    np.testing.assert_allclose(first.numpy(), hit.numpy(), rtol=1e-6)
    assert sf.stats["hits"] == 1
    lin.weight.set_value(P.to_tensor(np.ones((3, 2), dtype=np.float32)))
    lin.bias.set_value(P.to_tensor(np.zeros((2,), dtype=np.float32)))
    out = sf(x)
    np.testing.assert_allclose(out.numpy(), np.full((4, 2), 3.0), rtol=1e-6)
    assert sf.stats["captures"] == 1
    return [first, out]


@both
def test_closure_tensor_is_external(P):
    w = t(P, [10.0, 20.0])

    def f(x):
        return x + w

    sf = _st(P)(f)
    sf(t(P, [1.0, 1.0]))
    w.set_value(P.to_tensor(np.array([100.0, 200.0], dtype=np.float32)))
    out = sf(t(P, [1.0, 1.0]))
    np.testing.assert_allclose(out.numpy(), [101.0, 201.0])
    assert sf.stats["captures"] == 1
    return [out]


# -- autograd -----------------------------------------------------------------

@both
def test_grads_through_replay(P):
    lin = _linear(P, 3, 1)

    def loss_fn(x):
        return lin(x).sum()

    sf = _st(P)(loss_fn)
    x = t(P, np.ones((2, 3)))
    sf(x)
    loss = sf(x)  # replay: the grads flow through the segment
    loss.backward()
    np.testing.assert_allclose(lin.weight.grad.numpy(), np.full((3, 1), 2.0),
                               rtol=1e-6)
    return [loss, lin.weight.grad, lin.bias.grad]


@both
def test_no_grad_region_respected_on_replay(P):
    w = t(P, [2.0], sg=False)

    def f(x):
        with P.no_grad():
            frozen = x * w  # must not add w grads on replay
        live = x * w
        return (frozen + live).sum()

    sf = _st(P)(f)
    x = t(P, [3.0])
    sf(x)
    loss = sf(x)
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(), [3.0], rtol=1e-6)
    return [loss, w.grad]


@both
def test_detach_blocks_grad_on_replay(P):
    w = t(P, [2.0], sg=False)

    def f(x):
        return (x * w).detach().sum() + (x * w).sum()

    sf = _st(P)(f)
    x = t(P, [3.0])
    sf(x)
    loss = sf(x)
    loss.backward()
    np.testing.assert_allclose(w.grad.numpy(), [3.0], rtol=1e-6)
    return [loss, w.grad]


# -- fallbacks ----------------------------------------------------------------

def test_dropout_captures_with_fresh_masks():
    """Dropout draws inside its op's function (the port) or through the
    waist's key tensor (JAX): a replay redraws, so masks are fresh each
    call, and each output is 0 or 2x / (1 - p)."""
    def run(P):
        def f(x):
            h = x * 2.0
            return P.nn.functional.dropout(h, p=0.5, training=True)

        sf = _st(P)(f)
        x = t(P, np.ones((100,)))
        a, b, c = sf(x), sf(x), sf(x)
        assert sf.stats["captures"] == 1 and sf.stats["hits"] == 2
        assert not np.allclose(a.numpy(), b.numpy())
        assert not np.allclose(b.numpy(), c.numpy())
        assert set(np.round(np.unique(b.numpy()), 3)).issubset({0.0, 4.0})
        return dict(sf.stats, fallbacks=None)

    assert run(T) == run(J)


def test_raw_closure_rng_falls_back():
    """An op closing over a draw made outside the waist breaks capture:
    the JAX package's `next_key()` into a closure, the port's framework
    generator drawn in Python."""
    from paddle_tpu.core.tensor import apply as japply
    from paddle_tpu.framework import random as jrng
    from paddle_tpu_torch.core.tensor import apply as tapply
    from paddle_tpu_torch.framework import random as trng

    def jf(x):
        key = jrng.next_key()
        return japply(lambda a: a + jax.random.uniform(key, a.shape), x,
                      _name="custom_rng")

    def tf(x):
        noise = torch.rand(x.shape, generator=trng.generator(x.place))
        return tapply(lambda a: a + noise, x, _name="custom_rng")

    for P, f in ((J, jf), (T, tf)):
        sf = _st(P)(f)
        x = t(P, np.zeros((4,)))
        a, b = sf(x), sf(x)
        assert any("RNG" in r for r in sf.report()["uncapturable"])
        assert sf.stats["eager_calls"] >= 1
        assert not np.allclose(a.numpy(), b.numpy())  # not replayed stale


@both
def test_eval_mode_dropout_captures(P):
    def f(x):
        return P.nn.functional.dropout(x, p=0.5, training=False)

    sf = _st(P)(f)
    x = t(P, np.ones((8,)))
    a, b = sf(x), sf(x)
    assert sf.stats["captures"] + sf.stats["hits"] >= 1
    return [a, b]


@both
def test_inplace_mutation_falls_back(P):
    def f(x):
        h = x * 2.0
        h.scale_(3.0)  # an in-place change of a traced tensor
        return h

    sf = _st(P)(f)
    x = t(P, [1.0])
    a, b = sf(x), sf(x)
    np.testing.assert_allclose(a.numpy(), [6.0])
    np.testing.assert_allclose(b.numpy(), [6.0])
    assert any("mutation" in r or "non-waist" in r
               for r in sf.report()["uncapturable"])
    return [a, b, sf.stats["eager_calls"]]


@both
def test_numpy_read_falls_back(P):
    def f(x):
        h = x + 1.0
        arr = h.numpy()  # a materialization no guard can follow
        return h * float(arr.sum())

    sf = _st(P)(f)
    x = t(P, [1.0, 2.0])
    a, b = sf(x), sf(x)
    np.testing.assert_allclose(a.numpy(), [10.0, 15.0])
    np.testing.assert_allclose(b.numpy(), [10.0, 15.0])
    assert sf.report()["uncapturable"]
    return [a, b]


@both
def test_host_scalar_logging_is_fine(P):
    logged = []

    def f(x):
        logged.append(len(logged))
        return x * 2.0

    sf = _st(P)(f)
    x = t(P, [1.0])
    a, b = sf(x), sf(x)
    assert sf.stats["hits"] == 1
    assert logged == [0]  # side effects happen at capture only
    return [a, b]


# -- integration --------------------------------------------------------------

@both
def test_to_static_full_graph_false(P):
    @P.jit.to_static(full_graph=False)
    def f(x):
        return x * 2.0 + 1.0

    x = t(P, [1.0, 2.0])
    a, b = f(x), f(x)
    np.testing.assert_allclose(b.numpy(), [3.0, 5.0])
    assert f.stats["hits"] == 1
    return [a, b]


@both
def test_sot_report_registry(P):
    sf = _st(P)(lambda x: x + 1.0)
    sf(t(P, [1.0]))
    reps = P.jit.sot_report()
    assert any(r["captures"] >= 1 for r in reps)
    return [sf.report()["captures"]]


@both
def test_small_mlp_training_loop(P):
    """The translated forward inside an SGD loop: the losses equal an
    untranslated twin's step for step, and the two packages' agree (the
    same numpy weights)."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(16, 4)).astype(np.float32)
    ys = rng.normal(size=(16, 1)).astype(np.float32)

    def build():
        m = P.nn.Sequential(_linear(P, 4, 8, 1), P.nn.Tanh(),
                            _linear(P, 8, 1, 2))
        opt = P.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
        return m, opt

    def run(m, opt, fwd):
        losses = []
        for _ in range(4):
            pred = fwd(P.to_tensor(xs))
            loss = ((pred - P.to_tensor(ys)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.numpy()))
        return losses

    m1, o1 = build()
    ref = run(m1, o1, m1)
    m2, o2 = build()
    sf = _st(P)(m2)
    got = run(m2, o2, sf)
    np.testing.assert_allclose(ref, got, rtol=1e-5)
    assert sf.stats["hits"] >= 2
    return got


# -- the bytecode scan --------------------------------------------------------

def _diag(P, fn):
    d = _st(P)(fn).diagnose()
    return {k: [m for _, m in v] for k, v in d.items()}


def test_diagnose_flags_branch_and_guard():
    def f(x):
        s = float(x.max())        # value guard
        if x.sum() > 0:           # branch -> bool guard
            return x * s
        return x

    got, ref = _diag(T, f), _diag(J, f)
    assert any("value guard" in m for m in got["guards"])
    assert got["branches"]
    assert got == ref


def test_diagnose_flags_breaks():
    def f(x):
        h = x * 2.0
        h.scale_(3.0)             # mutation break
        _ = h.numpy()             # materialization break
        return h

    got, ref = _diag(T, f), _diag(J, f)
    assert any("mutation" in m for m in got["breaks"])
    assert any("materialization" in m for m in got["breaks"])
    assert got == ref


def test_diagnose_clean_function():
    f = lambda x: (x * 2.0 + 1.0).sum()  # noqa: E731
    got = _diag(T, f)
    assert not got["breaks"] and not got["branches"]
    assert got == _diag(J, f)


@both
def test_diagnosis_matches_runtime_outcome(P):
    def f(x):
        h = x + 1.0
        h.scale_(2.0)
        return h

    sf = _st(P)(f)
    assert sf.diagnose()["breaks"]
    a, b = sf(t(P, [1.0])), sf(t(P, [1.0]))
    assert sf.report()["uncapturable"]  # the predicted break happened
    return [a, b]


def test_diagnose_sees_nested_code_objects():
    def f(x):
        g = lambda: x.numpy()                       # noqa: E731
        total = sum(v.item() for v in [x])
        return g(), total

    got = _diag(T, f)
    assert any("materialization" in m for m in got["breaks"])
    assert any("value guard" in m for m in got["guards"])
    assert got == _diag(J, f)


def test_diagnose_scans_layer_forward():
    def run(P):
        class Bad(P.nn.Layer):
            def forward(self, x):
                h = x * 2.0
                h.scale_(3.0)
                return h

        return {k: [m for _, m in v]
                for k, v in _st(P)(Bad()).diagnose().items()}

    got = run(T)
    assert any("mutation" in m for m in got["breaks"])
    assert got == run(J)


# -- the port against the JAX package's stale-ids fault -----------------------

def _tiny_llamas():
    from paddle_tpu.models import llama as jllama
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.models.weights import layer_from_numpy

    cfg = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2)
    J.seed(0)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**cfg))
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig(**cfg))
    layer_from_numpy(tm, {k: np.asarray(v._data)
                          for k, v in jm.state_dict().items()})
    return jm, tm


def test_ref_departs_stale_ids():
    """The JAX SOT replays the first call's ids (reference-side fault, ROADMAP
    §C); the port's replay on new ids equals its eager layer."""
    jm, tm = _tiny_llamas()
    rng = np.random.default_rng(3)
    a = rng.integers(0, 64, (2, 16)).astype(np.int64)
    b = rng.integers(0, 64, (2, 16)).astype(np.int64)
    jm.eval()
    tm.eval()
    jsot = J.jit.to_static(jm, full_graph=False)
    jsot(J.to_tensor(a))
    j_b = jsot(J.to_tensor(b)).numpy()
    assert np.abs(j_b - jm(J.to_tensor(b)).numpy()).max() > 1.0  # stale
    tsot = T.jit.to_static(tm, full_graph=False)
    tsot(T.to_tensor(a))
    t_b = tsot(T.to_tensor(b))
    assert tsot.stats["hits"] == 1
    np.testing.assert_allclose(t_b.numpy(), tm(T.to_tensor(b)).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(t_b.numpy(), jm(J.to_tensor(b)).numpy(),
                               atol=1e-5, rtol=0)
