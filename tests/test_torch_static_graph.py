"""The port's static graph (`paddle_tpu_torch/static/`) against the JAX
package's, on the CPU: the 15 cases of `tests/test_static_graph.py`, each
built and run through both packages' `enable_static`, `static.data`,
`Executor.run` and `minimize` on the same numpy feeds and weights (f32,
atol 1e-5 where the values are compared);

  - a stack of two `LlamaDecoderLayer`s and a `LlamaRMSNorm` fed float
    hidden states, MSE loss, `AdamW.minimize`: 3 runs of the port's static
    Program against the JAX package's (losses and parameters, atol 1e-5);
  - a static `LlamaForCausalLM` (ids and labels as feeds, AdamW over a
    StepDecay) against 3 eager AdamW steps of the port on an equal copy
    (losses relative 1e-5, parameters ||d|| / ||ref|| <= 1e-4);
  - `test_ref_departs_llama_records`: the JAX Program cannot record
    `LlamaForCausalLM` (its `F.embedding` closes over the ids Variable,
    reference-side fault, ROADMAP §C); the port's records and runs it.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import device as port_device

torch.set_num_threads(1)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    T.set_device("cpu")
    yield
    port_device._current = prev


class _static:
    """enable_static and a fresh program_guard of package P."""

    def __init__(self, P):
        self.P = P

    def __enter__(self):
        self.P.enable_static()
        self.guard = self.P.static.program_guard(self.P.static.Program(),
                                                 self.P.static.Program())
        self.guard.__enter__()
        return self.P.static

    def __exit__(self, *exc):
        try:
            self.guard.__exit__(*exc)
        finally:
            self.P.disable_static()
        return False


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.float64)
    return np.asarray(x, np.float64)


def _same_params(P, layer, seed):
    rng = np.random.default_rng(seed)
    for p in layer.parameters():
        p.set_value(P.to_tensor(rng.normal(
            0.0, 0.5, size=p.shape).astype(np.float32)))
    return layer


def both(case):
    """Run `case(P)` on the JAX package and on the port inside a static
    program of each; the returned values agree within ATOL."""
    def test():
        with _static(J) as s:
            ref = case(J, s)
        with _static(T) as s:
            got = case(T, s)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_np(g), _np(r), atol=ATOL, rtol=1e-5)
    test.__name__, test.__doc__ = case.__name__, case.__doc__
    return test


# -- build --------------------------------------------------------------------

@both
def test_ops_record_without_executing(P, static):
    x = static.data("x", [3, 4], "float32")
    y = x * 2.0 + 1.0
    prog = static.default_main_program()
    assert len(prog.ops) >= 1
    assert list(y.shape) == [3, 4]
    with pytest.raises(RuntimeError, match="static-graph Variable"):
        y.numpy()  # no value exists at build time
    return [len(prog.ops)]


@both
def test_program_guard_isolation(P, static):
    outer = static.default_main_program()
    x = static.data("x", [2], "float32")
    _ = x + 1.0
    n_outer = len(outer.ops)
    with static.program_guard(static.Program(), static.Program()):
        inner = static.default_main_program()
        assert inner is not outer
        z = static.data("z", [2], "float32")
        _ = z * 3.0
        assert len(inner.ops) >= 1
    assert len(outer.ops) == n_outer
    return [n_outer]


@both
def test_shape_inference_matches_eval_shape(P, static):
    x = static.data("x", [5, 6], "float32")
    y = P.matmul(x, P.ones([6, 7]))
    assert list(y.shape) == [5, 7]
    s = P.sum(y, axis=0)
    assert list(s.shape) == [7]
    return [y.shape, s.shape]


# -- the executor -------------------------------------------------------------

@both
def test_forward_fetch(P, static):
    x = static.data("x", [None, 4], "float32")
    y = (x * 2.0).sum()
    out, = static.Executor().run(feed={"x": np.ones((3, 4), np.float32)},
                                 fetch_list=[y])
    np.testing.assert_allclose(out, 24.0)
    return [out]


@both
def test_dynamic_batch_recompiles(P, static):
    x = static.data("x", [None, 2], "float32")
    y = x.sum()
    exe = static.Executor()
    a, = exe.run(feed={"x": np.ones((2, 2), np.float32)}, fetch_list=[y])
    b, = exe.run(feed={"x": np.ones((5, 2), np.float32)}, fetch_list=[y])
    np.testing.assert_allclose(a, 4.0)
    np.testing.assert_allclose(b, 10.0)
    return [a, b]


@both
def test_multiple_fetches(P, static):
    x = static.data("x", [2, 2], "float32")
    a = x + 1.0
    b = x * 3.0
    ra, rb = static.Executor().run(feed={"x": np.zeros((2, 2), np.float32)},
                                   fetch_list=[a, b])
    np.testing.assert_allclose(ra, np.ones((2, 2)))
    np.testing.assert_allclose(rb, np.zeros((2, 2)))
    return [ra, rb]


@both
def test_layer_params_are_shared_externals(P, static):
    lin = _same_params(P, P.nn.Linear(4, 2), 0)
    x = static.data("x", [3, 4], "float32")
    y = lin(x)
    exe = static.Executor()
    out, = exe.run(feed={"x": np.ones((3, 4), np.float32)}, fetch_list=[y])
    expect = (np.ones((3, 4), np.float32) @ lin.weight.numpy()
              + lin.bias.numpy())
    np.testing.assert_allclose(out, expect, rtol=1e-5)
    lin.weight.set_value(P.to_tensor(np.zeros((4, 2), np.float32)))
    out2, = exe.run(feed={"x": np.ones((3, 4), np.float32)}, fetch_list=[y])
    np.testing.assert_allclose(
        out2, np.broadcast_to(lin.bias.numpy(), (3, 2)), rtol=1e-5)
    return [out, out2]


# -- training -----------------------------------------------------------------

def _build_and_train(P, static, opt_factory, steps=40):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(16, 4)).astype(np.float32)
    ys = xs @ np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    x = static.data("x", [None, 4], "float32")
    label = static.data("label", [None, 1], "float32")
    y = static.nn.fc(x, 1)
    loss = P.mean((y - label) ** 2)
    _same_params(P, _Holder(static.default_main_program()), 1)
    opt_factory().minimize(loss)
    exe = static.Executor()
    exe.run(static.default_startup_program())
    return [float(exe.run(feed={"x": xs, "label": ys},
                          fetch_list=[loss])[0]) for _ in range(steps)]


class _Holder:
    """The trainable externals of a program, as `_same_params` takes
    them."""

    def __init__(self, prog):
        self.prog = prog

    def parameters(self):
        return sorted(self.prog.all_parameters(), key=lambda p: p.shape)


@both
def test_sgd_minimize_converges(P, static):
    losses = _build_and_train(
        P, static, lambda: P.optimizer.SGD(learning_rate=0.1), steps=60)
    assert losses[-1] < losses[0] * 0.05
    return losses


@both
def test_adam_minimize_converges(P, static):
    losses = _build_and_train(
        P, static, lambda: P.optimizer.Adam(learning_rate=0.05))
    assert losses[-1] < losses[0] * 0.2
    return losses


@both
def test_lr_scheduler_not_frozen_into_compiled_step(P, static):
    """Stepping the scheduler between runs changes the applied rate (the
    parameter delta) without a new trace: the rate is an input of the
    step, read at every run."""
    x = static.data("x", [4, 2], "float32")
    y = static.nn.fc(x, 1)
    loss = P.mean(y)
    sched = P.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                     gamma=0.5)
    P.optimizer.SGD(learning_rate=sched).minimize(loss)
    exe = static.Executor()
    exe.run(static.default_startup_program())
    params = static.default_main_program().all_parameters()
    xs = np.ones((4, 2), np.float32)

    def snap():
        return [p.numpy().copy() for p in params]

    before = snap()
    exe.run(feed={"x": xs}, fetch_list=[loss])
    mid = snap()
    sched.step()  # 0.1 -> 0.05
    exe.run(feed={"x": xs}, fetch_list=[loss])
    after = snap()
    ratios = []
    for b, m, a in zip(before, mid, after):
        d1, d2 = m - b, a - m
        assert np.abs(d1).max() > 0
        np.testing.assert_allclose(d2, 0.5 * d1, rtol=1e-5, atol=1e-8)
        ratios.append(float(np.abs(d2).sum() / np.abs(d1).sum()))
    if P is T:
        assert len(static.default_main_program()._run_cache) == 1
    return sorted(ratios)


@both
def test_param_updates_visible_in_eager(P, static):
    lin = _same_params(P, P.nn.Linear(2, 1), 2)
    w_before = lin.weight.numpy().copy()
    x = static.data("x", [4, 2], "float32")
    loss = P.mean(lin(x) ** 2)
    P.optimizer.SGD(learning_rate=0.5).minimize(loss)
    exe = static.Executor()
    exe.run(feed={"x": np.ones((4, 2), np.float32)}, fetch_list=[loss])
    w_after = lin.weight.numpy()
    assert not np.allclose(w_before, w_after)  # the scope write-back
    return [w_after]


@both
def test_static_matches_eager_sgd_step(P, static):
    xs = np.ones((4, 3), np.float32)
    ys = np.full((4, 1), 2.0, np.float32)
    w0 = np.arange(3, dtype=np.float32).reshape(3, 1) * 0.1
    lin = P.nn.Linear(3, 1)
    lin.weight.set_value(P.to_tensor(w0))
    lin.bias.set_value(P.to_tensor(np.zeros(1, np.float32)))
    x = static.data("x", [4, 3], "float32")
    label = static.data("label", [4, 1], "float32")
    loss = P.mean((lin(x) - label) ** 2)
    P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    st_loss, = static.Executor().run(feed={"x": xs, "label": ys},
                                     fetch_list=[loss])
    st_w = lin.weight.numpy()
    pred = xs @ w0
    grad_w = xs.T @ (2.0 * (pred - ys) / 4.0)
    np.testing.assert_allclose(st_loss, np.mean((pred - ys) ** 2), rtol=1e-5)
    np.testing.assert_allclose(st_w, w0 - 0.1 * grad_w, rtol=1e-4)
    return [st_loss, st_w]


# -- gradients and static.nn --------------------------------------------------

# the optimizer options the functional step implements, each built with
# package P over `params` (None inside a static Program: all of its own)
STEP_OPTIONS = {
    "sgd_l2": lambda P, ps: P.optimizer.SGD(
        learning_rate=0.1, parameters=ps, weight_decay=0.1),
    "momentum_l2": lambda P, ps: P.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=ps, weight_decay=0.1),
    "momentum_nesterov": lambda P, ps: P.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=ps, use_nesterov=True),
    "adam_l2": lambda P, ps: P.optimizer.Adam(
        learning_rate=0.05, parameters=ps, weight_decay=0.1),
    "adamw_decay_none": lambda P, ps: P.optimizer.AdamW(
        learning_rate=0.05, parameters=ps, weight_decay=None),
}


def _option_linear(P):
    lin = P.nn.Linear(3, 1)
    lin.weight.set_value(P.to_tensor(
        np.arange(3, dtype=np.float32).reshape(3, 1) * 0.1 - 0.1))
    lin.bias.set_value(P.to_tensor(np.full(1, 0.2, np.float32)))
    return lin


@pytest.mark.parametrize("option", sorted(STEP_OPTIONS))
def test_static_step_matches_eager_optimizer_option(option):
    """3 static runs of a Linear's MSE under an optimizer option equal 3
    eager steps of the port's optimizer and of the JAX package's on the
    same weights: L2 decay, Nesterov, and AdamW's weight_decay=None
    (which decays by 0) train as they do eagerly."""
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4, 3)).astype(np.float32)
    ys = rng.normal(size=(4, 1)).astype(np.float32)
    make = STEP_OPTIONS[option]

    def eager(P):
        lin = _option_linear(P)
        opt = make(P, lin.parameters())
        losses = []
        for _ in range(3):
            loss = P.mean((lin(P.to_tensor(xs)) - P.to_tensor(ys)) ** 2)
            losses.append(float(loss.numpy()))
            loss.backward()
            opt.step()
            opt.clear_grad()
        return losses, [lin.weight.numpy(), lin.bias.numpy()]

    with _static(T) as static:
        lin = _option_linear(T)
        x = static.data("x", [4, 3], "float32")
        label = static.data("label", [4, 1], "float32")
        loss = T.mean((lin(x) - label) ** 2)
        make(T, None).minimize(loss)
        exe = static.Executor()
        losses = [float(exe.run(feed={"x": xs, "label": ys},
                                fetch_list=[loss])[0]) for _ in range(3)]
        got = (losses, [lin.weight.numpy(), lin.bias.numpy()])
    for ref in (eager(T), eager(J)):
        np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=1e-5)
        for g, r in zip(got[1], ref[1]):
            np.testing.assert_allclose(_np(g), _np(r), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("option", [
    "grad_clip", "apply_decay_param_fun", "lr_ratio", "moment_dtype"])
def test_static_minimize_refuses_options_it_lacks(option):
    """An optimizer option the functional step does not implement makes
    `minimize` raise, naming it, instead of training otherwise than the
    eager optimizer does."""
    kwargs = {
        "grad_clip": dict(grad_clip=T.nn.ClipGradByGlobalNorm(1.0)),
        "apply_decay_param_fun": dict(apply_decay_param_fun=lambda n: True),
        "lr_ratio": dict(lr_ratio=lambda p: 1.0),
        "moment_dtype": dict(moment_dtype="bfloat16"),
    }[option]
    with _static(T) as static:
        lin = _option_linear(T)
        x = static.data("x", [4, 3], "float32")
        loss = T.mean(lin(x) ** 2)
        with pytest.raises(NotImplementedError, match=option):
            T.optimizer.AdamW(learning_rate=0.05, **kwargs).minimize(loss)
        assert static.default_main_program().opt is None


@both
def test_static_gradients_variable(P, static):
    x = static.data("x", [3], "float32")
    y = (x * x).sum()
    (gx,) = static.gradients([y], [x])
    arr = np.array([1.0, 2.0, 3.0], np.float32)
    out, = static.Executor().run(feed={"x": arr}, fetch_list=[gx])
    np.testing.assert_allclose(out, 2.0 * arr, rtol=1e-6)
    return [out]


@both
def test_conv_bn_dropout_stack(P, static):
    img = static.data("img", [2, 3, 8, 8], "float32")
    h = static.nn.conv2d(img, num_filters=4, filter_size=3, padding=1,
                         act="relu")
    h = static.nn.batch_norm(h, is_test=True)
    h = static.nn.dropout(h, dropout_prob=0.5, is_test=True)
    out = static.nn.fc(h, 10)
    _same_params(P, _Holder(static.default_main_program()), 3)
    r, = static.Executor().run(feed={"img": np.ones((2, 3, 8, 8),
                                                    np.float32)},
                               fetch_list=[out])
    assert r.shape == (2, 10)
    assert np.isfinite(r).all()
    return [r.shape]


@both
def test_layer_norm_prelu(P, static):
    x = static.data("x", [4, 6], "float32")
    h = static.nn.layer_norm(x)
    h = static.nn.prelu(h)
    r, = static.Executor().run(feed={"x": np.random.default_rng(0).normal(
        size=(4, 6)).astype(np.float32)}, fetch_list=[h])
    assert r.shape == (4, 6)
    return [r]


# -- the Llama layers -----------------------------------------------------------

CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)


def _decoder_stack(P):
    """Two LlamaDecoderLayers and a LlamaRMSNorm with the same numpy
    weights in both packages."""
    llama = __import__(f"{P.__name__}.models.llama", fromlist=["llama"])
    cfg = llama.LlamaConfig(**CFG)
    layers = [llama.LlamaDecoderLayer(cfg) for _ in range(2)]
    norm = llama.LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
    params = [p for lyr in layers + [norm] for p in lyr.parameters()]
    rng = np.random.default_rng(5)
    for p in params:
        p.set_value(P.to_tensor(rng.normal(
            0.0, 0.05, size=p.shape).astype(np.float32) + (
                1.0 if len(p.shape) == 1 else 0.0)))
    return layers, norm, params


def _stack_run(P):
    rng = np.random.default_rng(6)
    feeds = [(rng.normal(size=(2, 16, 64)).astype(np.float32),
              rng.normal(size=(2, 16, 64)).astype(np.float32))
             for _ in range(3)]
    with _static(P) as static:
        layers, norm, params = _decoder_stack(P)
        h = static.data("h", [2, 16, 64], "float32")
        tgt = static.data("tgt", [2, 16, 64], "float32")
        out = h
        for lyr in layers:
            out = lyr(out)
        loss = P.mean((norm(out) - tgt) ** 2)
        # lr 1e-3: Adam turns the rounding noise of a near-zero gradient
        # into up to lr a step, which the atol must hold
        P.optimizer.AdamW(learning_rate=1e-3,
                          parameters=params).minimize(loss)
        exe = static.Executor()
        losses = [float(exe.run(feed={"h": a, "tgt": b},
                                fetch_list=[loss])[0]) for a, b in feeds]
    return losses, [p.numpy() for p in params]


def test_decoder_stack_adamw_against_the_jax_program():
    """3 AdamW runs of the two-decoder stack: the port's static Program
    against the JAX package's (losses and parameters, atol 1e-5)."""
    ref_l, ref_p = _stack_run(J)
    got_l, got_p = _stack_run(T)
    assert ref_l[2] < ref_l[0]
    np.testing.assert_allclose(got_l, ref_l, atol=ATOL, rtol=0)
    for g, r in zip(got_p, ref_p):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


# head_dim 64: attention takes B1-B3's operators (their plain versions on
# the CPU), as at 7B width
KERNEL_CFG = dict(CFG, hidden_size=128, num_attention_heads=2,
                  num_key_value_heads=1)


def _tiny_llama(seed=0):
    from paddle_tpu_torch.models import llama

    T.seed(seed)
    return llama.LlamaForCausalLM(llama.LlamaConfig(**KERNEL_CFG))


def test_static_llama_matches_eager_adamw():
    """A static LlamaForCausalLM trained 3 runs (AdamW over a StepDecay,
    the scheduler stepped between runs) against 3 eager AdamW steps of an
    equal copy: the losses within 1e-5 relative and every parameter
    within ||d|| / ||ref|| <= 1e-4, the Adam-family bar of the port's
    Engine tests: an element whose gradient is below Adam's eps (5e-9
    here) moves by lr * g / (|g| + eps), which turns rounding noise of
    1e-9 in g into 1e-4 of lr. The traced step holds B1-B3's and B9/B10's
    operators once a call site."""
    m, m2 = _tiny_llama(), _tiny_llama(1)
    m2.set_state_dict(m.state_dict())
    rng = np.random.default_rng(7)
    batches = [(rng.integers(0, 64, (1, 16)), rng.integers(0, 64, (1, 16)))
               for _ in range(3)]
    with _static(T) as static:
        ids = static.data("ids", [1, 16], "int64")
        lab = static.data("labels", [1, 16], "int64")
        loss = m(ids, labels=lab)
        sched = T.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                         gamma=0.5)
        T.optimizer.AdamW(learning_rate=sched,
                          parameters=m.parameters()).minimize(loss)
        exe = static.Executor()
        got = []
        for a, b in batches:
            got.append(float(exe.run(feed={"ids": a, "labels": b},
                                     fetch_list=[loss])[0]))
            sched.step()
        prog = static.default_main_program()
        (entry,) = prog._run_cache.values()
        targets = [str(n.target) for n in entry["fn"].graph.nodes
                   if n.op == "call_function"]
    for op in ("flash_fwd", "flash_bwd", "rms_norm", "rms_norm_bwd"):
        assert targets.count(f"paddle_tpu_torch.{op}.default") == (
            2 if op.startswith("flash") else 5), op
    sched2 = T.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=1,
                                      gamma=0.5)
    opt = T.optimizer.AdamW(learning_rate=sched2, parameters=m2.parameters())
    ref = []
    for a, b in batches:
        loss = m2(T.to_tensor(a), labels=T.to_tensor(b))
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched2.step()
        ref.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    sd, sd2 = m.state_dict(), m2.state_dict()
    for k in sd:
        d = np.linalg.norm(sd[k].numpy() - sd2[k].numpy())
        assert d <= 1e-4 * np.linalg.norm(sd2[k].numpy()), k


def test_ref_departs_llama_records():
    """The JAX static Program cannot record LlamaForCausalLM: its
    F.embedding closes over the ids Variable and hands the recorder an
    aval (reference-side fault, ROADMAP §C). The port's records it and a
    run gives the eager loss."""
    from paddle_tpu.models import llama as jllama

    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig(**CFG))
    with _static(J) as static:
        ids = static.data("ids", [1, 16], "int64")
        with pytest.raises(Exception):
            jm(ids)
    m = _tiny_llama()
    a = np.random.default_rng(8).integers(0, 64, (1, 16))
    with _static(T) as static:
        ids = static.data("ids", [1, 16], "int64")
        lab = static.data("labels", [1, 16], "int64")
        loss = m(ids, labels=lab)
        got, = static.Executor().run(feed={"ids": a, "labels": a},
                                     fetch_list=[loss])
    with T.no_grad():
        ref = m(T.to_tensor(a), labels=T.to_tensor(a))
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-6)
