"""The port's optimizers, LR schedulers, grad clipping and AMP against the
JAX package's on the CPU.

Every optimizer takes 5 steps from the same parameters and the same
gradients in both packages (the gradient of sum(p * g_t), so each step's
gradient is g_t exactly): the parameters to f32 rtol 1e-6 / atol 1e-6.
Every LR scheduler gives the same sequence; the three `ClipGrad*` classes
and `nn.utils`' clips the same parameters; an optimizer's `state_dict`
written by one package (`.pdopt`) resumes in the other. bf16 moments are
held to `tests/test_optimizer.py`'s statistical bar (stochastic rounding
draws other bits than threefry). AMP: the white and black lists, which ops
`auto_cast` casts, `decorate`, and `GradScaler` in float16 skipping a
step with a planted inf and halving its scale, step for step with the JAX
one."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.nn.layer.layers import Parameter as RefParameter
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.nn.layer.layers import Parameter

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


SHAPES = ((4, 3), (3,), (2, 2, 2))


def _params(M, seed=0):
    rng = np.random.default_rng(seed)
    cls = RefParameter if M is paddle_tpu else Parameter
    ps = [cls(M.to_tensor(rng.uniform(-1, 1, s).astype(np.float32))._data)
          for s in SHAPES]
    for i, p in enumerate(ps):
        p.name = f"p{i}"
    return ps


def _grads(step, seed=1):
    rng = np.random.default_rng(seed + 100 * step)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]


def _backward(M, ps, step):
    loss = None
    for p, g in zip(ps, _grads(step)):
        t = M.sum(p * M.to_tensor(g))
        loss = t if loss is None else loss + t
    loss.backward()


OPTIMIZERS = {
    "SGD": lambda O, ps: O.SGD(0.1, parameters=ps, weight_decay=0.01),
    "Momentum": lambda O, ps: O.Momentum(0.1, 0.9, parameters=ps),
    "Momentum.nesterov": lambda O, ps: O.Momentum(
        0.1, 0.8, parameters=ps, use_nesterov=True, weight_decay=0.02),
    "Adagrad": lambda O, ps: O.Adagrad(0.1, parameters=ps,
                                       initial_accumulator_value=0.1),
    "Adadelta": lambda O, ps: O.Adadelta(1.0, parameters=ps),
    "RMSProp": lambda O, ps: O.RMSProp(0.05, parameters=ps),
    "RMSProp.centered": lambda O, ps: O.RMSProp(
        0.05, momentum=0.5, centered=True, parameters=ps),
    "Adam": lambda O, ps: O.Adam(0.05, parameters=ps, weight_decay=0.01),
    "Adam.multi_precision": lambda O, ps: O.Adam(
        0.05, parameters=ps, multi_precision=True),
    "AdamW": lambda O, ps: O.AdamW(
        0.05, parameters=ps, weight_decay=0.1,
        apply_decay_param_fun=lambda n: n != "p1"),
    "AdamW.lr_ratio": lambda O, ps: O.AdamW(
        O.lr.StepDecay(0.05, 2, 0.5), parameters=ps,
        lr_ratio=lambda p: 0.5 if p.name == "p0" else 1.0),
    "Adamax": lambda O, ps: O.Adamax(0.05, parameters=ps),
    "Lamb": lambda O, ps: O.Lamb(0.05, parameters=ps),
    "Rprop": lambda O, ps: O.Rprop(0.05, parameters=ps),
    "ASGD": lambda O, ps: O.ASGD(0.1, batch_num=2, parameters=ps),
    "NAdam": lambda O, ps: O.NAdam(0.05, parameters=ps),
    "RAdam": lambda O, ps: O.RAdam(0.05, parameters=ps),
}


def _train(M, name, steps=5, clip=None):
    ps = _params(M)
    opt = OPTIMIZERS[name](M.optimizer, ps)
    if clip is not None:
        opt._grad_clip = clip(M.nn)
    for step in range(steps):
        _backward(M, ps, step)
        opt.step()
        opt.clear_grad()
        if not isinstance(opt._learning_rate, float):
            opt._learning_rate.step()
    return [p.numpy() for p in ps], opt


def _close(ref, got, what=""):
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(np.asarray(g, np.float64), r, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {i}")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_five_steps_match_the_jax_package(name):
    ref, _ = _train(paddle_tpu, name)
    got, opt = _train(P, name)
    _close(ref, got, name)
    assert opt._step_count == 5


def test_every_optimizer_class_has_a_case():
    names = {n.split(".")[0] for n in OPTIMIZERS} | {"LBFGS", "Optimizer"}
    ref = {n for n in dir(paddle_tpu.optimizer) if n[0].isupper()}
    assert names == ref == {n for n in dir(P.optimizer) if n[0].isupper()}
    assert len(ref) == 15   # the base class and 14 optimizers


def _quadratic(M, ps):
    a = M.to_tensor(np.array([[3.0, 0.5], [0.5, 1.0]], np.float32))

    def closure():
        x = ps[0]
        loss = M.sum(M.matmul(x, a) * x) + M.sum((x - 1.0) ** 2)
        loss.backward()
        return loss

    return closure


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_step_matches_the_jax_package(line_search):
    out = []
    for M in (paddle_tpu, P):
        cls = RefParameter if M is paddle_tpu else Parameter
        ps = [cls(M.to_tensor(np.array([[0.5, -1.0], [2.0, 0.3]],
                                       np.float32))._data)]
        opt = M.optimizer.LBFGS(learning_rate=0.5, max_iter=6,
                                line_search_fn=line_search, parameters=ps)
        loss = opt.step(_quadratic(M, ps))
        out.append((ps[0].numpy(), float(loss)))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5, atol=1e-6)
    assert abs(out[1][1] - out[0][1]) <= 1e-5 * abs(out[0][1])


SCHEDULERS = {
    "NoamDecay": lambda S: S.NoamDecay(64, 3, 0.5),
    "PiecewiseDecay": lambda S: S.PiecewiseDecay([2, 5], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda S: S.NaturalExpDecay(0.1, 0.3),
    "InverseTimeDecay": lambda S: S.InverseTimeDecay(0.1, 0.5),
    "PolynomialDecay": lambda S: S.PolynomialDecay(0.1, 4, 0.01, 2.0, True),
    "LinearWarmup": lambda S: S.LinearWarmup(S.StepDecay(0.1, 2), 3, 0.0,
                                             0.1),
    "ExponentialDecay": lambda S: S.ExponentialDecay(0.1, 0.8),
    "MultiStepDecay": lambda S: S.MultiStepDecay(0.1, [2, 4, 7], 0.5),
    "StepDecay": lambda S: S.StepDecay(0.1, 3, 0.3),
    "LambdaDecay": lambda S: S.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "ReduceOnPlateau": lambda S: S.ReduceOnPlateau(0.1, patience=1,
                                                   factor=0.5),
    "CosineAnnealingDecay": lambda S: S.CosineAnnealingDecay(0.1, 5, 0.01),
    "CosineAnnealingWarmRestarts": lambda S: S.CosineAnnealingWarmRestarts(
        0.1, 3, 2, 0.001),
    "OneCycleLR": lambda S: S.OneCycleLR(0.1, 10),
    "CyclicLR": lambda S: S.CyclicLR(0.01, 0.1, 3),
}


def _sequence(S, name, n=12):
    s = SCHEDULERS[name](S)
    out = [s()]
    for i in range(n):
        if name == "ReduceOnPlateau":
            s.step([1.0, 0.9, 0.95, 0.97, 0.99][i % 5])
        else:
            s.step()
        out.append(s())
    return out, s.state_dict()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_sequence_matches_the_jax_package(name):
    ref, ref_state = _sequence(paddle_tpu.optimizer.lr, name)
    got, state = _sequence(P.optimizer.lr, name)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert state == ref_state


def test_every_scheduler_has_a_case():
    ref = {n for n in dir(paddle_tpu.optimizer.lr) if n[0].isupper()
           and n != "LRScheduler"}
    assert ref == set(SCHEDULERS) == {
        n for n in dir(P.optimizer.lr) if n[0].isupper()
        and n != "LRScheduler"}
    assert len(ref) == 15


CLIPS = {"ClipGradByGlobalNorm": lambda nn: nn.ClipGradByGlobalNorm(0.5),
         "ClipGradByNorm": lambda nn: nn.ClipGradByNorm(0.4),
         "ClipGradByValue": lambda nn: nn.ClipGradByValue(0.3)}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_grad_clip_matches_the_jax_package(clip):
    ref, _ = _train(paddle_tpu, "SGD", steps=3, clip=CLIPS[clip])
    got, _ = _train(P, "SGD", steps=3, clip=CLIPS[clip])
    _close(ref, got, clip)
    plain, _ = _train(P, "SGD", steps=3)
    assert not np.allclose(plain[0], got[0])   # the clip bit


def test_nn_utils_clips_match_the_jax_package():
    out = []
    for M in (paddle_tpu, P):
        ps = _params(M)
        _backward(M, ps, 0)
        total = M.nn.utils.clip_grad_norm_(ps, 0.7)
        after_norm = [p.grad.numpy() for p in ps]
        M.nn.utils.clip_grad_value_(ps, 0.05)
        vec = M.nn.utils.parameters_to_vector(ps)
        out.append((float(total), after_norm, [p.grad.numpy() for p in ps],
                    vec.numpy()))
    (rt, rn, rv, rvec), (gt, gn, gv, gvec) = out
    assert abs(gt - rt) <= 1e-6 * rt
    _close(rn, gn, "clip_grad_norm_")
    _close(rv, gv, "clip_grad_value_")
    np.testing.assert_array_equal(gvec, rvec)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_state_dict_resumes_across_packages(writer, tmp_path):
    """3 Adam steps (with an LR scheduler) in one package, `.pdparams` and
    `.pdopt` saved, loaded by the other, 2 more steps in each: the same
    parameters as 5 steps in one."""
    first, second = (paddle_tpu, P) if writer == "jax" else (P, paddle_tpu)

    def make(M):
        ps = _params(M)
        opt = M.optimizer.Adam(M.optimizer.lr.StepDecay(0.05, 2, 0.5),
                               parameters=ps)
        return ps, opt

    def steps(M, ps, opt, rng):
        for step in rng:
            _backward(M, ps, step)
            opt.step()
            opt.clear_grad()
            opt._learning_rate.step()

    ps, opt = make(first)
    steps(first, ps, opt, range(3))
    first.save({p.name: p for p in ps}, str(tmp_path / "m.pdparams"))
    first.save(opt.state_dict(), str(tmp_path / "m.pdopt"))
    ps2, opt2 = make(second)
    state = second.load(str(tmp_path / "m.pdparams"))
    for p in ps2:
        p.set_value(state[p.name])
    opt2.set_state_dict(second.load(str(tmp_path / "m.pdopt")))
    assert opt2._step_count == 3 and opt2._learning_rate.last_epoch == 3
    steps(second, ps2, opt2, range(3, 5))
    straight = _params(paddle_tpu)
    sopt = paddle_tpu.optimizer.Adam(
        paddle_tpu.optimizer.lr.StepDecay(0.05, 2, 0.5), parameters=straight)
    steps(paddle_tpu, straight, sopt, range(5))
    _close([p.numpy() for p in straight], [p.numpy() for p in ps2],
           writer)


def _bf16_run(moment_dtype):
    P.seed(7)
    layer = P.nn.Linear(16, 16)
    opt = P.optimizer.AdamW(learning_rate=0.05, parameters=layer.parameters(),
                            moment_dtype=moment_dtype)
    x = P.ones([4, 16])
    losses = []
    for _ in range(20):
        loss = (layer(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, opt


def test_bf16_moments_track_f32_to_the_jax_tests_bar():
    """`tests/test_optimizer.py::test_adamw_bf16_moment_dtype`'s bar, on
    the port: the moments are stored in bf16 and the loss trajectory stays
    within 5% of the f32 one."""
    ref, _ = _bf16_run("float32")
    got, opt = _bf16_run("bfloat16")
    assert all(v.dtype == torch.bfloat16 for k, v in opt._accumulators.items()
               if k[0].startswith("moment"))
    assert got[-1] < ref[0] * 0.5
    assert abs(got[-1] - ref[-1]) <= max(0.05 * abs(ref[-1]), 5e-4), \
        (ref[-1], got[-1])
    again, _ = _bf16_run("bfloat16")
    assert again == got   # the noise is seeded by (step, slot)


# --------------------------------------------------------------------------
# AMP
# --------------------------------------------------------------------------


def test_amp_lists_equal_the_jax_packages():
    assert P.amp.WHITE_LIST == paddle_tpu.amp.WHITE_LIST
    assert P.amp.BLACK_LIST == paddle_tpu.amp.BLACK_LIST
    assert P.amp.amp_state() is None


def _amp_ops(M):
    F = M.nn.functional
    x = M.to_tensor(np.ones((2, 4, 4, 4), np.float32))
    w2 = M.to_tensor(np.ones((3, 4, 3, 3), np.float32))
    a = M.to_tensor(np.ones((2, 8), np.float32))
    b = M.to_tensor(np.ones((8, 8), np.float32))
    q = M.to_tensor(np.ones((1, 4, 2, 64), np.float32))
    return {
        "matmul": lambda: M.matmul(a, b), "mm": lambda: M.mm(a, b),
        "bmm": lambda: M.bmm(M.unsqueeze(a, 0), M.unsqueeze(b, 0)),
        "linear": lambda: F.linear(a, b),
        "einsum": lambda: M.einsum("ij,jk->ik", a, b),
        "conv1d": lambda: F.conv1d(a.reshape([1, 2, 8]),
                                   M.ones([2, 2, 3])),
        "conv2d": lambda: F.conv2d(x, w2),
        "conv3d": lambda: F.conv3d(M.ones([1, 2, 4, 4, 4]),
                                   M.ones([2, 2, 3, 3, 3])),
        "flash_attention": lambda: F.flash_attention(q, q, q)[0],
        "sdpa": lambda: F.scaled_dot_product_attention(q, q, q),
        "softmax": lambda: F.softmax(a), "exp": lambda: M.exp(a),
        "mean": lambda: M.mean(a), "layer_norm": lambda: F.layer_norm(a, 8),
        "add": lambda: a + a,
    }


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "").replace("paddle.", "")


def test_auto_cast_casts_what_the_jax_package_casts():
    names = {}
    for M in (paddle_tpu, P):
        ops = _amp_ops(M)
        with M.amp.auto_cast(dtype="bfloat16"):
            names[M.__name__] = {k: _dtype_name(f()) for k, f in ops.items()}
        assert M.amp.amp_state() is None
        assert _dtype_name(ops["matmul"]()) == "float32"
    assert names["paddle_tpu_torch"] == names["paddle_tpu"]
    got = names["paddle_tpu_torch"]
    assert {k for k, v in got.items() if v == "bfloat16"} == \
        P.amp.WHITE_LIST
    with P.amp.auto_cast(custom_white_list={"exp"}, dtype="float16"):
        assert _dtype_name(_amp_ops(P)["exp"]()) == "float16"
    with P.amp.auto_cast(enable=False):
        assert _dtype_name(_amp_ops(P)["matmul"]()) == "float32"


def test_auto_cast_gradient_reaches_the_float32_leaf():
    w = Parameter(torch.ones(4, 3))
    x = P.ones([2, 4])
    with P.amp.auto_cast():
        y = P.matmul(x, w)
    assert y.dtype == P.bfloat16
    y.astype("float32").sum().backward()
    assert w.grad.dtype == P.float32
    np.testing.assert_array_equal(w.grad.numpy(), np.full((4, 3), 2.0))


def test_decorate_casts_parameters_and_buffers():
    for M in (paddle_tpu, P):
        net = M.nn.Sequential(M.nn.Linear(4, 3), M.nn.BatchNorm1D(3))
        opt = M.optimizer.AdamW(0.01, parameters=net.parameters())
        out = M.amp.decorate(net, opt, level="O2", dtype="bfloat16",
                             master_weight=True)
        assert out[0] is net and out[1] is opt
        assert net._casted_by_pure_fp16
        assert {_dtype_name(t) for t in net.parameters() + net.buffers()} \
            == {"bfloat16"}
        assert M.amp.decorate(net, dtype="bfloat16") is net
    assert not P.nn.Linear(2, 2).bfloat16().weight.stop_gradient


def _scaler_run(M):
    """A float16 linear layer under GradScaler(init 1024): a finite step,
    a step with an inf planted in a gradient, then a finite step."""
    ps = _params(M)
    for p in ps:
        p._data = p._data.astype("float16") if M is paddle_tpu else \
            p._data.detach().half().requires_grad_(True)
    opt = M.optimizer.SGD(0.1, parameters=ps)
    scaler = M.amp.GradScaler(init_loss_scaling=1024.0,
                              incr_every_n_steps=2)
    scales, snaps = [], []
    for step in range(3):
        loss = None
        for p, g in zip(ps, _grads(step)):
            t = M.sum(p.astype("float32") * M.to_tensor(g * 1e-2))
            loss = t if loss is None else loss + t
        scaler.scale(loss).backward()
        if step == 1:
            g = ps[0].grad.numpy().copy()
            g[0, 0] = np.inf
            ps[0].grad = M.to_tensor(g)
        scaler.step(opt)
        opt.clear_grad()
        scales.append(scaler._scale)
        snaps.append([p.numpy().astype(np.float32) for p in ps])
    return scales, snaps


def test_grad_scaler_skips_an_inf_step_and_halves_like_the_jax_one():
    ref_scales, ref = _scaler_run(paddle_tpu)
    scales, got = _scaler_run(P)
    assert scales == ref_scales == [1024.0, 512.0, 512.0]
    for r, g in zip(ref, got):
        _close(r, g, "float16 parameters")
    _close(got[0], got[1], "the skipped step")   # step 1 changed nothing
    assert not np.allclose(got[1][0], got[2][0])
    assert P.amp.is_bfloat16_supported() and P.amp.is_float16_supported()


def test_adamw_decays_the_master_every_step_where_the_jax_package_does_not():
    """AdamW(multi_precision=True) applies its decoupled decay to the f32
    master every step, as Paddle does; the JAX package decays the
    parameter, which the master overwrites, so it decays only at step 1
    (ROADMAP §C)."""
    got = {}
    for M in (paddle_tpu, P):
        cls = RefParameter if M is paddle_tpu else Parameter
        p = cls(M.to_tensor(np.ones(4, np.float32))._data)
        opt = M.optimizer.AdamW(0.1, parameters=[p], weight_decay=0.5,
                                multi_precision=True)
        got[M.__name__] = []
        for _ in range(3):
            (p * 0.0).sum().backward()
            opt.step()
            opt.clear_grad()
            got[M.__name__].append(float(p.numpy()[0]))
    np.testing.assert_allclose(got["paddle_tpu_torch"],
                               [0.95, 0.95 ** 2, 0.95 ** 3], rtol=1e-6)
    np.testing.assert_allclose(got["paddle_tpu"], [0.95] * 3, rtol=1e-6)
