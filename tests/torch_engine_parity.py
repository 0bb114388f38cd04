"""What the `Engine` test files share (`test_torch_engine*.py`): the
models, batches and optimizers both packages build, and the parameter
comparison."""

import numpy as np

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.distributed.engine import Engine as JEngine
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.distributed import Engine as TEngine
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models.weights import layer_from_numpy

RTOL, ATOL = 1e-5, 1e-6
STEPS = 5
BOTH = (("port", P, TEngine), ("jax", paddle_tpu, JEngine))

# Adam divides each step by the gradient's running RMS, so a gradient
# known only to f32 rounding carries that rounding into the update at full
# size: the attention's q/k gradients at init (near-uniform softmax, its
# backward a difference of near-equal terms) differ by ~3e-5 between the
# packages. The Adam family's parameters are held per parameter by
# ||port - jax|| / ||jax|| <= ADAM_BAR; the others elementwise.
ADAM_BAR = 1e-4


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _bert_batch(seed=0, b=4, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (b, s)).astype(np.int64)
    tt = rng.integers(0, 2, (b, s)).astype(np.int64)
    mlm = np.where(rng.random((b, s)) < 0.3, ids, -100).astype(np.int64)
    nsp = rng.integers(0, 2, (b,)).astype(np.int64)
    return [ids, tt], [mlm, nsp]


def _bert_models(state, **kw):
    out = {}
    for name, M, _ in BOTH:
        mod = tbert if name == "port" else jbert
        out[name] = mod.bert_tiny(**kw)
    layer_from_numpy(out["port"], state)
    out["jax"].set_state_dict(state)
    return out


def _optimizer(M, kind, model):
    ps = model.parameters()
    if kind == "adamw":
        no_decay = {p.name for n, p in model.named_parameters()
                    if n.endswith("bias") or "norm" in n}
        return M.optimizer.AdamW(
            1e-3, parameters=ps, weight_decay=0.05,
            apply_decay_param_fun=lambda name: name not in no_decay)
    if kind == "adam":
        return M.optimizer.Adam(1e-3, parameters=ps, weight_decay=0.01)
    if kind == "momentum":
        return M.optimizer.Momentum(0.05, momentum=0.9, use_nesterov=True,
                                    parameters=ps, weight_decay=1e-3)
    return M.optimizer.SGD(0.1, parameters=ps, weight_decay=1e-3)


def _float(x):
    return float(np.asarray(x.numpy() if hasattr(x, "numpy") else x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def adam_reach(steps, beta1=0.9, beta2=0.999):
    """How far `steps` Adam updates can move a parameter, in units of lr,
    whatever its gradients: update t is |m_t| / sqrt(v_t) (both bias-
    corrected) <= sqrt(sum_i a_i^2 / b_i) by Cauchy-Schwarz, a_i and b_i
    the weights m_t and v_t give gradient i (1 at t = 1, 5.0225 summed
    over 5 steps)."""
    reach = 0.0
    for t in range(1, steps + 1):
        a = [beta1 ** (t - i) * (1 - beta1) / (1 - beta1 ** t)
             for i in range(1, t + 1)]
        b = [beta2 ** (t - i) * (1 - beta2) / (1 - beta2 ** t)
             for i in range(1, t + 1)]
        reach += np.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return reach


def _params_match(port, ref, lr=None, start=None):
    """Every parameter of the two models equal (see ADAM_BAR for Adam's
    `lr`). With Adam a parameter whose true gradient is zero (a key bias:
    the softmax ignores a constant added to every logit of a row) carries
    each side's rounding noise, scaled by Adam to up to lr a step: it is
    held finite, and on each side within Adam's reach of its value in
    `start`, the state both began from."""
    for (n, p), (m, r) in zip(port.named_parameters(),
                              ref.named_parameters()):
        assert n == m
        if lr is None:
            np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=n)
        elif n.endswith("k_proj.bias"):
            bar = lr * adam_reach(STEPS) * (1 + RTOL)
            for side in (p.numpy(), r.numpy()):
                moved = np.abs(np.asarray(side, np.float64) - start[n])
                assert np.isfinite(side).all() and moved.max() <= bar, n
        else:
            assert _rel(p.numpy(), r.numpy()) <= ADAM_BAR, n


def _cnn(M):
    nn = M.nn
    return nn.Sequential(
        nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4), nn.ReLU(),
        nn.Conv2D(4, 6, 3, stride=2, padding=1), nn.BatchNorm2D(6),
        nn.ReLU(), nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(6, 5))


def _mlp(M, seed=13):
    M.seed(seed)
    nn = M.nn
    return nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))


def _mlp_pair():
    ref = _mlp(paddle_tpu)
    state = _state(ref)
    return layer_from_numpy(_mlp(P), state), ref


def _mlp_batches(n=4, b=8, seed=12):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 8)).astype(np.float32) * 5.0,
             rng.integers(0, 4, (b,)).astype(np.int64)) for _ in range(n)]


def _run_mlp(make_opt, engine_kw=None, batches=None):
    port, ref = _mlp_pair()
    batches = batches or _mlp_batches()
    losses = {}
    for (name, M, E), m in zip(BOTH, (port, ref)):
        eng = E(m, loss=M.nn.CrossEntropyLoss(), optimizer=make_opt(M, m),
                dp=1, **(engine_kw or {}))
        losses[name] = [_float(eng.train_batch([x], [y]))
                        for x, y in batches]
        eng.sync_to_model()
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=RTOL,
                               atol=ATOL)
    _params_match(port, ref)
    return losses["port"], port
