"""The check the vision zoo test files share (`test_torch_vision_models_*`):
one constructor of `vision.models` built in the JAX package from a seed,
its state dict loaded into the port's model of the same constructor (names,
shapes and order equal), both in eval() on the same input: the logits and
every parameter's gradient of sum(logits * w). Eval, because dropout masks
cannot match across the packages, and because a training-mode batch norm
chain multiplies f32 rounding by ~1.4 a block (MobileNetV1 ends 1e-4 apart
at 64x64), past any f32 bar; the batch norm's training path is held by
the layer tests and by `test_torch_engine.py`. The JAX side runs once, compiled: `paddle_tpu.jit
.functionalize` under `jax.jit(jax.value_and_grad(...))`, as the JAX
`Engine` runs a layer (op-by-op eager dispatch of a whole zoo model would
take minutes). The logits are held elementwise within 1e-5 of the largest
logit (+ 1e-6), each gradient by ||port - jax|| <= 1e-5 *
max(||jax||, 1e-3 * the largest gradient norm): a parameter whose true
gradient is zero (a key bias) carries only rounding noise on both
sides."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu
import paddle_tpu.nn.initializer as jinit
import paddle_tpu_torch as P
from paddle_tpu import jit as pjit
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch.models.weights import layer_from_numpy
from paddle_tpu_torch.vision import models as tmodels

RTOL, ATOL, GRAD_BAR = 1e-5, 1e-6, 1e-5


class _NumpyRandom:
    """The three `jax.random` draws of the JAX package's initializers, from
    a seeded numpy generator: eager `jax.random` compiles once a parameter
    shape, 16 s of ResNet-18's construction, and the weights are carried
    across anyway."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def _out(self, a, dtype):
        return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)

    def normal(self, key, shape, dtype=jnp.float32):
        return self._out(self._rng.standard_normal(shape), dtype)

    def uniform(self, key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        return self._out(self._rng.uniform(minval, maxval, shape), dtype)

    def truncated_normal(self, key, lower, upper, shape, dtype=jnp.float32):
        return self._out(np.clip(self._rng.standard_normal(shape), lower,
                                 upper), dtype)


@contextlib.contextmanager
def numpy_initializers(seed=0):
    """The JAX package's initializers draw from `_NumpyRandom` inside."""
    saved = jinit.jax
    jinit.jax = types.SimpleNamespace(random=_NumpyRandom(seed))
    try:
        yield
    finally:
        jinit.jax = saved


def _outputs(out):
    """The model's outputs (GoogLeNet's aux heads are None in eval())."""
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o for o in outs if o is not None]


def check(name, shape, dtype="float32", **kw):
    """`vision.models.<name>(**kw)` of both packages on an input of
    `shape` (NCHW) from a seed, in `dtype` (float64: the f32 weights cast,
    JAX's x64 switched on for the call)."""
    with (jax.enable_x64(True) if dtype == "float64"
          else contextlib.nullcontext()):
        return _check(name, shape, dtype, kw)


def _check(name, shape, dtype, kw):
    paddle_tpu.seed(0)
    with numpy_initializers():
        ref = getattr(jmodels, name)(**kw).eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    port = layer_from_numpy(getattr(tmodels, name)(**kw), state).eval()
    if dtype != "float32":
        ref.astype(dtype)
        port.astype(dtype)
    assert [(k, list(v.shape)) for k, v in port.state_dict().items()] == \
        [(k, list(v.shape)) for k, v in ref.state_dict().items()]
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    x = np.random.default_rng(1).standard_normal(shape).astype(dtype)

    # the port: eager, autograd
    outs = _outputs(port(P.to_tensor(x)))
    ws = [np.random.default_rng(2 + i).standard_normal(
        tuple(o.shape)).astype(dtype) for i, o in enumerate(outs)]
    total = sum((o * P.to_tensor(w)).sum() for o, w in zip(outs, ws))
    total.backward()
    got = [o.numpy() for o in outs]
    # a head unused in eval() (GoogLeNet's aux) has no gradient: JAX's zeros
    got_grads = {n: np.zeros(p.shape, dtype) if p.grad is None
                 else p.grad.numpy() for n, p in port.named_parameters()}

    # the JAX package: functionalized, one compiled value_and_grad
    pure_fn, params, buffers = pjit.functionalize(ref)

    def loss(params):
        out, _ = pure_fn(params, buffers, jax.random.key(0), jnp.asarray(x))
        out = _outputs(out)
        return sum(jnp.sum(o * w) for o, w in zip(out, ws)), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= RTOL * np.abs(w).max() + ATOL
    floor = 1e-3 * max(np.linalg.norm(np.asarray(g)) for g in grads.values())
    worst = max((np.linalg.norm(got_grads[n] - np.asarray(g)) / max(
        np.linalg.norm(np.asarray(g)), floor), n) for n, g in grads.items())
    assert worst[0] <= GRAD_BAR, worst
    return port
