"""What the `vision.ops` test files share (`test_torch_vision_ops.py`,
`test_torch_vision_detection.py`): one function of both packages on the
same numpy inputs, and the comparison (indices and counts exactly, floats
to f32 rtol 1e-5 / atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.vision import ops as tops

RTOL, ATOL = 1e-5, 1e-6


def _boxes(rng, n, size=32.0):
    xy = rng.uniform(0, size * 0.6, (n, 2))
    wh = rng.uniform(size / 16, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same(got, want, exact=False):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, exact)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if exact or not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _call(name, *args, **kw):
    """(port result, JAX result) of one function on the same numpy args
    (each array wrapped as the package's Tensor)."""
    out = []
    for M, mod in ((P, tops), (paddle_tpu, jops)):
        a = [M.to_tensor(v) if isinstance(v, np.ndarray) else v
             for v in args]
        k = {n: M.to_tensor(v) if isinstance(v, np.ndarray) else v
             for n, v in kw.items()}
        out.append(getattr(mod, name)(*a, **k))
    return out


def _with_grads(name, arrays, kw, argnums):
    """(outputs, gradients) of both packages, each a [port, JAX] pair: the
    gradients of sum(out * w) with respect to arrays[argnums]. The JAX side
    runs under one `jax.jit` of `jax.value_and_grad`, the other arrays
    constants of the trace (its eager dispatch would dominate the file's
    time)."""
    ts = [P.to_tensor(a, stop_gradient=(i not in argnums))
          for i, a in enumerate(arrays)]
    out = getattr(tops, name)(*ts, **kw)
    w = np.random.default_rng(9).standard_normal(
        tuple(out.shape)).astype(np.float32)
    (out * P.to_tensor(w)).sum().backward()
    got = [ts[i].grad.numpy() for i in argnums]
    consts = [JTensor(jnp.asarray(a)) for a in arrays]

    def loss(*diff):
        args = list(consts)
        for i, a in zip(argnums, diff):
            args[i] = JTensor(a)
        res = getattr(jops, name)(*args, **kw)._data
        return jnp.sum(res * w), res

    (_, ref), want = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(argnums))), has_aux=True))(
            *[arrays[i] for i in argnums])
    return [out, np.asarray(ref)], [got, [np.asarray(g) for g in want]]
