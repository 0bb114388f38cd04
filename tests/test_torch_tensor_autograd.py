"""The port's eager Tensor and its autograd (`paddle_tpu_torch.core`,
`paddle_tpu_torch.autograd`) on the CPU.

  - the 22 behaviours of `tests/test_tensor_autograd.py`, against the port;
  - the JAX package's reference-side faults the port does not copy
    (in-place arithmetic and `__setitem__` on a tensor with history drop
    the op from backward there), held to the chain rule by finite
    differences, not to the JAX package;
  - every op whose gradient the JAX package drops (`fd_grad` in
    `torch_op_cases`), held to finite differences in float64;
  - Paddle's dtypes where the JAX package narrows (int64, float64, the raw
    bits of bf16), the grad API (paddle.grad, hooks, create_graph,
    PyLayer, jacobian, hessian) against the JAX package's, the RNG state,
    set_device and in-place updates of parameters under no_grad.
"""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as paddle
import torch_op_cases as T
from paddle_tpu_torch.framework import device as port_device


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    paddle.set_device("cpu")
    yield
    port_device._current = prev


# --------------------------------------------------------------------------
# the 22 behaviours of tests/test_tensor_autograd.py
# --------------------------------------------------------------------------


def test_to_tensor_and_numpy():
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert x.shape == [2, 2]
    np.testing.assert_allclose(x.numpy(), [[1, 2], [3, 4]])
    assert x.dtype == paddle.float32


def test_basic_arith():
    x = paddle.to_tensor([1.0, 2.0, 3.0])
    y = paddle.to_tensor([4.0, 5.0, 6.0])
    np.testing.assert_allclose((x + y).numpy(), [5, 7, 9])
    np.testing.assert_allclose((x * y).numpy(), [4, 10, 18])
    np.testing.assert_allclose((y - x).numpy(), [3, 3, 3])
    np.testing.assert_allclose((y / x).numpy(), [4, 2.5, 2])
    np.testing.assert_allclose((x ** 2).numpy(), [1, 4, 9])
    np.testing.assert_allclose((2.0 * x).numpy(), [2, 4, 6])


def test_backward_simple():
    x = paddle.to_tensor([2.0, 3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 6.0])


def test_backward_chain():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = paddle.to_tensor([3.0, 4.0], stop_gradient=False)
    z = (x * y + x.exp()).mean()
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               (np.array([3, 4]) + np.exp([1, 2])) / 2,
                               rtol=1e-6)
    np.testing.assert_allclose(y.grad.numpy(), np.array([1, 2]) / 2)


def test_backward_shared_input():
    x = paddle.to_tensor(2.0, stop_gradient=False)
    y = x * x * x  # dy/dx = 3x^2 = 12
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), 12.0)


def test_grad_accumulation():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])


def test_no_grad():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient


def test_paddle_grad_api():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x ** 3).sum()
    (gx,) = paddle.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), 3 * np.array([1.0, 4.0]))
    assert x.grad is None  # paddle.grad must not pollute .grad


def test_matmul_grad():
    a = paddle.to_tensor(np.random.rand(3, 4).astype("float32"),
                         stop_gradient=False)
    b = paddle.to_tensor(np.random.rand(4, 5).astype("float32"),
                         stop_gradient=False)
    out = paddle.matmul(a, b).sum()
    out.backward()
    np.testing.assert_allclose(a.grad.numpy(), np.ones((3, 5)) @ b.numpy().T,
                               rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), a.numpy().T @ np.ones((3, 5)),
                               rtol=1e-5)


def test_indexing_and_grad():
    x = paddle.to_tensor(np.arange(12, dtype="float32").reshape(3, 4),
                         stop_gradient=False)
    y = x[1].sum()
    y.backward()
    expected = np.zeros((3, 4))
    expected[1] = 1
    np.testing.assert_allclose(x.grad.numpy(), expected)


def test_setitem():
    x = paddle.to_tensor(np.zeros((3, 3), "float32"))
    x[1, 1] = 5.0
    assert x.numpy()[1, 1] == 5.0


def test_reshape_transpose_concat():
    x = paddle.arange(6, dtype="float32").reshape([2, 3])
    t = paddle.transpose(x, [1, 0])
    assert t.shape == [3, 2]
    c = paddle.concat([x, x], axis=0)
    assert c.shape == [4, 3]
    s = paddle.stack([x, x], axis=0)
    assert s.shape == [2, 2, 3]
    parts = paddle.split(c, 2, axis=0)
    assert len(parts) == 2 and parts[0].shape == [2, 3]


def test_reductions():
    x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert float(x.sum()) == 10.0
    assert float(x.mean()) == 2.5
    np.testing.assert_allclose(x.max(axis=0).numpy(), [3, 4])
    np.testing.assert_allclose(x.sum(axis=1, keepdim=True).numpy(),
                               [[3], [7]])


def test_comparison_and_where():
    x = paddle.to_tensor([1.0, 5.0, 3.0])
    y = paddle.to_tensor([4.0, 2.0, 3.0])
    mask = x > y
    np.testing.assert_array_equal(mask.numpy(), [False, True, False])
    out = paddle.where(mask, x, y)
    np.testing.assert_allclose(out.numpy(), [4, 5, 3])


def test_gather_scatter():
    x = paddle.to_tensor(np.arange(10, dtype="float32"))
    idx = paddle.to_tensor([1, 3, 5])
    np.testing.assert_allclose(paddle.gather(x, idx).numpy(), [1, 3, 5])


def test_topk_argmax_sort():
    x = paddle.to_tensor([3.0, 1.0, 4.0, 1.0, 5.0])
    vals, idx = paddle.topk(x, 2)
    np.testing.assert_allclose(vals.numpy(), [5, 4])
    np.testing.assert_array_equal(idx.numpy(), [4, 2])
    assert int(paddle.argmax(x)) == 4
    np.testing.assert_allclose(paddle.sort(x).numpy(), [1, 1, 3, 4, 5])


def test_einsum():
    a = paddle.to_tensor(np.random.rand(2, 3).astype("float32"),
                         stop_gradient=False)
    b = paddle.to_tensor(np.random.rand(3, 4).astype("float32"))
    out = paddle.einsum("ij,jk->ik", a, b)
    np.testing.assert_allclose(out.numpy(), a.numpy() @ b.numpy(), rtol=1e-5)
    out.sum().backward()
    assert a.grad is not None


def test_cast_astype():
    x = paddle.to_tensor([1.5, 2.5])
    assert x.astype("int32").dtype == paddle.int32
    assert x.astype(paddle.bfloat16).dtype == paddle.bfloat16


def test_retain_graph():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = x * 2
    y.backward(retain_graph=True)
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0])


def test_tensor_hook():
    x = paddle.to_tensor([1.0], stop_gradient=False)
    x.register_hook(lambda g: g * 2)
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0])


def test_clip_and_clip_():
    x = paddle.to_tensor([-2.0, 0.5, 3.0])
    np.testing.assert_allclose(paddle.clip(x, -1, 1).numpy(), [-1, 0.5, 1])


def test_inplace_ops():
    x = paddle.to_tensor([1.0, 2.0])
    x.add_(paddle.to_tensor([1.0, 1.0]))
    np.testing.assert_allclose(x.numpy(), [2, 3])
    x.scale_(2.0)
    np.testing.assert_allclose(x.numpy(), [4, 6])


# --------------------------------------------------------------------------
# the reference-side faults the port does not copy: held to the chain rule
# by finite differences
# --------------------------------------------------------------------------


def _fd_grad(f, x0, eps=1e-6):
    """Central finite differences of the scalar f(numpy float64 array)."""
    g = np.zeros_like(x0)
    for i in np.ndindex(x0.shape):
        hi, lo = x0.copy(), x0.copy()
        hi[i] += eps
        lo[i] -= eps
        g[i] = (f(hi) - f(lo)) / (2 * eps)
    return g


def _loss_and_grad(f, x0):
    """(the port's autograd gradient of f at x0, f's finite-difference
    gradient), in float64."""
    x = paddle.to_tensor(x0, stop_gradient=False)
    f(x).backward()

    def value(a):
        with paddle.no_grad():
            return float(f(paddle.to_tensor(a)))

    return x.grad.numpy(), _fd_grad(value, x0)


X0 = np.array([0.5, -1.25, 2.0])
W0 = np.array([1.5, -0.5, 0.25])


@pytest.mark.parametrize("op", ["scale_", "multiply_", "add_", "subtract_",
                                "clip_", "exp_", "pow_"])
def test_inplace_arithmetic_keeps_the_chain_rule(op):
    """In the JAX package, `y = x * 1.0; y.scale_(3.0)` gives x.grad 1 where
    the chain rule gives 3: the in-place op rebinds y's data and keeps y's
    old grad node. The port's y records the op."""
    w = paddle.to_tensor(W0)

    def f(x):
        y = x * 1.5
        {"scale_": lambda: y.scale_(3.0, 0.5),
         "multiply_": lambda: y.multiply_(w),
         "add_": lambda: y.add_(x * x),
         "subtract_": lambda: y.subtract_(x * w),
         "clip_": lambda: y.clip_(-1.0, 1.0),
         "exp_": lambda: y.exp_(),
         "pow_": lambda: y.pow_(3.0)}[op]()
        return (y * y).sum()

    got, fd = _loss_and_grad(f, X0)
    np.testing.assert_allclose(got, fd, rtol=1e-6, atol=1e-8)


def test_inplace_multiply_reaches_its_other_operand():
    """`y.multiply_(w)` in the JAX package leaves w.grad None; the port's
    gives w its gradient."""
    x = paddle.to_tensor(X0, stop_gradient=False)
    w = paddle.to_tensor(W0, stop_gradient=False)
    y = x * 1.0
    y.multiply_(w)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), W0)
    np.testing.assert_allclose(w.grad.numpy(), X0)


def test_setitem_on_a_non_leaf_keeps_the_chain_rule():
    """`y = x * 2; y[1, 1] = 5` in the JAX package leaves x.grad None (y's
    node becomes its own input). The port's gradient is 2 everywhere but at
    the overwritten element."""
    def f(x):
        y = x * 2.0
        y[1, 1] = 5.0
        y[0] = y[0] * x[2]
        return (y * y).sum()

    x0 = np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0
    got, fd = _loss_and_grad(f, x0)
    np.testing.assert_allclose(got, fd, rtol=1e-6, atol=1e-8)
    y = paddle.to_tensor(np.ones((2, 2)), stop_gradient=False)
    z = y * 2
    z[1, 1] = 5.0
    z.sum().backward()
    np.testing.assert_allclose(y.grad.numpy(), [[2, 2], [2, 0]])


def test_setitem_of_a_tensor_that_needs_grad_reaches_it():
    x = paddle.to_tensor(np.zeros((2, 3)))
    v = paddle.to_tensor(np.array([1.0, 2.0, 3.0]), stop_gradient=False)
    x[1] = v * v
    assert not x.stop_gradient
    x.sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), [2, 4, 6])


FD_CASES = [c for c in T.CASES if c.fd_grad]


@pytest.mark.parametrize("c", FD_CASES, ids=lambda c: c.id)
def test_gradient_the_jax_package_drops_matches_finite_differences(c):
    """Ops whose gradient the JAX package drops (it wraps a raw result, or
    an in-place variant keeps a stale node): the port's gradient of
    sum_i sum(out_i * w_i) against central differences, in float64."""
    arrays = [a.astype(np.float64) if a.dtype == np.float32 else a
              for a in c.make_inputs()]
    rng = np.random.default_rng(1)
    ws = {}

    def loss(ts):
        outs = [o for o in T._flatten(c.fn(paddle, *ts))
                if hasattr(o, "dtype") and o.dtype == paddle.float64]
        total = None
        for k, o in enumerate(outs):
            if k not in ws:
                ws[k] = rng.uniform(-1, 1, o.shape)
            term = (o * paddle.to_tensor(ws[k])).sum()
            total = term if total is None else total + term
        return total

    ts = [paddle.to_tensor(a, stop_gradient=i not in c.fd_grad)
          for i, a in enumerate(arrays)]
    loss(ts).backward()
    for i in c.fd_grad:
        def value(a, i=i):
            with paddle.no_grad():
                args = [paddle.to_tensor(a if j == i else arrays[j])
                        for j in range(len(arrays))]
                return float(loss(args))

        np.testing.assert_allclose(ts[i].grad.numpy(),
                                   _fd_grad(value, arrays[i]),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{c.id} input {i}")


def test_a_leaf_that_needs_grad_is_not_changed_in_place_under_grad():
    w = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="no_grad"):
        w.add_(1.0)
    with pytest.raises(RuntimeError, match="no_grad"):
        w[0] = 3.0


def test_a_parameter_update_under_no_grad_keeps_it_a_leaf():
    """The optimizer's path: the parameter stays a leaf that needs a
    gradient, keeps its .grad and its hooks, and views taken before keep
    their values (no storage is written)."""
    w = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    seen = []
    w.register_hook(lambda g: seen.append(g.numpy().copy()))
    (w * 3).sum().backward()
    view = w.detach()
    with paddle.no_grad():
        w.subtract_(w.grad * 0.5)
    np.testing.assert_allclose(w.numpy(), [-0.5, 0.5])
    np.testing.assert_allclose(view.numpy(), [1.0, 2.0])
    assert w.is_leaf and not w.stop_gradient
    np.testing.assert_allclose(w.grad.numpy(), [3.0, 3.0])
    w.clear_grad()
    (w * w).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), [-1.0, 1.0])
    assert len(seen) == 2


def test_in_place_ops_on_grad_write_back():
    """`x.grad` is the gradient itself, as in Paddle: zeroing or scaling it
    in place changes what the next backward accumulates into."""
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3).sum().backward()
    x.grad.zero_()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 0.0])
    (x * 3).sum().backward()
    x.grad.scale_(0.5)
    np.testing.assert_allclose(x.grad.numpy(), [1.5, 1.5])
    (x * x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.5, 5.5])


def test_fills_cut_the_history():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.fill_(3.0)
    assert y.is_leaf and not y.stop_gradient
    (y * x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    np.testing.assert_allclose(y.grad.numpy(), [1.0, 2.0])


# --------------------------------------------------------------------------
# dtypes: Paddle's where the JAX package narrows
# --------------------------------------------------------------------------


def test_index_outputs_and_wide_dtypes_follow_paddle():
    assert paddle.to_tensor([1, 2]).dtype == paddle.int64
    assert paddle.argmax(paddle.to_tensor([1.0, 3.0])).dtype == paddle.int64
    x = paddle.to_tensor([1.0, 2.0], dtype="float64")
    assert x.dtype == paddle.float64 and x.numpy().dtype == np.float64
    assert paddle.to_tensor(np.array([1.5])).dtype == paddle.float64
    assert paddle.to_tensor([1.5]).dtype == paddle.float32
    # the JAX package narrows all three (x64 off)
    assert str(paddle_tpu.to_tensor([1, 2]).dtype) == "int32"
    assert str(paddle_tpu.to_tensor([1.0], dtype="float64").dtype) == \
        "float32"


def test_bf16_numpy_gives_the_raw_bits():
    x = paddle.to_tensor([1.0, -2.5, 3.140625], dtype="bfloat16")
    bits = x.numpy()
    assert bits.dtype == np.uint16
    widened = (bits.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(widened, [1.0, -2.5, 3.140625])
    ref = np.asarray(paddle_tpu.to_tensor([1.0, -2.5, 3.140625],
                                          dtype="bfloat16").numpy())
    np.testing.assert_array_equal(ref.view(np.uint16), bits)


# --------------------------------------------------------------------------
# the grad API against the JAX package's
# --------------------------------------------------------------------------


def _both(fn, *arrays, stop=False):
    out = []
    for P in (paddle_tpu, paddle):
        ts = [P.to_tensor(a, stop_gradient=stop) for a in arrays]
        out.append(fn(P, *ts))
    return out


def test_grad_allow_unused_and_create_graph_match_the_jax_package():
    a = np.array([0.5, 1.5], np.float32)
    b = np.array([2.0, -1.0], np.float32)

    def fn(P, x, y):
        z = P.to_tensor(np.ones(2, np.float32), stop_gradient=False)
        loss = (x * x * y).sum()
        gx, gz = P.grad(loss, [x, z], create_graph=True, allow_unused=True)
        assert gz is None
        (ggy,) = P.grad((gx * gx).sum(), [y])
        with pytest.raises(RuntimeError):
            P.grad((x * 2).sum(), [z])
        return gx.numpy(), ggy.numpy()

    ref, got = _both(fn, a, b)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6)


def test_non_scalar_backward_raises():
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="scalar"):
        (x * 2).backward()
    (x * 2).backward(paddle.to_tensor([1.0, 3.0]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 6.0])


def test_hook_removal_and_replacement():
    """A hook's return replaces the gradient; a removed hook no longer
    runs. (The JAX package's `RemovableHandle.remove` raises: its weak
    table's `in` compares Tensors elementwise.)"""
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x.register_hook(lambda g: g * 10)
    (x * 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [20.0, 20.0])
    h.remove()
    x.clear_grad()
    (x * 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 2.0])
    rx = paddle_tpu.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(ValueError, match="ambiguous"):
        rx.register_hook(lambda g: g).remove()


def test_pylayer_matches_the_jax_package():
    def fn(P):
        class Cube(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                ctx.k = k
                return x * x * x * k

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * 3 * x * x * ctx.k

        x = P.to_tensor(np.array([0.5, -2.0], np.float32),
                        stop_gradient=False)
        y = Cube.apply(x, 2.0)
        (y * y).sum().backward()
        return y.numpy(), x.grad.numpy()

    ref, got = fn(paddle_tpu), fn(paddle)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-6)


def test_jacobian_and_hessian_match_the_jax_package():
    a = np.array([0.5, -1.0, 2.0], np.float32)

    def fn(P, x):
        y = P.sin(x) * x
        jac = P.autograd.jacobian(y, x)
        hes = P.autograd.hessian((x * x * x).sum(), x)
        xb = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3) / 5,
                         stop_gradient=False)
        jb = P.autograd.jacobian(P.exp(xb) * 2.0, xb, batch_axis=0)
        return jac.numpy(), hes.numpy(), jb.numpy()

    ref, got = _both(fn, a)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# device and RNG
# --------------------------------------------------------------------------


def test_set_device_names():
    assert paddle.set_device("cpu") == torch.device("cpu")
    assert paddle.get_device() == "cpu"
    assert paddle.zeros([2]).place == torch.device("cpu")
    with pytest.raises(ValueError, match="'gpu'"):
        paddle.set_device("tpu")
    if not torch.cuda.is_available():
        for name in ("gpu", "gpu:0", "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                paddle.set_device(name)


def test_rng_state_round_trips_and_ops_use_the_framework_generator():
    paddle.seed(5)
    torch.manual_seed(0)
    state = paddle.get_rng_state()
    a = paddle.randn([8]).numpy()
    torch.manual_seed(1)   # torch's global generator plays no part
    paddle.set_rng_state(state)
    np.testing.assert_array_equal(paddle.randn([8]).numpy(), a)
    x = paddle.zeros([8])
    paddle.set_rng_state(state)
    x.normal_()
    np.testing.assert_array_equal(x.numpy(), a)


# --------------------------------------------------------------------------
# the in-place `op_` variants against the JAX package's, by value
# --------------------------------------------------------------------------

from paddle_tpu_torch.core.ops_patch import INPLACE_NAMES  # noqa: E402

_ELEMENTWISE = {**{n: (g,) for n, g in T._UNARY.items()}, **T._BINARY}
INPLACE = sorted(n for n in INPLACE_NAMES
                 if n in _ELEMENTWISE and hasattr(paddle, n + "_"))


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_variant_matches_the_jax_package(name):
    """`paddle.op_(x, ...)` rebinds x to op(x, ...) in both packages; the
    values agree to the op table's bars and x is the object returned."""
    rng = np.random.default_rng(7)
    arrays = [g(rng) for g in _ELEMENTWISE[name]]
    got = []
    for P in (paddle_tpu, paddle):
        ts = [P.to_tensor(a) for a in arrays]
        out = getattr(P, name + "_")(*ts)
        assert out is ts[0]
        got.append(np.asarray(ts[0].numpy()))
    T.close(got[0], got[1], T.FWD_RTOL, T.FWD_ATOL, name + "_")
