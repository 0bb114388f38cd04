"""The port's dy2static (`paddle_tpu_torch/jit/dy2static.py`) and
`jit.to_static` against the JAX package's, on the CPU: the 38 cases of
`tests/test_dy2static.py`, each converted function run through both
packages' `to_static` on the same numpy inputs (f32, atol 1e-6), with the
same fallback behaviour (no whole-callable fallback where the JAX package
compiles, the same count where it degrades) and the same region and
fallback reports. A traced predicate is `torch.cond`'s operator and a
traced loop `while_loop`'s in the port's program, which the cases that
compile also check.
"""

import functools
import warnings

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine
torch.set_num_threads(1)

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    T.set_device("cpu")
    yield
    port_device._current = prev


def _t(P, x, dtype="float32"):
    return P.to_tensor(np.asarray(x, dtype))


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), np.float64)
    return np.asarray(x, np.float64)


def _linear(P, i, o, seed=0):
    """A Linear with the same numpy weights in both packages."""
    rng = np.random.default_rng(seed)
    lin = P.nn.Linear(i, o)
    lin.weight.set_value(P.to_tensor(
        rng.normal(size=(i, o)).astype(np.float32)))
    lin.bias.set_value(P.to_tensor(rng.normal(size=(o,)).astype(np.float32)))
    return lin


def assert_no_fallback(P, fn, *argsets):
    """Run fn over argsets twice (trace + cached), assert no eager fallback
    and no fallback warning."""
    base = P.jit.fallback_count()
    outs = []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for args in argsets:
            outs.append(fn(*args))
            outs.append(fn(*args))
    assert P.jit.fallback_count() == base, "callable degraded to eager"
    assert not any("control flow" in str(w.message) for w in rec), \
        [str(w.message) for w in rec]
    return outs


def _falls_back(P, fn, *args):
    base = P.jit.fallback_count()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args)
    assert P.jit.fallback_count() == base + 1
    assert any("control flow" in str(w.message) for w in rec)
    return out


def _targets(sf):
    """The call targets of the port's traced programs."""
    return {t for prog in sf.programs() for t in prog.graph_targets()}


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


@both
def test_tensor_if_else_assignment(P):
    def f(x):
        if x.sum() > 0:
            y = x * 2
        else:
            y = x - 1
        return y

    sf = P.jit.to_static(f)
    pos, neg = _t(P, [1.0, 2.0]), _t(P, [-3.0, -4.0])
    assert_no_fallback(P, sf, (pos,), (neg,))
    np.testing.assert_allclose(sf(pos).numpy(), f(pos).numpy())
    np.testing.assert_allclose(sf(neg).numpy(), f(neg).numpy())
    if P is T:
        assert "higher_order.cond" in _targets(sf)
    return [sf(pos), sf(neg)]


@both
def test_tensor_if_return_both_sides(P):
    def f(x):
        if x.mean() > 0:
            return x * 3
        return -x

    sf = P.jit.to_static(f)
    pos, neg = _t(P, [1.0, 2.0]), _t(P, [-3.0, -4.0])
    assert_no_fallback(P, sf, (pos,), (neg,))
    np.testing.assert_allclose(sf(pos).numpy(), f(pos).numpy())
    np.testing.assert_allclose(sf(neg).numpy(), f(neg).numpy())
    return [sf(pos), sf(neg)]


@both
def test_tensor_while_loop(P):
    def f(x):
        n = P.to_tensor(np.asarray(0, "int32"))
        while x.sum() > 1:
            x = x * 0.5
            n = n + 1
        return x, n

    sf = P.jit.to_static(f)
    a = _t(P, [4.0, 4.0])
    assert_no_fallback(P, sf, (a,))
    out, n = sf(a)
    ref_out, ref_n = f(a)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy())
    assert int(n) == int(ref_n) == 3
    if P is T:
        assert "higher_order.while_loop" in _targets(sf)
    return [out, int(n)]


@both
def test_nested_if_in_while(P):
    def f(x):
        total = P.zeros([2])
        while x.sum() > 1:
            if x.mean() > 2:
                total = total + x
            else:
                total = total - x
            x = x * 0.5
        return total

    sf = P.jit.to_static(f)
    a = _t(P, [8.0, 8.0])
    assert_no_fallback(P, sf, (a,))
    np.testing.assert_allclose(sf(a).numpy(), f(a).numpy())
    return [sf(a)]


@both
def test_bool_ops_in_condition(P):
    def f(x, lo, hi):
        if (x.sum() > lo) and (x.sum() < hi):
            return x + 10
        if (x.min() < 0) or (x.max() > 100):
            return x - 10
        return x

    sf = P.jit.to_static(f)
    mid, neg = _t(P, [1.0, 2.0]), _t(P, [-50.0, 0.0])
    argsets = [(mid, _t(P, 0.0), _t(P, 10.0)),
               (neg, _t(P, 0.0), _t(P, 10.0))]
    assert_no_fallback(P, sf, *argsets)
    for args in argsets:
        np.testing.assert_allclose(sf(*args).numpy(), f(*args).numpy())
    return [sf(*a) for a in argsets]


@both
def test_not_in_condition(P):
    def f(x):
        if not (x.sum() > 0):
            return -x
        return x

    sf = P.jit.to_static(f)
    pos, neg = _t(P, [1.0]), _t(P, [-1.0])
    assert_no_fallback(P, sf, (pos,), (neg,))
    np.testing.assert_allclose(sf(neg).numpy(), f(neg).numpy())
    return [sf(pos), sf(neg)]


@both
def test_layer_forward_with_control_flow(P):
    class Gate(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = _linear(P, 4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                return h * 2
            return h * 0.5

    layer = Gate()
    sf = P.jit.to_static(layer)
    x = _t(P, np.random.default_rng(0).normal(size=(2, 4)))
    assert_no_fallback(P, sf, (x,))
    np.testing.assert_allclose(sf(x).numpy(), layer(x).numpy(), rtol=1e-5)
    return [sf(x)]


@both
def test_while_var_defined_only_in_loop_falls_back(P):
    """A loop variable with no pre-loop binding has no shape for the loop
    carry: the region is uncompilable and falls back, and the answer is
    right. The JAX package then degrades the whole callable (jax.jit
    stages `i < 3` on a constant, so the Python loop's bool() fails); in
    the port's trace a tensor made inside the function stays a constant,
    so the loop runs as Python and the callable stays compiled."""

    def f(x):
        i = P.to_tensor(np.asarray(0, "int32"))
        while i < 3:
            y = x * (i + 1)
            i = i + 1
        return y

    sf = P.jit.to_static(f)
    if P is J:
        out = _falls_back(P, sf, _t(P, [2.0]))
    else:
        base = P.jit.fallback_count()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = sf(_t(P, [2.0]))
        assert P.jit.fallback_count() == base
        assert any("retrying with it as ordinary Python" in str(w.message)
                   for w in rec)
        assert sf.conversion_report()["fallback_regions"]
    np.testing.assert_allclose(out.numpy(), [6.0])
    return [out]


@both
def test_python_condition_stays_python(P):
    calls = []

    def f(x, flag):
        if flag:
            calls.append("t")
            return x + 1
        calls.append("f")
        return x - 1

    sf = P.jit.to_static(f)
    out = sf(_t(P, [1.0]), True)
    np.testing.assert_allclose(out.numpy(), [2.0])
    assert calls == ["t"]  # the false branch never ran
    return [out]


@both
def test_mismatched_branches_fall_back(P):
    def f(x):
        if x.sum() > 0:
            return x[:1]
        return x

    sf = P.jit.to_static(f)
    out = _falls_back(P, sf, _t(P, [1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), [1.0])
    return [out]


@both
def test_op_error_in_traced_region_propagates(P):
    """An error an op raises while a traced branch or loop body is built
    is the program's: to_static raises it, and neither the region nor the
    callable falls back."""
    def fail(x):
        raise RuntimeError("an op failed while tracing")

    def f(x):
        if x.sum() > 0:
            y = x * 2
        else:
            y = fail(x)
        return y

    def g(x):
        while x.sum() < 10:
            x = fail(x)
        return x

    base = P.jit.fallback_count()
    for fn in (f, g):
        sf = P.jit.to_static(fn)
        with pytest.raises(RuntimeError, match="an op failed while tracing"):
            sf(_t(P, [1.0, 2.0]))
        assert not sf.conversion_report()["fallback_regions"]
    assert P.jit.fallback_count() == base
    return []


@both
def test_host_conversion_still_falls_back(P):
    def f(x):
        if float(x.sum()) > 0:
            return x * 2
        return x - 1

    sf = P.jit.to_static(f)
    out = _falls_back(P, sf, _t(P, [1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])
    return [out]


@both
def test_converted_fn_is_jitted_once(P):
    traces = []

    def f(x):
        traces.append(1)
        if x.sum() > 0:
            return x * 2
        return x - 1

    sf = P.jit.to_static(f)
    a = _t(P, [1.0, 2.0])
    out = [sf(a), sf(a), sf(a)]
    assert len(traces) == 1, f"retraced {len(traces)} times"
    return out


@both
def test_raise_guard_stays_eager(P):
    def f(x):
        if (x < 0).any():
            raise ValueError("negative input")
        return x * 2

    sf = P.jit.to_static(f)
    base = P.jit.fallback_count()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        out = sf(_t(P, [1.0, 2.0]))  # must not raise
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])
    assert P.jit.fallback_count() == base + 1
    with pytest.raises(ValueError, match="negative input"):
        sf(_t(P, [-1.0, 2.0]))
    return [out]


@both
def test_wrapped_decorator_preserved(P):
    def plus100(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            return fn(*a, **k) + 100

        return wrapper

    @plus100
    def g(x):
        return x * 2

    conv = P.jit.dy2static.convert_function(g)
    out = conv(_t(P, [1.0]))
    np.testing.assert_allclose(out.numpy(), [102.0])
    return [out]


@both
def test_closure_cells_stay_live(P):
    def make():
        scale = 1.0

        def f(x):
            if x.sum() > 0:
                y = x * scale
            else:
                y = -x * scale
            return y

        def set_scale(v):
            nonlocal scale
            scale = v

        return f, set_scale

    f, set_scale = make()
    conv = P.jit.dy2static.convert_function(f)
    a = conv(_t(P, [3.0]))
    set_scale(10.0)
    b = conv(_t(P, [3.0]))
    np.testing.assert_allclose(a.numpy(), [3.0])
    np.testing.assert_allclose(b.numpy(), [30.0])
    return [a, b]


@both
def test_while_tuple_carry_falls_back_gracefully(P):
    def f(x):
        pair = (x, x * 0)
        while pair[1].sum() < 3:
            pair = (pair[0], pair[1] + 1)
        return pair[1]

    sf = P.jit.to_static(f)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        out = sf(_t(P, [1.0, 1.0]))
    np.testing.assert_allclose(out.numpy(), [2.0, 2.0])
    return [out]


@both
def test_hooks_survive_conversion(P):
    calls = []

    class L(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = _linear(P, 4, 4)

        def forward(self, x):
            if x.sum() > 0:
                return self.fc(x)
            return self.fc(x) * 2

    layer = L()
    layer.register_forward_post_hook(
        lambda lyr, inp, out: calls.append("post") or None)
    sf = P.jit.to_static(layer)
    out = sf(_t(P, np.ones((2, 4))))
    assert calls  # the hook ran inside the traced forward
    return [out]


@both
def test_for_range_tensor_bound_compiles(P):
    def f(x):
        acc = P.zeros([1])
        n = P.to_tensor(np.asarray(0, "int32")) + (x > 0).sum()
        for i in range(n):
            acc = acc + x.sum() * (i + 1)
        return acc

    sf = P.jit.to_static(f)
    a = _t(P, [1.0, 2.0, -1.0])  # n = 2: acc = 2*1 + 2*2 = 6
    assert_no_fallback(P, sf, (a,))
    np.testing.assert_allclose(sf(a).numpy(), [6.0])
    b = _t(P, [1.0, 1.0, 1.0])  # n = 3: acc = 3*(1+2+3) = 18
    np.testing.assert_allclose(sf(b).numpy(), [18.0])
    return [sf(a), sf(b)]


@both
def test_for_range_concrete_still_python(P):
    seen = []

    def f(x):
        total = x * 0
        for i in range(3):
            seen.append(i)
            total = total + x
        return total

    sf = P.jit.to_static(f)
    out = sf(_t(P, [2.0]))
    np.testing.assert_allclose(out.numpy(), [6.0])
    assert seen == [0, 1, 2]
    return [out]


@both
def test_for_range_with_start_step(P):
    def f(x):
        acc = P.zeros([1])
        n = (x > 0).sum() * 3  # tensor stop
        for i in range(1, n, 2):  # 1, 3, 5 when n=6
            acc = acc + float(1) * x.sum() * 0 + acc * 0 + i
        return acc

    sf = P.jit.to_static(f)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        out = sf(_t(P, [1.0, 1.0]))
    np.testing.assert_allclose(out.numpy(), [9.0])
    return [out]


@both
def test_for_over_list_untouched(P):
    def f(x, scales):
        for s in scales:
            x = x * s
        return x

    sf = P.jit.to_static(f)
    out = sf(_t(P, [2.0]), [2.0, 3.0])
    np.testing.assert_allclose(out.numpy(), [12.0])
    return [out]


@both
def test_for_range_loop_var_semantics(P):
    def f(x):
        last = None
        for i in range(3):
            last = x * (i + 1)
        return last, i  # noqa: B023 - python for-semantics: i == 2

    sf = P.jit.to_static(f)
    out, i = sf(_t(P, [1.0]))
    np.testing.assert_allclose(out.numpy(), [3.0])
    assert int(i) == 2

    def g(x):
        for i in range(0):
            pass
        return i  # Python: NameError (unbound)

    with pytest.raises((NameError, UnboundLocalError, Exception)):
        P.jit.to_static(g)(_t(P, [1.0]))
    return [out, int(i)]


@both
def test_for_in_traced_if_still_compiles(P):
    def h(x):
        acc = x * 0
        if x.sum() > 0:
            for i in range(3):
                acc = acc + x
        else:
            acc = -x
        return acc

    sf = P.jit.to_static(h)
    pos, neg = _t(P, [2.0]), _t(P, [-2.0])
    assert_no_fallback(P, sf, (pos,), (neg,))
    np.testing.assert_allclose(sf(pos).numpy(), [6.0])
    np.testing.assert_allclose(sf(neg).numpy(), [2.0])
    return [sf(pos), sf(neg)]


@both
def test_branch_internal_read_keeps_prebranch_value(P):
    def f(x):
        a = x
        if x.sum() > 0:
            a = a + 1.0
            y = a * 2.0
        else:
            y = x
        return y

    sf = P.jit.to_static(f)
    a, b = sf(_t(P, [1.0])), sf(_t(P, [-1.0]))
    np.testing.assert_allclose(a.numpy(), [4.0])
    np.testing.assert_allclose(b.numpy(), [-1.0])
    return [a, b]


@both
def test_loop_back_edge_liveness(P):
    def f(x):
        a = x * 0
        b = x * 0
        i = 0
        while i < 3:
            b = b + a
            if x.sum() > 0:
                a = x + 10.0
            else:
                a = x - 10.0
            i = i + 1
        return b

    sf = P.jit.to_static(f)
    a, b = sf(_t(P, [1.0])), sf(_t(P, [-1.0]))
    np.testing.assert_allclose(a.numpy(), [22.0])  # 0 + 11 + 11
    np.testing.assert_allclose(b.numpy(), [-22.0])
    return [a, b]


@both
def test_loop_exit_flag_in_branch(P):
    def f(x):
        flag = True
        n = 0
        while flag:
            n = n + 1
            if n >= 3:
                flag = False
        return x * n

    sf = P.jit.to_static(f)
    out = sf(_t(P, [2.0]))
    np.testing.assert_allclose(out.numpy(), [6.0])
    return [out]


@both
def test_shadowed_range_keeps_python_semantics(P):
    def f(x):
        range = lambda n: [n, n]  # noqa: A001, E731
        acc = x * 0
        for i in range(2):
            acc = acc + i
        return acc

    sf = P.jit.to_static(f)
    out = sf(_t(P, [0.0]))
    np.testing.assert_allclose(out.numpy(), [4.0])
    return [out]


@both
def test_while_break_on_tensor_condition(P):
    def f(x):
        i = P.to_tensor(np.float32(0.0))
        while i < 100.0:
            x = x + 1.0
            if x.sum() > 10.0:
                break
            i = i + 1.0
        return x

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [1.0, 2.0]),),
                              (_t(P, [-50.0, 0.0]),))
    rep = sf.conversion_report()
    kinds = {(r["kind"], r["status"]) for r in rep["report"]["regions"]}
    assert ("while", "converted") in kinds, rep
    return [outs[0], outs[2], sorted(kinds) == sorted(kinds)]


@both
def test_while_continue_and_trailing_statements(P):
    def f(x):
        i = P.to_tensor(np.float32(0.0))
        acc = P.zeros_like(x)
        while i < 6.0:
            i = i + 1.0
            if (i % 2.0) < 1.0:
                continue
            acc = acc + x * i  # runs for odd i only
        return acc

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [1.0, 3.0]),))
    np.testing.assert_allclose(outs[0].numpy(), [9.0, 27.0], rtol=1e-6)
    return [outs[0]]


@both
def test_for_range_break_tensor_condition(P):
    def f(x):
        for i in range(100):
            x = x + 1.0
            if x.sum() > 9.0:
                break
        return x, i

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [0.0, 0.0]),))
    x, i = outs[0]
    np.testing.assert_allclose(x.numpy(), [5.0, 5.0])
    i = int(np.asarray(i.numpy() if hasattr(i, "numpy") else i))
    assert i == 4
    return [x, i]


@both
def test_for_range_continue_parity(P):
    def f(x):
        acc = P.zeros_like(x)
        for i in range(8):
            if (P.to_tensor(np.float32(i)) % 2.0) < 1.0:
                continue
            acc = acc + x * float(i)
        return acc

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [1.0]),))
    np.testing.assert_allclose(outs[0].numpy(), [1 + 3 + 5 + 7.0])
    return [outs[0]]


@both
def test_mid_branch_return_with_trailing_code(P):
    def f(x):
        if x.sum() > 0.0:
            y = x * 2.0
            return y + 1.0
        z = x - 1.0
        z = z * 3.0
        return z

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [1.0]),), (_t(P, [-1.0]),))
    np.testing.assert_allclose(outs[0].numpy(), [3.0])
    np.testing.assert_allclose(outs[2].numpy(), [-6.0])
    return [outs[0], outs[2]]


@both
def test_mid_branch_return_nested(P):
    def f(x):
        if x.sum() > 0.0:
            if x.sum() > 10.0:
                return x * 100.0
            return x * 10.0
        return x

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(
        P, sf, (_t(P, [20.0]),), (_t(P, [1.0]),), (_t(P, [-1.0]),))
    np.testing.assert_allclose(outs[0].numpy(), [2000.0])
    np.testing.assert_allclose(outs[2].numpy(), [10.0])
    np.testing.assert_allclose(outs[4].numpy(), [-1.0])
    return [outs[0], outs[2], outs[4]]


@both
def test_nested_return_falls_through_in_non_tail_block(P):
    def f(x, flag):
        if flag:  # a concrete Python bool: stays a Python if
            if x.sum() > 100.0:
                return x * 0.0
        z = x + 1.0
        return z

    sf = P.jit.to_static(f)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        o1 = sf(_t(P, [1.0]), True)
        o2 = sf(_t(P, [1.0]), False)
        o3 = sf(_t(P, [200.0]), True)
    np.testing.assert_allclose(o1.numpy(), [2.0])
    np.testing.assert_allclose(o2.numpy(), [2.0])
    np.testing.assert_allclose(o3.numpy(), [0.0])
    return [o1, o2, o3]


@both
def test_static_python_args_recompile_per_value(P):
    calls = []

    def f(x, flag):
        if flag:
            calls.append("t")
            return x + 1
        calls.append("f")
        return x - 1

    sf = P.jit.to_static(f)
    o1 = sf(_t(P, [1.0]), True)
    o2 = sf(_t(P, [1.0]), False)
    np.testing.assert_allclose(o1.numpy(), [2.0])
    np.testing.assert_allclose(o2.numpy(), [0.0])
    assert calls == ["t", "f"]  # one trace each; the other branch never ran
    return [o1, o2]


@both
def test_per_region_fallback_keeps_callable_compiled(P):
    def f(x, n):
        out = x
        i = 0
        while i < n:  # concrete python ints drive the loop
            out = P.concat([out, out])  # the shape grows: no loop carry
            i = i + 1
        return out.sum() + x.sum()

    base = P.jit.fallback_count()
    sf = P.jit.to_static(f)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = sf(_t(P, [1.0, 2.0]), 3)
    np.testing.assert_allclose(float(out.numpy()), 8 * 3.0 + 3.0)
    assert P.jit.fallback_count() == base, "whole callable degraded"
    assert any("retrying with it as ordinary Python" in str(w.message)
               for w in rec)
    rep = sf.conversion_report()
    assert rep["fallback_regions"], rep
    assert not rep["eager_only"]
    assert any(r["event"] == "region" and r["name"] == "f"
               for r in P.jit.fallback_report())
    return [out, len(rep["fallback_regions"])]


@both
def test_convert_call_nested_helper(P):
    def helper(v):
        if v.sum() > 0.0:
            return v * 2.0
        return v * -1.0

    def f(x):
        y = helper(x)
        return y + helper(y)

    sf = P.jit.to_static(f)
    outs = assert_no_fallback(P, sf, (_t(P, [1.0]),), (_t(P, [-1.0]),))
    np.testing.assert_allclose(outs[0].numpy(), [6.0])    # 2 + 4
    np.testing.assert_allclose(outs[2].numpy(), [3.0])    # 1 + 2
    return [outs[0], outs[2]]


@both
def test_convert_call_user_sublayer(P):
    class Gate(P.nn.Layer):
        def forward(self, v):
            if v.mean() > 0.0:
                return v
            return v * 0.0

    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = _linear(P, 4, 4)
            self.gate = Gate()

        def forward(self, x):
            return self.gate(self.fc(x)).sum()

    net = Net()
    sf = P.jit.to_static(net)
    x = _t(P, np.ones((2, 4), np.float32))
    outs = assert_no_fallback(P, sf, (x,))
    eager = float(net(x).numpy())
    np.testing.assert_allclose(float(outs[0].numpy()), eager, rtol=1e-5)
    return [outs[0]]


def test_layer_state_keys_the_program():
    """A to_static program belongs to its layer's weight dtypes and
    train/eval mode: switching the layer to train, or casting it to bf16,
    between calls traces anew, and each call equals the eager layer, as
    the JAX package's eager layer gives it. The JAX package's to_static
    re-traces on the cast too (its weights are jit arguments) but replays
    the eval program after `train()`: a reference-side departure (ROADMAP
    §C)."""
    w = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    x = np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)

    def run(P):
        class Net(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.lin = P.nn.Linear(4, 3)

            def forward(self, x):
                y = self.lin(x.astype(self.lin.weight.dtype))
                if self.training:
                    y = y * 2
                return y.astype("float32")

        net = Net()
        net.lin.weight.set_value(P.to_tensor(w))
        net.lin.bias.set_value(P.to_tensor(np.zeros(3, np.float32)))
        sf = P.jit.to_static(net)
        xt = P.to_tensor(x)
        net.eval()
        outs = [sf(xt)]
        net.train()
        outs += [sf(xt), net(xt)]
        net.eval()
        net.to(dtype="bfloat16")
        outs += [sf(xt), net(xt)]
        return [_np(o) for o in outs]

    base = T.jit.fallback_count()
    t_eval, t_train, t_train_eager, t_bf16, t_bf16_eager = run(T)
    assert T.jit.fallback_count() == base
    j_eval, j_train, j_train_eager, j_bf16, j_bf16_eager = run(J)
    np.testing.assert_allclose(t_eval, j_eval, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_train, t_train_eager, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_train, j_train_eager, atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_bf16, t_bf16_eager, atol=0, rtol=0)
    np.testing.assert_allclose(t_bf16, j_bf16, atol=0, rtol=0)
    assert np.abs(t_bf16 - t_eval).max() > 0  # the bf16 weights were used
    np.testing.assert_allclose(j_train, j_eval, atol=0, rtol=0)  # stale


def test_region_and_fallback_reports_match():
    """The reports of a region fallback and of a whole-callable fallback
    carry the JAX package's fields, kinds and events."""
    def run(P):
        def f(x, n):
            out = x
            i = 0
            while i < n:
                out = P.concat([out, out])
                i = i + 1
            return out.sum()

        def g(x):
            if float(x.sum()) > 0:
                return x
            return -x

        start = len(P.jit.fallback_report())
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            sf = P.jit.to_static(f)
            sf(_t(P, [1.0]), 2)
            P.jit.to_static(g)(_t(P, [1.0]))
        recs = P.jit.fallback_report()[start:]
        rep = sf.conversion_report()
        regions = [(r["kind"], r["status"]) for r in rep["report"]["regions"]]
        return ([(r["name"], r["event"]) for r in recs], regions,
                sorted(rep), rep["eager_only"])

    assert run(T) == run(J)
