"""The port's `sparse` (`paddle_tpu_torch/sparse`) against the JAX package's
on the CPU, on seeded numpy inputs in f32: COO and CSR construction and
their methods (indices, values, nnz, to_dense, to_sparse_csr, crows,
cols, coalesce), matmul / mv / addmm with a sparse operand, the
elementwise binary ops, the value-wise ops, cast, sum, reshape, slice,
transpose, masked_matmul, mask_as, `sparse.nn.ReLU` and pca_lowrank
(its singular values and the product U S V^T, which the test matrix's
draw does not change). Values within rtol 1e-5, atol 1e-6; indices,
counts and shapes exactly."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _np(t):
    return np.asarray(t.numpy())


def _close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _exact(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


def _coo_parts(m=7, n=9, density=0.3, seed=0, positive=False):
    """Row-major sorted unique indices [2, nnz] and f32 values."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    rows, cols = np.nonzero(mask)
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    if positive:
        vals = np.abs(vals) * 0.5 + 0.1
    return np.stack([rows, cols]).astype(np.int64), vals, (m, n)


def _coo(M, seed=0, positive=False, **kw):
    idx, vals, shape = _coo_parts(seed=seed, positive=positive, **kw)
    return M.sparse.sparse_coo_tensor(idx, M.to_tensor(vals), shape)


def _csr(M, seed=0, positive=False):
    idx, vals, shape = _coo_parts(seed=seed, positive=positive)
    crows = np.concatenate([[0], np.cumsum(np.bincount(idx[0],
                                                       minlength=shape[0]))])
    return M.sparse.sparse_csr_tensor(crows, idx[1], M.to_tensor(vals), shape)


def test_coo_and_csr_construction_and_methods():
    a, b = _coo(P), _coo(J)
    assert isinstance(a, P.sparse.SparseCooTensor) and isinstance(a, P.Tensor)
    assert a.shape == b.shape and a.nnz() == b.nnz()
    _exact(a.indices(), b.indices())
    _close(a.values(), b.values())
    _close(a.to_dense(), b.to_dense())
    assert a.is_sparse() and a.is_sparse_coo() and not a.is_sparse_csr()
    c, d = a.to_sparse_csr(), b.to_sparse_csr()
    assert c.is_sparse_csr() and not c.is_sparse_coo()
    _exact(c.crows(), d.crows())
    _exact(c.cols(), d.cols())
    _close(c.to_dense(), d.to_dense())
    e, f = _csr(P), _csr(J)
    assert isinstance(e, P.sparse.SparseCsrTensor)
    _exact(e.crows(), f.crows())
    _exact(e.cols(), f.cols())
    _close(e.values(), f.values())
    _exact(e.indices(), f.indices())
    _close(e.to_sparse_coo().to_dense(), f.to_sparse_coo().to_dense())
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    # the shape from the indices when none is given
    idx, vals, _ = _coo_parts(seed=1)
    g, h = (M.sparse.sparse_coo_tensor(idx, M.to_tensor(vals))
            for M in (P, J))
    assert g.shape == h.shape
    assert P.sparse.is_same_shape(a, c) and not P.sparse.is_same_shape(a, g)


def test_duplicates_coalesce():
    idx = np.asarray([[0, 2, 0, 1], [1, 0, 1, 1]], np.int64)
    vals = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    a, b = (M.sparse.sparse_coo_tensor(idx, M.to_tensor(vals), (3, 2))
            for M in (P, J))
    assert a.nnz() == b.nnz() == 4
    for x, y in ((a.coalesce(), b.coalesce()),
                 (P.sparse.coalesce(a), J.sparse.coalesce(b))):
        assert x.nnz() == y.nnz() == 3
        _exact(x.indices(), y.indices())
        _close(x.values(), y.values())
    _close(a.to_dense(), b.to_dense())


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_matmul_mv_addmm(fmt):
    make = _coo if fmt == "coo" else _csr
    a, b = make(P), make(J)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((9, 5)).astype(np.float32)
    v = rng.standard_normal(9).astype(np.float32)
    inp = rng.standard_normal((7, 5)).astype(np.float32)
    _close(P.sparse.matmul(a, P.to_tensor(y)),
           J.sparse.matmul(b, J.to_tensor(y)))
    _close(P.sparse.mv(a, P.to_tensor(v)), J.sparse.mv(b, J.to_tensor(v)))
    _close(P.sparse.addmm(P.to_tensor(inp), a, P.to_tensor(y), 0.5, 2.0),
           J.sparse.addmm(J.to_tensor(inp), b, J.to_tensor(y), 0.5, 2.0))
    # dense @ sparse
    xd = rng.standard_normal((4, 7)).astype(np.float32)
    _close(P.sparse.matmul(P.to_tensor(xd), a),
           J.sparse.matmul(J.to_tensor(xd), b))


@pytest.mark.parametrize("op", ["add", "subtract", "multiply", "divide"])
def test_elementwise_binary(op):
    a, b = _coo(P, 3), _coo(J, 3)
    c, d = _coo(P, 4, positive=True), _coo(J, 4, positive=True)
    if op == "divide":   # a dense divisor without zeros
        dense = np.random.default_rng(5).random((7, 9)).astype(
            np.float32) + 0.5
        got = P.sparse.divide(a, P.to_tensor(dense))
        want = J.sparse.divide(b, J.to_tensor(dense))
    else:
        got = getattr(P.sparse, op)(a, c)
        want = getattr(J.sparse, op)(b, d)
    assert isinstance(got, P.sparse.SparseCooTensor)
    assert got.nnz() == want.nnz()
    _exact(got.indices(), want.indices())
    _close(got.values(), want.values())


VALUEWISE = ("sin", "sinh", "asin", "asinh", "tan", "tanh", "atan", "atanh",
             "sqrt", "square", "abs", "neg", "log1p", "expm1", "deg2rad",
             "rad2deg", "isnan", "relu")


@pytest.mark.parametrize("op", VALUEWISE)
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_valuewise_ops_keep_structure(op, fmt):
    positive = op in ("sqrt", "log1p", "asin", "atanh")
    make = _coo if fmt == "coo" else _csr
    a, b = make(P, 6, positive), make(J, 6, positive)
    got, want = getattr(P.sparse, op)(a), getattr(J.sparse, op)(b)
    assert type(got) is type(a)
    assert got.nnz() == want.nnz()
    _exact(got.indices(), want.indices())
    gv, wv = _np(got.values()), _np(want.values())
    if op == "isnan":
        np.testing.assert_array_equal(gv, wv)
    else:
        _close(got.values(), want.values())


def test_pow_cast_sum_relu_layer():
    a, b = _coo(P, 7), _coo(J, 7)
    _close(P.sparse.pow(a, 3).values(), J.sparse.pow(b, 3).values())
    got = P.sparse.cast(a, index_dtype="int32", value_dtype="float16")
    want = J.sparse.cast(b, index_dtype="int32", value_dtype="float16")
    assert _np(got.indices()).dtype == np.int32
    assert _np(got.values()).dtype == _np(want.values()).dtype == np.float16
    _exact(got.indices(), want.indices())
    np.testing.assert_array_equal(_np(got.values()), _np(want.values()))
    for axis, keep in ((None, False), (0, False), (1, True), (None, True)):
        _close(P.sparse.sum(a, axis=axis, keepdim=keep),
               J.sparse.sum(b, axis=axis, keepdim=keep))
    _close(P.sparse.sum(a, dtype="float64"), J.sparse.sum(b, dtype="float64"))
    _close(P.sparse.nn.ReLU()(a).to_dense(), J.sparse.nn.ReLU()(b).to_dense())


def test_reshape_slice_transpose():
    a, b = _coo(P, 8, m=6, n=8), _coo(J, 8, m=6, n=8)
    for got, want in ((P.sparse.reshape(a, [4, 12]),
                       J.sparse.reshape(b, [4, 12])),
                      (P.sparse.slice(a, [0, 1], [1, 2], [5, 7]),
                       J.sparse.slice(b, [0, 1], [1, 2], [5, 7])),
                      (P.sparse.transpose(a, [1, 0]),
                       J.sparse.transpose(b, [1, 0]))):
        assert got.shape == want.shape and got.nnz() == want.nnz()
        _exact(got.indices(), want.indices())
        _close(got.values(), want.values())


def test_masked_matmul_and_mask_as():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((7, 4)).astype(np.float32)
    y = rng.standard_normal((4, 9)).astype(np.float32)
    dense = rng.standard_normal((7, 9)).astype(np.float32)
    for make in (_coo, _csr):
        a, b = make(P, 10), make(J, 10)
        got = P.sparse.masked_matmul(P.to_tensor(x), P.to_tensor(y), a)
        want = J.sparse.masked_matmul(J.to_tensor(x), J.to_tensor(y), b)
        _exact(got.indices(), want.indices())
        _close(got.values(), want.values())
        got = P.sparse.mask_as(P.to_tensor(dense), a)
        want = J.sparse.mask_as(J.to_tensor(dense), b)
        _exact(got.indices(), want.indices())
        _close(got.values(), want.values())


def test_pca_lowrank_on_a_low_rank_matrix():
    """A rank-3 matrix with q = 4: the randomized range finder captures it
    whatever its test matrix, so S and U S V^T match the JAX package's."""
    rng = np.random.default_rng(11)
    m = (rng.standard_normal((20, 3)) @ rng.standard_normal((3, 12))).astype(
        np.float32)
    idx = np.stack(np.nonzero(m)).astype(np.int64)
    vals = m[tuple(idx)]
    outs = []
    for M in (P, J):
        sp = M.sparse.sparse_coo_tensor(idx, M.to_tensor(vals), m.shape)
        u, s, v = M.sparse.pca_lowrank(sp, q=4, center=True)
        outs.append((_np(u), _np(s), _np(v)))
    (pu, ps, pv), (ju, js, jv) = outs
    assert pu.shape == ju.shape and ps.shape == js.shape == (4,)
    top = float(js.max())
    np.testing.assert_allclose(ps[:3], js[:3], rtol=1e-4)
    assert ps[3] <= 1e-4 * top and js[3] <= 1e-4 * top
    rec = lambda u, s, v: (u[:, :3] * s[:3]) @ v[:, :3].T  # noqa: E731
    np.testing.assert_allclose(rec(pu, ps, pv), rec(ju, js, jv),
                               atol=1e-4 * top)
