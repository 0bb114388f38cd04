"""paddle.sparse (`paddle_tpu/sparse/__init__.py`; reference
`paddle/phi/core/sparse_coo_tensor.h`, `sparse_csr_tensor.h`, kernels
`paddle/phi/kernels/sparse/`, Python `python/paddle/sparse/`): COO and CSR
tensors over `torch.sparse_coo` and `torch.sparse_csr`.

`SparseCooTensor` and `SparseCsrTensor` are the port's `Tensor` holding a
torch sparse tensor, which carries their device: the ops run where their
inputs lie. The JAX package keeps both as one BCOO; the functions follow
its results: value-wise ops keep the stored indices (and the type),
elementwise binary ops, `transpose`, `reshape` and `slice` densify and
return a COO of the nonzero entries in row-major order, `matmul`, `mv`
and `addmm` with a sparse operand return dense tensors (torch's sparse
products, where the JAX package densifies; the sums run in another
order), `masked_matmul` and `mask_as` evaluate at the mask's stored
indices. torch keeps COO indices in int64; `cast(index_dtype=)` is kept
as the dtype `indices()`, `crows()` and `cols()` return.
"""

from __future__ import annotations

import builtins as _builtins

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply  # noqa: F401
from paddle_tpu_torch.framework import dtypes as _dtypes

__all__ = [
    "sparse_coo_tensor", "sparse_csr_tensor", "is_same_shape",
    "matmul", "add", "multiply", "subtract", "divide", "relu", "transpose",
    "SparseCooTensor", "SparseCsrTensor",
]


class SparseCooTensor(Tensor):
    """A Tensor over a torch sparse COO tensor (its `_data`)."""

    __slots__ = ("_index_dtype",)

    def __init__(self, sp, stop_gradient=True, index_dtype=None):
        super().__init__(sp, stop_gradient=stop_gradient)
        self._index_dtype = index_dtype

    def _coo(self):
        """The storage as a torch COO tensor (CSR converted)."""
        return self._data

    def _index(self, t):
        return t if self._index_dtype is None else t.to(self._index_dtype)

    # -- sparse surface (reference python/paddle/sparse/creation.py) -------
    def indices(self):
        return Tensor(self._index(self._coo()._indices()))

    def values(self):
        return Tensor(self._coo()._values())

    def nnz(self):
        return int(self._data._nnz())

    def to_dense(self):
        return Tensor(self._data.to_dense())

    def to_sparse_csr(self):
        return SparseCsrTensor(self._coo().coalesce().to_sparse_csr(),
                               index_dtype=self._index_dtype)

    def coalesce(self):
        return SparseCooTensor(self._coo().coalesce(),
                               index_dtype=self._index_dtype)

    def is_sparse(self):
        return True

    def is_sparse_coo(self):
        return True

    def is_sparse_csr(self):
        return False

    def numpy(self):
        return Tensor(self._data.to_dense()).numpy()

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


class SparseCsrTensor(SparseCooTensor):
    """A Tensor over a torch sparse CSR tensor (2-D)."""

    __slots__ = ()

    def _coo(self):
        return self._data.to_sparse_coo()

    def is_sparse_coo(self):
        return False

    def is_sparse_csr(self):
        return True

    def crows(self):
        return Tensor(self._index(self._data.crow_indices()))

    def cols(self):
        return Tensor(self._index(self._data.col_indices()))

    def values(self):
        return Tensor(self._data.values())

    def to_sparse_coo(self, sparse_dim=2):
        return SparseCooTensor(self._coo(), index_dtype=self._index_dtype)

    def coalesce(self):
        return self

    def __repr__(self):
        return (f"SparseCsrTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype})")


def _as_array(x, device=None):
    if isinstance(x, Tensor):
        return x._data
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, device=device)


def _host_ints(x):
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.int64)
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _dense(x):
    return x._data.to_dense() if isinstance(x, SparseCooTensor) \
        else _as_array(x)


def _place(values, place):
    if isinstance(values, Tensor):
        return values._data.device
    from paddle_tpu_torch.framework import device as _device

    return _device.place(place)


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """reference `python/paddle/sparse/creation.py` sparse_coo_tensor;
    indices: [sparse_dim, nnz]."""
    idx = _host_ints(indices)
    vals = _as_array(values, _place(values, place))
    if dtype is not None:
        vals = vals.to(_dtypes.convert_dtype(dtype))
    if shape is None:
        shape = tuple(int(m) + 1 for m in idx.max(dim=1).values)
    sp = torch.sparse_coo_tensor(idx.to(vals.device), vals, tuple(shape))
    return SparseCooTensor(sp, stop_gradient=stop_gradient)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    crows, cols = _host_ints(crows), _host_ints(cols)
    vals = _as_array(values, _place(values, place))
    if dtype is not None:
        vals = vals.to(_dtypes.convert_dtype(dtype))
    sp = torch.sparse_csr_tensor(crows.to(vals.device), cols.to(vals.device),
                                 vals, tuple(shape))
    return SparseCsrTensor(sp, stop_gradient=stop_gradient)


def is_same_shape(x, y):
    return list(x.shape) == list(y.shape)


def _spmm(sp, d):
    """A 2-D sparse tensor times a dense matrix or vector."""
    if d.dim() == 1:
        return (sp @ d[:, None])[:, 0]
    return sp @ d


def matmul(x, y, name=None):
    """spmm: sparse @ dense (reference paddle.sparse.matmul), dense."""
    if isinstance(x, SparseCooTensor):
        return Tensor(_spmm(x._data, _dense(y)))
    return Tensor(_as_array(x) @ y._data.to_dense())


def _from_dense(out):
    """The nonzero entries of a dense result, a COO in row-major order."""
    return SparseCooTensor(out.to_sparse())


def _ewise(op, x, y):
    return _from_dense(op(_dense(x), _dense(y)))


def add(x, y, name=None):
    return _ewise(torch.add, x, y)


def subtract(x, y, name=None):
    return _ewise(torch.sub, x, y)


def multiply(x, y, name=None):
    return _ewise(torch.mul, x, y)


def divide(x, y, name=None):
    return _ewise(torch.div, x, y)


def _with_values(x, vals):
    """x's stored indices (and type) over new values."""
    d = x._data
    if isinstance(x, SparseCsrTensor):
        sp = torch.sparse_csr_tensor(d.crow_indices(), d.col_indices(), vals,
                                     d.shape)
    else:
        sp = torch.sparse_coo_tensor(d._indices(), vals, d.shape,
                                     is_coalesced=d.is_coalesced())
    return type(x)(sp, index_dtype=x._index_dtype)


def _valuewise(fn):
    def op(x, name=None):
        return _with_values(x, fn(x.values()._data))

    return op


relu = _valuewise(torch.relu)


def transpose(x, perm, name=None):
    return _from_dense(torch.permute(x._data.to_dense(), tuple(perm)))


class nn:
    """paddle.sparse.nn subset (ReLU)."""

    class ReLU:
        def __call__(self, x):
            return relu(x)


# value-wise ops act on the stored values (the nnz structure is kept);
# value -> dense ops densify (reference `python/paddle/sparse/unary.py`,
# `binary.py`, `multiary.py`)

sin = _valuewise(torch.sin)
sinh = _valuewise(torch.sinh)
asin = _valuewise(torch.asin)
asinh = _valuewise(torch.asinh)
tan = _valuewise(torch.tan)
tanh = _valuewise(torch.tanh)
atan = _valuewise(torch.atan)
atanh = _valuewise(torch.atanh)
sqrt = _valuewise(torch.sqrt)
square = _valuewise(torch.square)
abs = _valuewise(torch.abs)
neg = _valuewise(torch.neg)
log1p = _valuewise(torch.log1p)
expm1 = _valuewise(torch.expm1)
pow = lambda x, factor, name=None: _valuewise(  # noqa: E731
    lambda v: torch.pow(v, factor))(x)
deg2rad = _valuewise(torch.deg2rad)
rad2deg = _valuewise(torch.rad2deg)
isnan = _valuewise(torch.isnan)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    vals = x.values()._data
    if value_dtype is not None:
        vals = vals.to(_dtypes.convert_dtype(value_dtype))
    out = _with_values(x, vals)
    if index_dtype is not None:
        out._index_dtype = _dtypes.convert_dtype(index_dtype)
    return out


def coalesce(x, name=None):
    return x.coalesce()


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    out = torch.sum(x._data.to_dense(), dim=axis, keepdim=keepdim)
    if dtype is not None:
        out = out.to(_dtypes.convert_dtype(dtype))
    return Tensor(out)


def reshape(x, shape, name=None):
    return _from_dense(torch.reshape(x._data.to_dense(), tuple(shape)))


def slice(x, axes, starts, ends, name=None):
    out = x._data.to_dense()
    for ax, st, en in zip(axes, starts, ends):
        out = out[(_builtins.slice(None),) * (ax % out.dim())
                  + (_builtins.slice(st, en),)]
    return _from_dense(out)


def mv(x, vec, name=None):
    return Tensor(_spmm(x._data, _as_array(vec)))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y), dense."""
    prod = (_spmm(x._data, _dense(y)) if isinstance(x, SparseCooTensor)
            else _dense(x) @ _dense(y))
    return Tensor(beta * _dense(input) + alpha * prod)


def _mask_indices(mask):
    return mask._coo()._indices()


def masked_matmul(x, y, mask, name=None):
    """dense @ dense evaluated only at mask's stored indices (the reference
    sddmm): the rows of x and columns of y each entry needs, one dot
    product an entry."""
    xd, yd = _as_array(x), _as_array(y)
    idx = _mask_indices(mask)
    vals = (xd[idx[0]] * yd[:, idx[1]].T).sum(-1).to(xd.dtype)
    return SparseCooTensor(torch.sparse_coo_tensor(
        idx, vals, tuple(mask.shape),
        is_coalesced=mask._coo().is_coalesced()))


def mask_as(x, mask, name=None):
    """Dense x's values at mask's stored indices."""
    xd = _as_array(x)
    idx = _mask_indices(mask)
    return SparseCooTensor(torch.sparse_coo_tensor(
        idx, xd[tuple(idx)], tuple(mask.shape),
        is_coalesced=mask._coo().is_coalesced()))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized low-rank PCA (reference paddle.sparse.pca_lowrank):
    (U, S, V) with q components, from a Gaussian test matrix drawn from a
    generator seeded 0 (the JAX package draws its own from key 0)."""
    a = _dense(x).to(torch.float32)
    m, n = a.shape
    q = q if q is not None else min(6, m, n)
    if center:
        a = a - a.mean(dim=0, keepdim=True)
    gen = torch.Generator(device=a.device).manual_seed(0)
    omega = torch.randn((n, q), generator=gen, device=a.device)
    y = a @ omega
    for _ in range(niter):
        y = a @ (a.T @ y)
    qmat, _ = torch.linalg.qr(y)
    b = qmat.T @ a
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    return Tensor(qmat @ u_b), Tensor(s), Tensor(vt.T)
