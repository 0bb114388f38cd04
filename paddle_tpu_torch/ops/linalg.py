"""Linear algebra ops (`paddle_tpu/ops/linalg.py`; reference
`python/paddle/tensor/linalg.py`): products through torch.matmul / einsum
and decompositions through `torch.linalg`."""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply, apply_multi


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def fn(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply(fn, x, y, _name="matmul")


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return apply(torch.matmul, x, y, _name="bmm")


def dot(x, y, name=None):
    return apply(lambda a, b: (a * b).sum(-1), x, y, _name="dot")


def mv(x, vec, name=None):
    return apply(torch.matmul, x, vec, _name="mv")


def outer(x, y, name=None):
    return apply(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)), x,
                 y, _name="outer")


def _find_dim3(x):
    for i, s in enumerate(x.shape):
        if s == 3:
            return i
    return -1


def cross(x, y, axis=9, name=None):
    ax = axis if axis != 9 else _find_dim3(x)
    return apply(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y,
                 _name="cross")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 input, x, y, _name="addmm")


def einsum(equation, *operands):
    ops = list(operands[0]) if len(operands) == 1 and \
        isinstance(operands[0], (list, tuple)) else list(operands)
    return apply_multi(lambda arrs: torch.einsum(equation, *arrs), ops,
                       _name="einsum")


def _pnorm(a, p, dim, keepdim):
    if p == "fro" or p == 2:
        return torch.sqrt(torch.sum(a * a, dim, keepdim))
    if p == np.inf or p == "inf":
        return torch.amax(torch.abs(a), dim, keepdim)
    if p == -np.inf:
        return torch.amin(torch.abs(a), dim, keepdim)
    if p == 0:
        return torch.sum((a != 0).to(a.dtype), dim, keepdim)
    if p == 1:
        return torch.sum(torch.abs(a), dim, keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim, keepdim),
                     1.0 / p)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The reference's entrywise norms: over all entries (axis None), or
    along `axis`; p 'fro', inf, -inf, 0, 1 or any power."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p is None:
        p = "fro" if (ax is None or isinstance(ax, tuple)) else 2

    def fn(a):
        if ax is None:
            return _pnorm(a.reshape(-1), 2 if p == "fro" else p, 0, False)
        dim = ax if isinstance(ax, tuple) else (ax,)
        return _pnorm(a, p, dim, keepdim)

    return apply(fn, x, _name="norm")


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return norm(x, p=p, axis=list(axis), keepdim=keepdim)


def dist(x, y, p=2, name=None):
    return norm(apply(torch.sub, x, y, _name="sub"), p=float(p))


def cond(x, p=None, name=None):
    return apply(lambda a: torch.linalg.cond(a, p), x, _name="cond")


def det(x, name=None):
    return apply(torch.linalg.det, x, _name="det")


def slogdet(x, name=None):
    return apply(lambda a: torch.stack(list(torch.linalg.slogdet(a))), x,
                 _name="slogdet")


def inverse(x, name=None):
    return apply(torch.linalg.inv, x, _name="inverse")


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply(lambda a: torch.linalg.pinv(a, rtol=rcond,
                                             hermitian=hermitian), x,
                 _name="pinv")


def cholesky(x, upper=False, name=None):
    return apply(lambda a: torch.linalg.cholesky(a, upper=upper), x,
                 _name="cholesky")


def cholesky_solve(x, y, upper=False, name=None):
    return apply(lambda b, f: torch.cholesky_solve(b, f, upper=upper), x, y,
                 _name="cholesky_solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def fn(a, b):
        if transpose:
            a, up = a.transpose(-1, -2), not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)

    return apply(fn, x, y, _name="triangular_solve")


def solve(x, y, name=None):
    return apply(torch.linalg.solve, x, y, _name="solve")


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values), numpy's contract: the
    residuals are the squared column norms of y - x @ solution when x is
    tall and of full rank, else empty."""
    a, b = x._data, y._data
    sol = torch.linalg.pinv(a, rtol=rcond) @ b if rcond is not None else \
        torch.linalg.pinv(a) @ b
    sv = torch.linalg.svdvals(a)
    rank = torch.linalg.matrix_rank(a, rtol=rcond) if rcond is not None \
        else torch.linalg.matrix_rank(a)
    m, n = a.shape[-2], a.shape[-1]
    if m > n and int(rank) == n:
        res = torch.sum((a @ sol - b) ** 2, -2)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return Tensor(sol), Tensor(res), Tensor(rank), Tensor(sv)


def qr(x, mode="reduced", name=None):
    return tuple(apply(lambda a: list(torch.linalg.qr(a, mode=mode)), x,
                       _name="qr"))


def svd(x, full_matrices=False, name=None):
    def fn(a):
        u, s, vh = torch.linalg.svd(a, full_matrices=full_matrices)
        return [u, s, vh.transpose(-1, -2)]

    return tuple(apply(fn, x, _name="svd"))


def eig(x, name=None):
    return tuple(apply(lambda a: list(torch.linalg.eig(a)), x, _name="eig"))


def eigh(x, UPLO="L", name=None):
    return tuple(apply(lambda a: list(torch.linalg.eigh(a, UPLO)), x,
                       _name="eigh"))


def eigvals(x, name=None):
    return apply(torch.linalg.eigvals, x, _name="eigvals")


def eigvalsh(x, UPLO="L", name=None):
    return apply(lambda a: torch.linalg.eigvalsh(a, UPLO), x,
                 _name="eigvalsh")


def matrix_power(x, n, name=None):
    return apply(lambda a: torch.linalg.matrix_power(a, n), x,
                 _name="matrix_power")


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return Tensor(torch.linalg.matrix_rank(x._data.detach(), rtol=tol,
                                           hermitian=hermitian))


def multi_dot(x, name=None):
    return apply_multi(torch.linalg.multi_dot, list(x), _name="multi_dot")


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """np.histogram's counts over `bins` equal bins of [min, max] (the
    data's range when both are 0), the last bin closed; int64 counts, or
    float32 with weights or density."""
    a = input._data.detach().reshape(-1)
    lo, hi = (a.min().item(), a.max().item()) if (min == 0 and max == 0) \
        else (float(min), float(max))
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    af = a.double()
    pos = torch.floor((af - lo) / (hi - lo) * bins).long()
    pos = torch.where(af == hi, bins - 1, pos)
    keep = (af >= lo) & (af <= hi)
    w = weight._data.detach().reshape(-1).double() if weight is not None \
        else torch.ones_like(af)
    hist = torch.zeros(bins, dtype=torch.float64, device=a.device)
    hist = hist.index_add(0, pos[keep], w[keep])
    if density:
        hist = hist / (hist.sum() * (hi - lo) / bins)
    if density or weight is not None:
        return Tensor(hist.float())
    return Tensor(hist.round().long())


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """np.histogramdd on the host; (hist, edges) in float32."""
    arr = x.numpy()
    w = weights.numpy() if weights is not None else None
    rng = None if ranges is None else \
        [tuple(ranges[2 * i:2 * i + 2]) for i in range(len(ranges) // 2)] \
        if not isinstance(ranges[0], (list, tuple)) else ranges
    hist, edges = np.histogramdd(arr, bins=bins, range=rng, density=density,
                                 weights=w)
    dev = x._data.device
    return (Tensor(torch.from_numpy(hist.astype(np.float32)).to(dev)),
            [Tensor(torch.from_numpy(e.astype(np.float32)).to(dev))
             for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    w = weights._data.detach() if weights is not None else None
    return Tensor(torch.bincount(x._data.detach(), weights=w,
                                 minlength=minlength))


def corrcoef(x, rowvar=True, name=None):
    return apply(lambda a: torch.corrcoef(a if rowvar else a.T), x,
                 _name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw = fweights._data.detach() if fweights is not None else None
    aw = aweights._data.detach() if aweights is not None else None
    return apply(lambda a: torch.cov(a if rowvar else a.T,
                                     correction=1 if ddof else 0,
                                     fweights=fw, aweights=aw), x,
                 _name="cov")


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU, pivots): LAPACK's packed factors and 1-based int32 pivots."""
    lu_, piv, info = torch.linalg.lu_factor_ex(x._data)
    if get_infos:
        return Tensor(lu_), Tensor(piv), Tensor(info)
    return Tensor(lu_), Tensor(piv)


def matrix_exp(x, name=None):
    return apply(torch.linalg.matrix_exp, x, _name="matrix_exp")


def householder_product(x, tau, name=None):
    return apply(torch.linalg.householder_product, x, tau,
                 _name="householder_product")


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The top-q singular triplets of x (centred over rows), from an exact
    SVD as the JAX package computes them."""
    def fn(a):
        k = q if q is not None else min(6, a.shape[-2], a.shape[-1])
        if center:
            a = a - a.mean(-2, keepdim=True)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        return [u[..., :k], s[..., :k], vh.transpose(-1, -2)[..., :k]]

    return tuple(apply(fn, x, _name="pca_lowrank"))


def baddbmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta * input + alpha * (x @ y), batched (reference ops.yaml
    baddbmm)."""
    return apply(lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 input, x, y, _name="baddbmm")


def svdvals(x, name=None):
    return apply(torch.linalg.svdvals, x, _name="svdvals")


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) of packed LU factors with A = P L U (reference ops.yaml
    lu_unpack); the parts not asked for are None."""
    p, l, u = torch.lu_unpack(x._data, y._data.to(torch.int32),
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (Tensor(p) if unpack_pivots else None,
            Tensor(l) if unpack_ludata else None,
            Tensor(u) if unpack_ludata else None)


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
