"""paddle.linalg (`paddle_tpu/linalg.py`; reference `python/paddle/
linalg.py`): the canonical `paddle.linalg.*` names, re-exported from the
port's `ops/linalg.py`, plus `inv`."""

from paddle_tpu_torch.ops.linalg import (  # noqa: F401
    baddbmm, bincount, cholesky, cholesky_solve, cond, corrcoef, cov, cross,
    det, dist, dot, eig, eigh, eigvals, eigvalsh, histogram, histogramdd,
    inverse, lstsq, lu, lu_unpack, matmul, matrix_exp, matrix_norm,
    matrix_power, matrix_rank, multi_dot, norm, outer, pinv, qr, slogdet,
    solve, svd, svdvals, triangular_solve, vector_norm,
)

inv = inverse

__all__ = [
    "baddbmm", "bincount", "cholesky", "cholesky_solve", "cond", "corrcoef",
    "cov", "cross", "det", "dist", "dot", "eig", "eigh", "eigvals",
    "eigvalsh", "histogram", "histogramdd", "inv", "inverse", "lstsq", "lu",
    "lu_unpack", "matmul", "matrix_exp", "matrix_norm", "matrix_power",
    "matrix_rank", "multi_dot", "norm", "outer", "pinv", "qr", "slogdet",
    "solve", "svd", "svdvals", "triangular_solve", "vector_norm",
]
