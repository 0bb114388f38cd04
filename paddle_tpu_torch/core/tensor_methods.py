"""Tensor method attachment (`paddle_tpu/core/tensor_methods.py`): every
name of the reference's `tensor_method_func` list
(`python/paddle/tensor/__init__.py`) that the top-level namespace has
becomes a Tensor method. The list is the JAX package's, baked in. The
members with no top-level spelling that the JAX package writes here
(cholesky_inverse, ormqr, svd_lowrank, the resize_ / set_ storage
rebinds, create_tensor, the in-place acosh_ / asinh_ / atanh_) are ported
here too; names whose op is not ported yet are skipped until it is.
"""

from __future__ import annotations

import numpy as np
import torch

_METHOD_NAMES = [
    "abs", "abs_", "acos", "acos_", "acosh", "acosh_", "add", "add_",
    "add_n", "addmm", "addmm_", "all", "allclose", "amax", "amin", "angle",
    "any", "argmax", "argmin", "argsort", "as_complex", "as_real", "as_strided",
    "asin", "asin_", "asinh", "asinh_", "atan", "atan2", "atan_", "atanh",
    "atanh_", "atleast_1d", "atleast_2d", "atleast_3d", "baddbmm", "baddbmm_",
    "bernoulli_", "bincount", "bitwise_and", "bitwise_and_", "bitwise_invert",
    "bitwise_invert_", "bitwise_left_shift", "bitwise_left_shift_", "bitwise_not",
    "bitwise_not_", "bitwise_or", "bitwise_or_", "bitwise_right_shift",
    "bitwise_right_shift_", "bitwise_xor", "bitwise_xor_", "block_diag",
    "bmm", "broadcast_shape", "broadcast_tensors", "broadcast_to", "bucketize",
    "cast", "cast_", "cauchy_", "cauchy_", "cdist", "ceil", "ceil_",
    "cholesky", "cholesky_inverse", "cholesky_solve", "chunk", "clip",
    "clip_", "combinations", "concat", "cond", "conj", "copysign", "copysign_",
    "corrcoef", "cos", "cos_", "cosh", "cosh_", "count_nonzero", "cov",
    "create_parameter", "create_tensor", "cross", "cummax", "cummin",
    "cumprod", "cumprod_", "cumsum", "cumsum_", "cumulative_trapezoid",
    "deg2rad", "diag", "diag_embed", "diagflat", "diagonal", "diagonal_scatter",
    "diff", "digamma", "digamma_", "dist", "divide", "divide_", "dot",
    "dsplit", "eig", "eigvals", "eigvalsh", "equal", "equal_", "equal_all",
    "erf", "erfinv", "erfinv_", "exp", "exp_", "expand", "expand_as",
    "expm1", "exponential_", "flatten", "flatten_", "flip", "floor",
    "floor_", "floor_divide", "floor_divide_", "floor_mod", "floor_mod_",
    "fmax", "fmin", "frac", "frac_", "frexp", "gammainc", "gammainc_",
    "gammaincc", "gammaincc_", "gammaln", "gammaln_", "gather", "gather_nd",
    "gcd", "gcd_", "geometric_", "geometric_", "greater_equal", "greater_equal_",
    "greater_than", "greater_than_", "heaviside", "histogram", "histogram_bin_edges",
    "histogramdd", "householder_product", "hsplit", "hypot", "hypot_",
    "i0", "i0_", "i0e", "i1", "i1e", "imag", "increment", "index_add",
    "index_add_", "index_fill", "index_fill_", "index_put", "index_put_",
    "index_sample", "index_select", "inner", "inverse", "is_complex",
    "is_empty", "is_floating_point", "is_integer", "is_tensor", "isclose",
    "isfinite", "isin", "isinf", "isnan", "isneginf", "isposinf", "isreal",
    "istft", "kron", "kthvalue", "lcm", "lcm_", "ldexp", "ldexp_", "lerp",
    "lerp_", "less", "less_", "less_equal", "less_equal_", "less_than",
    "less_than_", "lgamma", "lgamma_", "log", "log10", "log10_", "log1p",
    "log1p_", "log2", "log2_", "log_", "log_normal_", "logaddexp", "logcumsumexp",
    "logical_and", "logical_and_", "logical_not", "logical_not_", "logical_or",
    "logical_or_", "logical_xor", "logical_xor_", "logit", "logit_",
    "logsumexp", "lstsq", "lu", "lu_unpack", "masked_fill", "masked_fill_",
    "masked_scatter", "masked_scatter_", "masked_select", "matmul", "matrix_power",
    "matrix_transpose", "max", "maximum", "mean", "median", "min", "minimum",
    "mm", "mod", "mod_", "mode", "moveaxis", "multi_dot", "multigammaln",
    "multigammaln_", "multinomial", "multiplex", "multiply", "multiply_",
    "mv", "nan_to_num", "nan_to_num_", "nanmean", "nanmedian", "nanquantile",
    "nansum", "neg", "neg_", "negative", "nextafter", "nonzero", "norm",
    "normal_", "normal_", "not_equal", "not_equal_", "numel", "ormqr",
    "outer", "pca_lowrank", "pinv", "polar", "polygamma", "polygamma_",
    "pow", "pow_", "prod", "put_along_axis", "put_along_axis_", "qr",
    "quantile", "rad2deg", "rank", "real", "reciprocal", "reciprocal_",
    "reduce_as", "remainder", "remainder_", "renorm", "renorm_", "repeat_interleave",
    "reshape", "reshape_", "resize_", "reverse", "roll", "rot90", "round",
    "round_", "rsqrt", "rsqrt_", "scale", "scale_", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "select_scatter", "set_", "sgn",
    "shape", "shard_index", "sigmoid", "sigmoid_", "sign", "signbit",
    "sin", "sin_", "sinc", "sinc_", "sinh", "sinh_", "slice", "slice_scatter",
    "solve", "sort", "split", "sqrt", "sqrt_", "square", "square_", "squeeze",
    "squeeze_", "stack", "stanh", "std", "stft", "strided_slice", "subtract",
    "subtract_", "sum", "svd_lowrank", "t", "t_", "take", "take_along_axis",
    "tan", "tan_", "tan_", "tanh", "tanh_", "tensor_split", "tensordot",
    "tile", "top_p_sampling", "topk", "trace", "transpose", "transpose",
    "transpose_", "trapezoid", "triangular_solve", "tril", "tril_", "triu",
    "triu_", "trunc", "trunc_", "unbind", "unflatten", "unfold", "uniform_",
    "unique", "unique_consecutive", "unsqueeze", "unsqueeze_", "unstack",
    "vander", "var", "view", "view_as", "vsplit", "where", "where_",
]


def install_tensor_methods():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.tensor import Tensor

    bound = 0
    for nm in _METHOD_NAMES:
        if hasattr(Tensor, nm):
            continue
        fn = getattr(paddle, nm, None)
        if callable(fn):
            setattr(Tensor, nm, fn)
            bound += 1

    from paddle_tpu_torch import signal as _signal

    if not hasattr(Tensor, "stft"):
        Tensor.stft = _signal.stft
        Tensor.istft = _signal.istft

    for nm, fn in {**_EXTRA, **_make_inplace_trig()}.items():
        if not hasattr(Tensor, nm):
            setattr(Tensor, nm, fn)
        if not hasattr(paddle, nm):
            setattr(paddle, nm, fn)
    return bound


def cholesky_inverse(x, upper=False, name=None):
    """inv(A) from its Cholesky factor (reference linalg.cholesky_inverse,
    2-D)."""
    from paddle_tpu_torch.core.tensor import apply

    return apply(lambda l: torch.cholesky_inverse(l, upper=upper), x,
                 _name="cholesky_inverse")


def ormqr(x, tau, other, left=True, transpose=False, name=None):
    """Apply the Q of a QR factorization (Householder reflectors in x,
    scales in tau) to `other` (reference linalg.ormqr), reflector by
    reflector, so the result has other's shape for any x."""
    from paddle_tpu_torch.core.tensor import apply

    def fn(a, t, y):
        m, k = a.shape[-2], t.shape[-1]
        rows = torch.arange(m, device=a.device)
        yy = y if left else y.transpose(-1, -2)
        # Q = H_0 ... H_(k-1): Q @ y applies them right to left, Q^T @ y left
        # to right; y @ Q = (Q^T y^T)^T flips which one is applied
        eff_transpose = transpose if left else not transpose
        order = range(k) if eff_transpose else range(k - 1, -1, -1)
        for i in order:
            v = torch.where(rows == i, 1.0,
                            torch.where(rows > i, a[:, i], 0.0)).to(a.dtype)
            yy = yy - t[i] * torch.outer(v, v @ yy)
        return yy if left else yy.transpose(-1, -2)

    return apply(fn, x, tau, other, _name="ormqr")


def svd_lowrank(x, q=None, niter=2, M=None, name=None):
    """Randomized thin SVD (reference linalg.svd_lowrank; Halko et al.):
    subspace iteration on a q-column Gaussian sketch drawn from the
    framework generator, then an exact SVD in the small space."""
    from paddle_tpu_torch.core.tensor import apply
    from paddle_tpu_torch.framework import random as _rng

    q = min(6 if q is None else q, x.shape[-2], x.shape[-1])
    d = x._data
    omega = torch.randn(tuple(d.shape[:-2]) + (d.shape[-1], q),
                        dtype=d.dtype, device=d.device,
                        generator=_rng.generator(d.device))
    args = [x] if M is None else [x, M]

    def fn(a, *m):
        am = a - m[0] if m else a
        amT = am.transpose(-1, -2)
        y = am @ omega
        for _ in range(niter):
            y = am @ (amT @ y)
        qmat, _ = torch.linalg.qr(y)
        b = qmat.transpose(-1, -2) @ am
        u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
        return [qmat @ u_b, s, vt.transpose(-1, -2)]

    return tuple(apply(fn, *args, _name="svd_lowrank"))


def resize_(x, shape, fill_zero=False, name=None):
    """In-place resize (reference Tensor.resize_): keep the leading numel,
    zero- (or repeat-) fill growth; a fill, so the history is cut."""
    new_n = int(np.prod(shape)) if shape else 1
    flat = x._data.detach().reshape(-1)
    if new_n <= flat.shape[0]:
        data = flat[:new_n].reshape(shape)
    elif flat.shape[0] == 0 or fill_zero:
        data = torch.cat([flat, flat.new_zeros(new_n - flat.shape[0])]) \
            .reshape(shape)
    else:
        reps = (new_n + flat.shape[0] - 1) // flat.shape[0]
        data = flat.repeat(reps)[:new_n].reshape(shape)
    return x._refill(data)


def set_(x, source=None, shape=None, name=None):
    """Rebind x's data to `source`'s (reference Tensor.set_); with no
    source x becomes a 0-size tensor."""
    from paddle_tpu_torch.core.tensor import Tensor, _as_torch

    if source is None:
        return x._refill(x._data.new_zeros((0,)))
    src = source._data if isinstance(source, Tensor) else \
        _as_torch(source, like=x._data)
    if shape is not None:
        src = src.reshape(shape)
    return x._refill(src)


def create_tensor(dtype, name=None, persistable=False):
    """reference tensor/creation.py create_tensor: an empty typed holder."""
    from paddle_tpu_torch.core.tensor import Tensor
    from paddle_tpu_torch.framework import device, dtypes

    return Tensor(torch.zeros((0,), dtype=dtypes.convert_dtype(dtype),
                              device=device.place()))


def _make_inplace_trig():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.ops_patch import make_inplace

    out = {}
    for nm in ("acosh", "asinh", "atanh"):
        fn = make_inplace(getattr(paddle, nm))
        fn.__name__ = nm + "_"
        out[nm + "_"] = fn
    return out


_EXTRA = {
    "cholesky_inverse": cholesky_inverse,
    "ormqr": ormqr,
    "svd_lowrank": svd_lowrank,
    "resize_": resize_,
    "set_": set_,
    "create_tensor": create_tensor,
}
