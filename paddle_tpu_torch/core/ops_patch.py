"""Operators, indexing and the in-place variants on Tensor
(`paddle_tpu/core/ops_patch.py`; reference
`paddle/fluid/pybind/eager_math_op_patch.cc` and
`python/paddle/base/dygraph/math_op_patch.py`).

`x[i] = v` and every `op_` variant compute out of place and rebind x's
data (`Tensor._rebind`), so the chain rule runs through the op: the JAX
package's `_setitem` points x's node at a node whose input is x itself,
and its arithmetic `*_` methods keep x's old node, and both lose the op
from backward. The in-place random fills cut the history (`_refill`).
"""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.ops import linalg as _la
from paddle_tpu_torch.ops import logic as _l
from paddle_tpu_torch.ops import math as _m


def _coerce_index(item, device):
    """Tensor, list and numpy indices inside an index as torch tensors."""
    if isinstance(item, tuple):
        return tuple(_coerce_index(i, device) for i in item)
    if isinstance(item, Tensor):
        return item._data
    if isinstance(item, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(item), device=device)
    return item


def _index_tensors(item):
    """(item with each Tensor in it replaced by its slot number, the
    Tensors): the index Tensors are inputs of the op, not closures."""
    found = []

    def walk(i):
        if isinstance(i, tuple):
            return tuple(walk(j) for j in i)
        if isinstance(i, Tensor):
            found.append(i)
            return _Slot(len(found) - 1)
        return i

    return walk(item), found


class _Slot:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


def _fill_index(item, idx_datas, device):
    if isinstance(item, tuple):
        return tuple(_fill_index(i, idx_datas, device) for i in item)
    if isinstance(item, _Slot):
        return idx_datas[item.n]
    return _coerce_index(item, device)


def _getitem(self, item):
    item, found = _index_tensors(item)
    if not found:
        idx = _coerce_index(item, self._data.device)
        return apply(lambda a: a[idx], self, _name="getitem")
    return apply(lambda a, *ix: a[_fill_index(item, ix, a.device)], self,
                 *found, _name="getitem")


def _setitem(self, item, value):
    a = self._data
    idx = _coerce_index(item, a.device)
    v = value._data if isinstance(value, Tensor) else \
        torch.as_tensor(np.asarray(value), device=a.device)
    out = a.clone()
    out[idx] = v.to(a.dtype)
    self._rebind(out)


def _bool_or(logical, bitwise):
    def op(s, o=None):
        if s.dtype == torch.bool:
            return logical(s) if o is None else logical(s, o)
        return bitwise(s) if o is None else bitwise(s, o)

    return op


def install():
    T = Tensor
    T.__getitem__ = _getitem
    T.__setitem__ = _setitem

    T.__add__ = lambda s, o: _m.add(s, o)
    T.__radd__ = lambda s, o: _m.add(o, s)
    T.__sub__ = lambda s, o: _m.subtract(s, o)
    T.__rsub__ = lambda s, o: _m.subtract(o, s)
    T.__mul__ = lambda s, o: _m.multiply(s, o)
    T.__rmul__ = lambda s, o: _m.multiply(o, s)
    T.__truediv__ = lambda s, o: _m.divide(s, o)
    T.__rtruediv__ = lambda s, o: _m.divide(o, s)
    T.__floordiv__ = lambda s, o: _m.floor_divide(s, o)
    T.__rfloordiv__ = lambda s, o: _m.floor_divide(o, s)
    T.__mod__ = lambda s, o: _m.mod(s, o)
    T.__rmod__ = lambda s, o: _m.mod(o, s)
    T.__pow__ = lambda s, o: _m.pow(s, o)
    T.__rpow__ = lambda s, o: _m.pow(o, s)
    T.__neg__ = lambda s: _m.neg(s)
    T.__abs__ = lambda s: _m.abs(s)
    T.__matmul__ = lambda s, o: _la.matmul(s, o)
    T.__rmatmul__ = lambda s, o: _la.matmul(o, s)
    T.__invert__ = _bool_or(_l.logical_not, _m.bitwise_not)
    T.__and__ = _bool_or(_l.logical_and, _m.bitwise_and)
    T.__or__ = _bool_or(_l.logical_or, _m.bitwise_or)
    T.__xor__ = _bool_or(_l.logical_xor, _m.bitwise_xor)
    T.__eq__ = lambda s, o: _l.equal(s, o)
    T.__ne__ = lambda s, o: _l.not_equal(s, o)
    T.__lt__ = lambda s, o: _l.less_than(s, o)
    T.__le__ = lambda s, o: _l.less_equal(s, o)
    T.__gt__ = lambda s, o: _l.greater_than(s, o)
    T.__ge__ = lambda s, o: _l.greater_equal(s, o)


def make_inplace(base_fn, allow_dtype_change=False):
    """An in-place `op_` variant of `base_fn`: compute the op out of place
    on x and rebind x's data to the result (`Tensor._rebind`), so backward
    runs through the op. The op's dtype must be x's unless
    `allow_dtype_change` (the comparisons, which write bool)."""
    def op_(x, *args, **kwargs):
        out = base_fn(x, *args, **kwargs)
        out_t = out[0] if isinstance(out, (tuple, list)) else out
        if not allow_dtype_change and out_t._data.dtype != x._data.dtype:
            raise ValueError(
                f"in-place {base_fn.__name__}_ would change dtype "
                f"{x.dtype} -> {out_t._data.dtype}; use the out-of-place "
                "form")
        return x._rebind(out_t._data)

    return op_


# the JAX package's `op_` list (`_install_inplace_variants`); the names whose
# base op is not ported yet are skipped until it is
INPLACE_NAMES = [
    "abs", "acos", "asin", "atan", "ceil", "clip", "cos", "cosh",
    "cumprod", "cumsum", "digamma", "divide", "equal", "erf", "exp",
    "expm1", "flatten", "floor", "floor_divide", "floor_mod", "frac",
    "gammainc", "gammaincc", "gammaln", "gcd", "greater_equal",
    "greater_than", "hypot", "i0", "index_add", "index_fill",
    "index_put", "lcm", "ldexp", "less_equal", "less_than", "lgamma",
    "log", "log10", "log1p", "log2", "logical_and", "logical_not",
    "logical_or", "logical_xor", "logit", "masked_fill",
    "masked_scatter", "maximum", "minimum", "mod", "multigammaln",
    "multiply", "nan_to_num", "neg", "not_equal", "polygamma", "pow",
    "put_along_axis", "reciprocal", "remainder", "renorm", "round",
    "rsqrt", "scale", "scatter", "sigmoid", "sign", "sin", "sinc",
    "sinh", "sqrt", "square", "squeeze", "stanh", "subtract", "t",
    "tan", "tanh", "tril", "triu", "trunc", "unsqueeze",
    "add", "bitwise_and", "bitwise_invert", "bitwise_left_shift",
    "bitwise_not", "bitwise_or", "bitwise_right_shift", "bitwise_xor",
    "copysign", "erfinv", "fill_diagonal", "flip", "lerp", "less",
    "reshape", "transpose", "unique", "addmm", "baddbmm",
]
BOOL_OUT = {
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "less", "logical_and", "logical_or", "logical_not",
    "logical_xor",
}


def _install_inplace_variants():
    """The reference's `op_` in-place variants as `paddle.op_` and
    `Tensor.op_`, `where_`, and the in-place random fills (bernoulli_,
    cauchy_, geometric_, log_normal_; normal_, uniform_, exponential_ are
    the Tensor's own) with `paddle.log_normal`."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import dtypes
    from paddle_tpu_torch.framework import random as _rng
    from paddle_tpu_torch.ops._common import int_shape

    for nm in INPLACE_NAMES:
        base = getattr(paddle, nm, None)
        if base is None or hasattr(paddle, nm + "_"):
            continue
        fn = make_inplace(base, allow_dtype_change=nm in BOOL_OUT)
        fn.__name__ = nm + "_"
        setattr(paddle, nm + "_", fn)
        if not hasattr(Tensor, nm + "_"):
            setattr(Tensor, nm + "_", fn)

    def where_(condition, x, y, name=None):
        """In-place where: rebinds x (the second argument), not the
        condition."""
        return x._rebind(paddle.where(condition, x, y)._data)

    paddle.where_ = where_
    if not hasattr(Tensor, "where_"):
        Tensor.where_ = lambda x, condition, y, name=None: where_(
            condition, x, y)

    def _fill(x, sample):
        d = x._data
        return x._refill(sample(torch.empty(d.shape, dtype=torch.float32,
                                            device=d.device),
                                _rng.generator(d.device)).to(d.dtype))

    def bernoulli_(x, p=0.5, name=None):
        return _fill(x, lambda b, g: b.bernoulli_(p, generator=g))

    def cauchy_(x, loc=0, scale=1, name=None):
        return _fill(x, lambda b, g: b.cauchy_(loc, scale, generator=g))

    def geometric_(x, probs, name=None):
        return _fill(x, lambda b, g: b.geometric_(probs, generator=g))

    def log_normal_(x, mean=1.0, std=2.0, name=None):
        return _fill(x, lambda b, g: b.log_normal_(mean, std, generator=g))

    def log_normal(mean=1.0, std=2.0, shape=None, dtype="float32",
                   name=None):
        from paddle_tpu_torch.framework import device as _device

        dev = _device.place()
        out = torch.empty(int_shape(shape or ()), dtype=torch.float32,
                          device=dev)
        out.log_normal_(mean, std, generator=_rng.generator(dev))
        return Tensor(out.to(dtypes.convert_dtype(dtype)))

    # normal_, uniform_ and exponential_ are the Tensor's own fills
    # (`core/tensor.py`; exponential_ also `ops/creation.py`)
    for fn in (bernoulli_, Tensor.normal_, Tensor.uniform_, cauchy_,
               geometric_, log_normal_):
        if not hasattr(paddle, fn.__name__):
            setattr(paddle, fn.__name__, fn)
        if not hasattr(Tensor, fn.__name__):
            setattr(Tensor, fn.__name__, fn)
    if not hasattr(paddle, "log_normal"):
        paddle.log_normal = log_normal
