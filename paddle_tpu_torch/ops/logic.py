"""Comparison and logical ops (`paddle_tpu/ops/logic.py`; reference
`python/paddle/tensor/logic.py`). They go through `apply` like every op,
so the hooks later slices hang on it see them too."""

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply, to_tensor
from paddle_tpu_torch.ops._common import as_tensor as _as


def _cmp(tfn, name):
    def op(x, y, name=None):
        xt = x if isinstance(x, Tensor) else to_tensor(x)
        if isinstance(y, Tensor):
            return apply(tfn, xt, y, _name=op.__name__)
        return apply(lambda a: tfn(a, _as(y, a)), xt, _name=op.__name__)

    op.__name__ = name
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")


def logical_not(x, out=None, name=None):
    return apply(torch.logical_not, x, _name="logical_not")


def equal_all(x, y, name=None):
    def fn(a, b):
        same = a.shape == b.shape and bool(torch.equal(a, b.to(a.dtype)))
        return torch.tensor(same, device=a.device)

    return apply(fn, x, y, _name="equal_all")


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    rt, at = float(rtol), float(atol)
    return apply(lambda a, b: torch.tensor(
        torch.allclose(a, b, rtol=rt, atol=at, equal_nan=equal_nan),
        device=a.device), x, y, _name="allclose")


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    rt, at = float(rtol), float(atol)
    return apply(lambda a, b: torch.isclose(a, b, rtol=rt, atol=at,
                                            equal_nan=equal_nan), x, y,
                 _name="isclose")


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x, name=None):
    return apply(lambda a: torch.tensor(a.numel() == 0, device=a.device), x,
                 _name="is_empty")


def isreal(x, name=None):
    return apply(torch.isreal, x, _name="isreal")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
