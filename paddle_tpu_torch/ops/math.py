"""Elementwise math and reductions (`paddle_tpu/ops/math.py`; reference
`python/paddle/tensor/math.py`, `python/paddle/tensor/ops.py`).

Reductions follow Paddle's dtypes: `sum` and `prod` of an integer tensor
give int64, `mean`, `std`, `var`, `median` and `quantile` of one give the
default float; index outputs (`cummax`, `cummin`) are int64.
"""

import builtins as _builtins

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply, apply_multi, to_tensor
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.ops._common import as_tensor as _as
from paddle_tpu_torch.ops._common import axes as _axes
from paddle_tpu_torch.ops._common import dims as _dims
from paddle_tpu_torch.ops._common import raw as _raw
from paddle_tpu_torch.ops._common import scalar as _scalar

# --------------------------------------------------------------------------
# factories
# --------------------------------------------------------------------------


def _float(a):
    """`a` in the default float dtype when it is not floating already."""
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return a
    return a.to(_dtypes.default_float())


def _unary(tfn, op_name):
    def op(x, name=None):
        return apply(tfn, x, _name=op_name)

    op.__name__ = op_name
    return op


def _binary(tfn, op_name):
    def op(x, y, name=None):
        if isinstance(x, Tensor) and isinstance(y, Tensor):
            return apply(tfn, x, y, _name=op_name)
        if isinstance(x, Tensor):
            return apply(lambda a: tfn(a, _as(y, a)), x, _name=op_name)
        if isinstance(y, Tensor):
            return apply(lambda b: tfn(_as(x, b), b), y, _name=op_name)
        xt = to_tensor(x)
        return apply(lambda a: tfn(a, _as(y, a)), xt, _name=op_name)

    op.__name__ = op_name
    return op


# --------------------------------------------------------------------------
# unary
# --------------------------------------------------------------------------

exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
square = _unary(torch.square, "square")
abs = _unary(torch.abs, "abs")
sign = _unary(torch.sign, "sign")
neg = _unary(torch.neg, "neg")
negative = neg
reciprocal = _unary(lambda a: torch.reciprocal(_float(a)), "reciprocal")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")
trunc = _unary(torch.trunc, "trunc")
frac = _unary(lambda a: a - torch.trunc(a), "frac")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
asinh = _unary(torch.asinh, "asinh")
acosh = _unary(torch.acosh, "acosh")
atanh = _unary(torch.atanh, "atanh")
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
sigmoid = _unary(torch.sigmoid, "sigmoid")
logit = _unary(torch.logit, "logit")
digamma = _unary(torch.digamma, "digamma")
lgamma = _unary(torch.lgamma, "lgamma")
i0 = _unary(torch.special.i0, "i0")
i1 = _unary(torch.special.i1, "i1")
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")
angle = _unary(torch.angle, "angle")
conj = _unary(torch.conj_physical, "conj")
real = _unary(torch.real, "real")
imag = _unary(lambda a: torch.imag(a) if a.is_complex()
              else torch.zeros_like(a), "imag")
deg2rad = _unary(torch.deg2rad, "deg2rad")
rad2deg = _unary(torch.rad2deg, "rad2deg")
exponent = _unary(lambda a: torch.floor(torch.log2(torch.abs(a))),
                  "exponent")

# --------------------------------------------------------------------------
# binary
# --------------------------------------------------------------------------

add = _binary(torch.add, "add")
subtract = _binary(torch.sub, "subtract")
multiply = _binary(torch.mul, "multiply")
divide = _binary(torch.true_divide, "divide")
floor_divide = _binary(torch.floor_divide, "floor_divide")
mod = _binary(torch.remainder, "mod")
remainder = mod
floor_mod = mod
pow = _binary(torch.pow, "pow")
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(torch.fmax, "fmax")
fmin = _binary(torch.fmin, "fmin")
atan2 = _binary(torch.atan2, "atan2")
hypot = _binary(torch.hypot, "hypot")
logaddexp = _binary(torch.logaddexp, "logaddexp")
copysign = _binary(torch.copysign, "copysign")
nextafter = _binary(torch.nextafter, "nextafter")
ldexp = _binary(lambda a, b: a * torch.pow(2.0, b).to(a.dtype)
                if a.dtype.is_floating_point else a * (2 ** b), "ldexp")
heaviside = _binary(lambda a, b: torch.heaviside(a, b.to(a.dtype)),
                    "heaviside")
gcd = _binary(torch.gcd, "gcd")
lcm = _binary(torch.lcm, "lcm")
inner = _binary(torch.inner, "inner")
outer = _binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                "outer")
kron = _binary(torch.kron, "kron")

bitwise_and = _binary(torch.bitwise_and, "bitwise_and")
bitwise_or = _binary(torch.bitwise_or, "bitwise_or")
bitwise_xor = _binary(torch.bitwise_xor, "bitwise_xor")
bitwise_not = _unary(torch.bitwise_not, "bitwise_not")
bitwise_left_shift = _binary(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _binary(torch.bitwise_right_shift,
                              "bitwise_right_shift")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    s = _scalar(scale)
    if bias_after_scale:
        return apply(lambda a: a * s + bias, x, _name="scale")
    return apply(lambda a: (a + bias) * s, x, _name="scale")


def clip(x, min=None, max=None, name=None):
    mn, mx = _scalar(min), _scalar(max)
    if mn is None and mx is None:
        return apply(torch.clone, x, _name="clip")
    return apply(lambda a: torch.clamp(a, mn, mx), x, _name="clip")


def lerp(x, y, weight, name=None):
    if isinstance(weight, Tensor):
        return apply(lambda a, b, w: a + w * (b - a), x, y, weight,
                     _name="lerp")
    return apply(lambda a, b: a + weight * (b - a), x, y, _name="lerp")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda a: scale_b * torch.tanh(scale_a * a), x,
                 _name="stanh")


def multiplex(inputs, index, name=None):
    def fn(ins, idx):
        rows = torch.arange(ins[0].shape[0], device=idx.device)
        return torch.stack(ins, 0)[idx.reshape(-1).long(), rows]

    return apply_multi(fn, list(inputs), index, _name="multiplex")


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(lambda a: torch.nan_to_num(a, nan, posinf, neginf), x,
                 _name="nan_to_num")


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    dt = _dtypes.convert_dtype(dtype)
    return apply(lambda a: torch.sum(a, _dims(axis, a.dim()), keepdim,
                                     dtype=dt), x, _name="sum")


def mean(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.mean(_float(a), _dims(axis, a.dim()),
                                      keepdim), x, _name="mean")


def max(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.amax(a, _dims(axis, a.dim()), keepdim), x,
                 _name="max")


def min(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.amin(a, _dims(axis, a.dim()), keepdim), x,
                 _name="min")


def _prod(a, axis, keepdim, dtype):
    if dtype is not None:
        a = a.to(dtype)
    if axis is None:
        out = torch.prod(a)
        return out.reshape((1,) * a.dim()) if keepdim else out
    for d in sorted((d % a.dim() for d in _dims(axis, a.dim())),
                    reverse=True):
        a = torch.prod(a, d, keepdim=keepdim)
    return a


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    dt = _dtypes.convert_dtype(dtype)
    return apply(lambda a: _prod(a, _axes(axis), keepdim, dt), x,
                 _name="prod")


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.all(a, _dims(axis, a.dim()), keepdim), x,
                 _name="all")


def any(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.any(a, _dims(axis, a.dim()), keepdim), x,
                 _name="any")


def logsumexp(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.logsumexp(a, _dims(axis, a.dim()), keepdim),
                 x, _name="logsumexp")


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return apply(lambda a: torch.nansum(a, _dims(axis, a.dim()), keepdim),
                 x, _name="nansum")


def nanmean(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: torch.nanmean(_float(a), _dims(axis, a.dim()),
                                         keepdim), x, _name="nanmean")


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def fn(a):
        return torch.sum(a != 0, _dims(axis, a.dim()), keepdim,
                         dtype=torch.int64)

    return apply(fn, x, _name="count_nonzero")


def cumsum(x, axis=None, dtype=None, name=None):
    dt = _dtypes.convert_dtype(dtype)
    if axis is None:
        return apply(lambda a: torch.cumsum(a.reshape(-1), 0, dtype=dt), x,
                     _name="cumsum")
    return apply(lambda a: torch.cumsum(a, int(axis), dtype=dt), x,
                 _name="cumsum")


def cumprod(x, dim=None, dtype=None, name=None):
    dt = _dtypes.convert_dtype(dtype)
    if dim is None:
        return apply(lambda a: torch.cumprod(a.reshape(-1), 0, dtype=dt), x,
                     _name="cumprod")
    return apply(lambda a: torch.cumprod(a, int(dim), dtype=dt), x,
                 _name="cumprod")


def _cum_extreme(tfn, x, axis, dtype):
    dt = _dtypes.convert_dtype(dtype)

    def fn(a):
        if axis is None:
            a, ax = a.reshape(-1), 0
        else:
            ax = int(axis)
        v, i = tfn(a, ax)
        return v, i.to(dt)

    return tuple(apply(fn, x, _name=tfn.__name__))


def cummax(x, axis=None, dtype="int64", name=None):
    """(running max, the index it came from) along `axis`; None flattens."""
    return _cum_extreme(torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


def logcumsumexp(x, axis=None, name=None):
    if axis is None:
        return apply(lambda a: torch.logcumsumexp(a.reshape(-1), 0), x,
                     _name="logcumsumexp")
    return apply(lambda a: torch.logcumsumexp(a, int(axis)), x,
                 _name="logcumsumexp")


def _quantile_dims(a, axis, q, keepdim, qfn, interpolation="linear"):
    """torch.quantile over several dims: move them last, flatten, reduce,
    and restore kept dims as size 1."""
    a = _float(a)
    qt = q if isinstance(q, torch.Tensor) else \
        torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if axis is None:
        out = qfn(a.reshape(-1), qt, dim=0, interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape + (1,) * a.dim())
        return out
    ds = sorted(d % a.dim() for d in _dims(axis, a.dim()))
    rest = [d for d in range(a.dim()) if d not in ds]
    moved = a.permute(rest + ds).reshape([a.shape[d] for d in rest] + [-1])
    out = qfn(moved, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        shape = list(out.shape[:out.dim() - len(rest)]) + \
            [1 if d in ds else a.shape[d] for d in range(a.dim())]
        out = out.reshape(shape)
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The mean of the two middle values for an even count (`mode='avg'`,
    as the JAX package's `jnp.median`)."""
    return apply(lambda a: _quantile_dims(a, axis, 0.5, keepdim,
                                          torch.quantile), x, _name="median")


def nanmedian(x, axis=None, keepdim=False, name=None):
    return apply(lambda a: _quantile_dims(a, axis, 0.5, keepdim,
                                          torch.nanquantile), x,
                 _name="nanmedian")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return apply(lambda a: _quantile_dims(a, axis, q, keepdim,
                                          torch.quantile, interpolation), x,
                 _name="quantile")


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda a: torch.std(_float(a), _dims(axis, a.dim()),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x, _name="std")


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return apply(lambda a: torch.var(_float(a), _dims(axis, a.dim()),
                                     correction=1 if unbiased else 0,
                                     keepdim=keepdim), x, _name="var")


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1),
                 x, _name="trace")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    pre = prepend._data if isinstance(prepend, Tensor) else prepend
    app = append._data if isinstance(append, Tensor) else append

    def fn(a):
        p = None if pre is None else _as(pre, a)
        q = None if app is None else _as(app, a)
        return torch.diff(a, n, axis, p, q)

    return apply(fn, x, _name="diff")


def increment(x, value=1.0, name=None):
    return x._rebind(x._data + value)


def accuracy_check(x, y, fn_name="", rtol=1e-5, atol=1e-8, equal_nan=False):
    """Cross-run tensor comparison op (reference `ops.yaml:31`
    accuracy_check)."""
    ok = torch.allclose(x._data, y._data, rtol=rtol, atol=atol,
                        equal_nan=equal_nan)
    if not ok:
        raise AssertionError(f"accuracy_check failed for {fn_name}")
    return Tensor(torch.tensor(ok, device=x._data.device))


# -- special functions (reference ops.yaml gammaln/gammaincc/polygamma/i0e/i1e)
gammaln = _unary(torch.lgamma, "gammaln")
i0e = _unary(torch.special.i0e, "i0e")
i1e = _unary(torch.special.i1e, "i1e")


def gammainc(x, y, name=None):
    return apply(torch.special.gammainc, x, y, _name="gammainc")


def gammaincc(x, y, name=None):
    return apply(torch.special.gammaincc, x, y, _name="gammaincc")


def polygamma(x, n, name=None):
    return apply(lambda a: torch.polygamma(int(n), a), x, _name="polygamma")


def add_n(inputs, name=None):
    """Elementwise sum of a tensor list (reference ops.yaml add_n)."""
    if isinstance(inputs, Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = apply(torch.add, out, t, _name="add_n")
    return out


def reduce_as(x, target, name=None):
    """Sum-reduce x down to target's shape (reference ops.yaml reduce_as)."""
    tshape = tuple(target.shape) if hasattr(target, "shape") else \
        tuple(target)

    def fn(a):
        extra = a.dim() - len(tshape)
        if extra > 0:
            a = torch.sum(a, tuple(range(extra)))
        ds = tuple(i for i, (d, t) in enumerate(zip(a.shape, tshape))
                   if d != t and t == 1)
        if ds:
            a = torch.sum(a, ds, keepdim=True)
        return a

    return apply(fn, x, _name="reduce_as")


def clip_by_norm(x, max_norm, name=None):
    """Scale x so its l2 norm is at most max_norm (ops.yaml clip_by_norm)."""
    def fn(a):
        n = torch.sqrt(torch.sum(torch.square(a.float())))
        coef = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
        return (a * coef).to(a.dtype)

    return apply(fn, x, _name="clip_by_norm")


def renorm(x, p, axis, max_norm, name=None):
    """Renormalize slices along `axis` to p-norm <= max_norm (ops.yaml
    renorm)."""
    def fn(a):
        ax = axis % a.dim()
        red = tuple(i for i in range(a.dim()) if i != ax)
        norms = torch.sum(torch.abs(a.float()) ** p, red,
                          keepdim=True) ** (1.0 / p)
        coef = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
        return (a * coef).to(a.dtype)

    return apply(fn, x, _name="renorm")


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a: torch.diagonal(a, offset, axis1, axis2), x,
                 _name="diagonal")


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched diagonal matrices from the last dim (ops.yaml diag_embed)."""
    return apply(lambda a: torch.diag_embed(a, offset, dim1, dim2), input,
                 _name="diag_embed")


def _diag_positions(rows, cols, offset):
    n = _builtins.max(_builtins.min(rows, cols) - _builtins.abs(offset), 0)
    idx = torch.arange(n)
    return idx + _builtins.max(-offset, 0), idx + _builtins.max(offset, 0)


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """x with its diagonal set (ops.yaml fill_diagonal; the in-place twin is
    fill_diagonal_): 2-D fills the (offset) diagonal, wrap=True continues it
    every n+1 rows on a tall matrix (numpy's flat stride); ndim > 2 needs
    equal dims and fills x[i, i, ..., i]."""
    def fn(a):
        out = a.clone()
        if a.dim() == 2:
            m, n = a.shape
            if offset == 0:
                stop = m * n if (wrap and m > n) else \
                    _builtins.min(m, n) * (n + 1)
                pos = torch.arange(0, stop, n + 1, device=a.device)
                flat = out.reshape(-1)
                flat[pos] = value
                return flat.reshape(m, n)
            r, c = _diag_positions(m, n, offset)
            out[r.to(a.device), c.to(a.device)] = value
            return out
        if len(set(a.shape)) != 1:
            raise ValueError("fill_diagonal with ndim > 2 requires all dims "
                             "equal (reference fill_diagonal_ kernel)")
        idx = torch.arange(a.shape[0], device=a.device)
        out[(idx,) * a.dim()] = value
        return out

    return apply(fn, x, _name="fill_diagonal")


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    def fn(a, b):
        d1, d2 = dim1 % a.dim(), dim2 % a.dim()
        a2 = torch.movedim(a, (d1, d2), (-2, -1)).clone()
        r, c = _diag_positions(a2.shape[-2], a2.shape[-1], offset)
        a2[..., r.to(a.device), c.to(a.device)] = b.to(a.dtype)
        return torch.movedim(a2, (-2, -1), (d1, d2))

    return apply(fn, x, y, _name="fill_diagonal_tensor")


# -- legacy/aux training ops ------------------------------------------------


def affine_channel(x, scale, bias, data_layout="NCHW", name=None):
    """Per-channel affine y = x * scale[C] + bias[C] (reference ops.yaml
    affine_channel): the frozen-BatchNorm replacement in legacy detection
    models."""
    def fn(xv, s, b):
        if data_layout in ("NCHW", "NCDHW"):
            shape = (1, -1) + (1,) * (xv.dim() - 2)
        else:
            shape = (1,) * (xv.dim() - 1) + (-1,)
        return xv * s.reshape(shape) + b.reshape(shape)

    return apply(fn, x, scale, bias, _name="affine_channel")


def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    """out = alpha * x + beta * sinusoidal PE (reference
    add_position_encoding op): x is [B, T, D], D even; PE is [sin | cos]."""
    def fn(xv):
        _, T, D = xv.shape
        half = D // 2
        pos = torch.arange(T, dtype=torch.float32, device=xv.device)[:, None]
        div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                              device=xv.device) / half)
        ang = pos / div[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return alpha * xv + beta * pe[None].to(xv.dtype)

    return apply(fn, x, _name="add_position_encoding")


def cvm(x, cvm_in, use_cvm=True, name=None):
    """Continuous-value-model feature op for CTR models (reference cvm op):
    x [B, D] whose first two slots carry show/click, cvm_in [B, 2] the raw
    counters. use_cvm=True rewrites the slots to (log(show+1),
    log(click+1) - log(show+1)); False drops them."""
    def fn(xv, c):
        logs = torch.log(c.float() + 1.0)
        feat = torch.stack([logs[:, 0], logs[:, 1] - logs[:, 0]], dim=1)
        if use_cvm:
            return torch.cat([feat.to(xv.dtype), xv[:, 2:]], dim=1)
        return xv[:, 2:]

    return apply(fn, x, cvm_in, _name="cvm")


def dgc_clip_by_norm(x, current_step=0.0, max_norm=1.0,
                     rampup_begin_step=-1.0, name=None):
    """clip_by_norm as deep gradient compression uses it (reference dgc
    ops)."""
    def fn(xv):
        n = torch.sqrt(torch.sum(torch.square(xv.float())))
        coef = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
        return (xv.float() * coef).to(xv.dtype)

    return apply(fn, x, _name="dgc_clip_by_norm")


def dgc_momentum(param, grad, velocity, learning_rate=0.001,
                 master_param=None, current_step_tensor=None,
                 nranks_tensor=None, mu=0.9, use_nesterov=False,
                 regularization_method="", regularization_coeff=0.0,
                 multi_precision=False, rescale_grad=1.0,
                 rampup_begin_step=-1.0, current_step=0.0, name=None):
    """DGC's gated momentum (reference dgc_momentum op): plain momentum
    before the rampup begins, the gradient passed through after it.
    Returns (new param, new velocity)."""
    if current_step_tensor is not None:
        current_step = float(_raw(current_step_tensor).item())
    p = _raw(param)
    g = _raw(grad, p).float() * rescale_grad
    v = _raw(velocity, p).float()
    lr = _raw(learning_rate, p).float()
    if regularization_method == "l2_decay" and regularization_coeff:
        g = g + regularization_coeff * p.float()
    new_v = mu * v + g
    upd = g + mu * new_v if use_nesterov else new_v
    gate = float(current_step < rampup_begin_step)
    upd = gate * upd + (1 - gate) * g
    new_v = gate * new_v + (1 - gate) * v
    p_out = (p.float() - lr * upd).to(p.dtype)
    return Tensor(p_out), Tensor(new_v)


def dgc(u, v, grad, param=None, current_step=1.0, nranks=1,
        m=0.9, use_nesterov=False, sparsity=(), rampup_begin_step=0.0,
        rampup_step=0.0, regular_coeff=0.0, regular_type=0,
        ratio=0.001, name=None):
    """Deep gradient compression (reference dgc op, Lin et al. 2018):
    momentum-corrected top-k sparsification with local error feedback.
    Returns (new_u, new_v, k_grad, gather_mask); k_grad keeps the top
    `ratio` share of |u + v|, the rest stays in u and v."""
    gd = _raw(grad)
    ud, vd = _raw(u, gd), _raw(v, gd)
    g32 = gd.float().reshape(-1)
    if param is not None and regular_coeff and regular_type:
        pd = _raw(param, gd).float().reshape(-1)
        g32 = g32 + regular_coeff * (torch.sign(pd) if regular_type == 1
                                     else pd)
    if len(sparsity):
        k_idx = 0 if rampup_step <= 0 else int(
            _builtins.min(_builtins.max(current_step - rampup_begin_step,
                                        0.0) // rampup_step,
                          len(sparsity) - 1))
        ratio = 1.0 - float(sparsity[k_idx])
    new_u = m * ud.float().reshape(-1) + g32
    new_v = vd.float().reshape(-1) + new_u
    k = _builtins.max(1, int(g32.numel() * float(ratio) + 0.5))
    thresh = torch.topk(torch.abs(new_v), k).values[-1]
    mask = torch.abs(new_v) >= thresh
    k_grad = torch.where(mask, new_v, 0.0)
    new_v = torch.where(mask, 0.0, new_v)
    new_u = torch.where(mask, 0.0, new_u)
    shape = gd.shape
    return (Tensor(new_u.reshape(shape).to(ud.dtype)),
            Tensor(new_v.reshape(shape).to(vd.dtype)),
            Tensor(k_grad.reshape(shape).to(gd.dtype)),
            Tensor(mask.reshape(shape)))


def dpsgd(param, grad, learning_rate=0.01, clip=10.0, batch_size=16.0,
          sigma=1.0, seed=0, name=None):
    """Differentially private SGD update (reference dpsgd op): the gradient
    L2-clipped to `clip`, Gaussian noise sigma * clip, then SGD. seed 0
    draws fresh noise from the framework generator every call."""
    p = _raw(param)
    g = _raw(grad, p).float()
    n = torch.sqrt(torch.sum(torch.square(g)))
    g = g * torch.clamp(clip / torch.clamp(n, min=1e-12), max=1.0)
    gen = (_rng.generator(p.device) if seed in (None, 0) else
           torch.Generator(device=p.device).manual_seed(int(seed)))
    noise = torch.randn(g.shape, dtype=torch.float32, device=p.device,
                        generator=gen) * sigma * clip
    upd = (g + noise) / batch_size
    return Tensor((p.float() - learning_rate * upd).to(p.dtype))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
