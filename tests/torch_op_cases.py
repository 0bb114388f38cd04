"""The op table the eager-surface parity tests share: one case per public
callable of the six op modules (`creation`, `math`, `manipulation`,
`logic`, `search`, `linalg`).

Each case makes its inputs with numpy from a seed of its own and calls the
op through a module argument `P`: `paddle_tpu` (the JAX package) or
`paddle_tpu_torch` (the port), so one function drives both. `run` gives the
outputs as numpy arrays and, for a case with `grad`, the gradients of
sum_i sum(out_i * w_i) with respect to the chosen inputs (w_i from a seed).

This module imports neither JAX nor any package under test: the card test
(`test_torch_eager_cuda.py`) runs the same table on the card, where JAX is
not installed.
"""

import zlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6     # tests/op_test.py's f32 bars
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5


@dataclass
class Case:
    module: str                   # the op module: creation, math, ...
    name: str                     # the public callable the case covers
    fn: Callable                  # fn(P, *tensors) -> output(s)
    inputs: Callable = lambda r: []   # inputs(rng) -> list of numpy arrays
    grad: tuple = ()              # indices of inputs to differentiate
    check: str = "value"          # value | sign | random
    note: str = ""                # a divergence by design (ROADMAP §C)
    ref_fixed: Callable = None    # expected outputs when the JAX package
    #                               is wrong there (numpy, from inputs)
    fixed_outputs: tuple = field(default_factory=tuple)  # which outputs
    fd_grad: tuple = ()           # inputs whose gradient the JAX package
    #                               drops: the port's is held to finite
    #                               differences instead
    ref_raises: bool = False      # the JAX package's op raises here; the
    #                               port is held to `ref_fixed` (numpy)

    @property
    def id(self):
        return f"{self.module}.{self.name}"

    def make_inputs(self):
        rng = np.random.default_rng(zlib.crc32(self.id.encode()))
        return self.inputs(rng)


def f(*shape, lo=-1.0, hi=1.0):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def U(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def I(r, *shape, lo=0, hi=10):
    return r.integers(lo, hi, shape).astype(np.int64)


def spd(r, n):
    a = U(r, n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


CASES = []


def case(module, name, fn, inputs=lambda r: [], grad=(), **kw):
    CASES.append(Case(module, name, fn, inputs, grad, **kw))


# --------------------------------------------------------------------------
# creation
# --------------------------------------------------------------------------
M = "creation"
case(M, "zeros", lambda P: P.zeros([2, 3]))
case(M, "ones", lambda P: P.ones([2, 3], dtype="int32"))
case(M, "full", lambda P: [P.full([2, 2], 1.5), P.full([2], 3),
                            P.full([1], True)])
case(M, "empty", lambda P: P.empty([2, 3]))
case(M, "empty_like", lambda P, x: P.empty_like(x), lambda r: [U(r, 2, 3)])
case(M, "zeros_like", lambda P, x: P.zeros_like(x), lambda r: [U(r, 2, 3)])
case(M, "ones_like", lambda P, x: P.ones_like(x, dtype="float32"),
     lambda r: [I(r, 2, 3)])
case(M, "full_like", lambda P, x: P.full_like(x, 2.5), lambda r: [U(r, 3)])
case(M, "arange", lambda P: [P.arange(5), P.arange(1.0, 2.0, 0.25),
                              P.arange(2, 9, 3)])
case(M, "linspace", lambda P: P.linspace(-1.0, 2.0, 7))
case(M, "logspace", lambda P: P.logspace(0.0, 2.0, 5, base=2.0))
case(M, "eye", lambda P: [P.eye(3), P.eye(2, 4)])
case(M, "diag", lambda P, v, m: [P.diag(v), P.diag(v, offset=1),
                                 P.diag(m), P.diag(v, padding_value=7.0)],
     lambda r: [U(r, 3), U(r, 3, 3)], grad=(1,), fd_grad=(0,),
     note="the JAX package's diag drops the gradient of a 1-D input "
          "when padding_value is set")
case(M, "diagflat", lambda P, x: P.diagflat(x, offset=-1),
     lambda r: [U(r, 2, 2)], grad=(0,))
case(M, "tril", lambda P, x: P.tril(x, diagonal=-1), lambda r: [U(r, 3, 4)],
     grad=(0,))
case(M, "triu", lambda P, x: P.triu(x, diagonal=1), lambda r: [U(r, 3, 4)],
     grad=(0,))
case(M, "meshgrid", lambda P, a, b: P.meshgrid(a, b),
     lambda r: [U(r, 3), U(r, 2)], fd_grad=(0, 1))
case(M, "assign", lambda P, x: P.assign(x), lambda r: [U(r, 2, 3)])
case(M, "clone", lambda P, x: P.clone(x), lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "tril_indices", lambda P: P.tril_indices(4, 3, 1))
case(M, "triu_indices", lambda P: P.triu_indices(3, 4, -1))
case(M, "complex", lambda P, a, b: P.real(P.complex(a, b)) + P.imag(
    P.complex(a, b)) * 2.0, lambda r: [U(r, 3), U(r, 3)], grad=(0, 1))
for _name in ("rand", "randn", "uniform", "normal", "randint",
              "randint_like", "randperm", "bernoulli", "multinomial",
              "standard_normal", "poisson", "exponential_", "standard_gamma",
              "binomial"):
    case(M, _name, None, check="random")

# --------------------------------------------------------------------------
# math
# --------------------------------------------------------------------------
M = "math"
_UNARY = {
    "exp": f(3, 4), "expm1": f(3, 4), "log": f(3, 4, lo=0.5, hi=2.0),
    "log2": f(3, 4, lo=0.5, hi=2.0), "log10": f(3, 4, lo=0.5, hi=2.0),
    "log1p": f(3, 4, lo=0.0, hi=2.0), "sqrt": f(3, 4, lo=0.5, hi=2.0),
    "rsqrt": f(3, 4, lo=0.5, hi=2.0), "square": f(3, 4), "abs": f(3, 4),
    "sign": f(3, 4), "neg": f(3, 4), "negative": f(3, 4),
    "reciprocal": f(3, 4, lo=0.5, hi=2.0), "floor": f(3, 4, lo=-3, hi=3),
    "ceil": f(3, 4, lo=-3, hi=3), "round": f(3, 4, lo=-3, hi=3),
    "trunc": f(3, 4, lo=-3, hi=3), "frac": f(3, 4, lo=-3, hi=3),
    "sin": f(3, 4), "cos": f(3, 4), "tan": f(3, 4), "asin": f(3, 4, lo=-.9,
                                                              hi=.9),
    "acos": f(3, 4, lo=-.9, hi=.9), "atan": f(3, 4), "sinh": f(3, 4),
    "cosh": f(3, 4), "tanh": f(3, 4), "asinh": f(3, 4),
    "acosh": f(3, 4, lo=1.5, hi=3.0), "atanh": f(3, 4, lo=-.9, hi=.9),
    "erf": f(3, 4), "erfinv": f(3, 4, lo=-.9, hi=.9), "sigmoid": f(3, 4),
    "logit": f(3, 4, lo=0.1, hi=0.9), "digamma": f(3, 4, lo=0.5, hi=3.0),
    "lgamma": f(3, 4, lo=0.5, hi=3.0), "gammaln": f(3, 4, lo=0.5, hi=3.0),
    "i0": f(3, 4), "i1": f(3, 4), "i0e": f(3, 4), "i1e": f(3, 4),
    "deg2rad": f(3, 4), "rad2deg": f(3, 4), "conj": f(3, 4), "real": f(3, 4),
    "imag": f(3, 4), "angle": f(3, 4), "exponent": f(3, 4, lo=0.5, hi=9.0),
    "isnan": f(3, 4), "isinf": f(3, 4), "isfinite": f(3, 4),
    "bitwise_not": lambda r: I(r, 3, 4, lo=-9, hi=9),
}
_NO_GRAD = {"sign", "floor", "ceil", "round", "trunc", "isnan", "isinf",
            "isfinite", "bitwise_not", "exponent", "angle", "imag"}
# gradients torch leaves unimplemented (i1e) or JAX's differs in form
_NO_GRAD |= {"i1e"}
for _name, _gen in _UNARY.items():
    case(M, _name, (lambda n: lambda P, x: getattr(P, n)(x))(_name),
         (lambda g: lambda r: [g(r)])(_gen),
         grad=() if _name in _NO_GRAD else (0,))

_BINARY = {
    "add": (f(3, 4), f(4)), "subtract": (f(3, 4), f(3, 1)),
    "multiply": (f(3, 4), f(3, 4)), "divide": (f(3, 4), f(3, 4, lo=.5,
                                                           hi=2.)),
    "floor_divide": (f(3, 4, lo=-5, hi=5), f(3, 4, lo=.5, hi=2.)),
    "mod": (f(3, 4, lo=-5, hi=5), f(3, 4, lo=.5, hi=2.)),
    "remainder": (f(3, 4, lo=-5, hi=5), f(3, 4, lo=.5, hi=2.)),
    "floor_mod": (f(3, 4, lo=-5, hi=5), f(3, 4, lo=.5, hi=2.)),
    "pow": (f(3, 4, lo=.5, hi=2.), f(3, 4)), "maximum": (f(3, 4), f(3, 4)),
    "minimum": (f(3, 4), f(3, 4)), "fmax": (f(3, 4), f(3, 4)),
    "fmin": (f(3, 4), f(3, 4)), "atan2": (f(3, 4), f(3, 4)),
    "hypot": (f(3, 4), f(3, 4)), "logaddexp": (f(3, 4), f(3, 4)),
    "copysign": (f(3, 4), f(3, 4)), "nextafter": (f(3, 4), f(3, 4)),
    "ldexp": (f(3, 4), lambda r: I(r, 3, 4, lo=-3, hi=4)),
    "heaviside": (f(3, 4), f(3, 4)),
    "gcd": (lambda r: I(r, 3, 4, lo=1, hi=40), lambda r: I(r, 3, 4, lo=1,
                                                             hi=40)),
    "lcm": (lambda r: I(r, 3, 4, lo=1, hi=12), lambda r: I(r, 3, 4, lo=1,
                                                             hi=12)),
    "inner": (f(2, 4), f(3, 4)), "kron": (f(2, 2), f(2, 3)),
    "bitwise_and": (lambda r: I(r, 3, 4, hi=64), lambda r: I(r, 3, 4,
                                                               hi=64)),
    "bitwise_or": (lambda r: I(r, 3, 4, hi=64), lambda r: I(r, 3, 4,
                                                              hi=64)),
    "bitwise_xor": (lambda r: I(r, 3, 4, hi=64), lambda r: I(r, 3, 4,
                                                               hi=64)),
    "bitwise_left_shift": (lambda r: I(r, 3, 4, hi=64),
                           lambda r: I(r, 3, 4, hi=4)),
    "bitwise_right_shift": (lambda r: I(r, 3, 4, hi=64),
                            lambda r: I(r, 3, 4, hi=4)),
}
_BIN_NO_GRAD = {"floor_divide", "nextafter", "heaviside", "gcd", "lcm",
                "bitwise_and", "bitwise_or", "bitwise_xor",
                "bitwise_left_shift", "bitwise_right_shift"}
# the gradient is held with respect to x alone: ldexp's y is an integer;
# mod's and copysign's with respect to y are piecewise (jumps, zero)
_X_GRAD = {"ldexp", "mod", "remainder", "floor_mod", "copysign"}
for _name, (_ga, _gb) in _BINARY.items():
    _g = () if _name in _BIN_NO_GRAD else ((0,) if _name in _X_GRAD
                                           else (0, 1))
    case(M, _name, (lambda n: lambda P, a, b: getattr(P, n)(a, b))(_name),
         (lambda ga, gb: lambda r: [ga(r), gb(r)])(_ga, _gb), grad=_g)
case(M, "outer", lambda P, a, b: P.outer(a, b), lambda r: [U(r, 3), U(r, 4)],
     grad=(0, 1))
case(M, "scale", lambda P, x: [P.scale(x, 2.0, 0.5),
                               P.scale(x, 3.0, 1.0, bias_after_scale=False)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "clip", lambda P, x: [P.clip(x, -0.5, 0.5), P.clip(x, min=0.1)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "lerp", lambda P, a, b, w: [P.lerp(a, b, 0.3), P.lerp(a, b, w)],
     lambda r: [U(r, 3), U(r, 3), U(r, 3, lo=0, hi=1)], grad=(0, 1, 2))
case(M, "stanh", lambda P, x: P.stanh(x), lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "multiplex", lambda P, a, b, i: P.multiplex([a, b], i),
     lambda r: [U(r, 4, 3), U(r, 4, 3), I(r, 4, 1, hi=2)], grad=(0, 1))
case(M, "nan_to_num", lambda P, x: P.nan_to_num(P.log(x), nan=1.0,
                                                posinf=9.0, neginf=-9.0),
     lambda r: [np.array([[-1.0, 0.0, 2.0], [np.inf, 0.5, -2.0]],
                         np.float32)])
_RED = ("sum", "mean", "max", "min", "prod", "amax", "amin", "logsumexp",
        "nansum", "nanmean")
for _name in _RED:
    case(M, _name, (lambda n: lambda P, x: [
        getattr(P, n)(x), getattr(P, n)(x, axis=1),
        getattr(P, n)(x, axis=[0, 2], keepdim=True)])(_name),
        lambda r: [U(r, 2, 3, 4, lo=0.5, hi=1.5)], grad=(0,))
case(M, "all", lambda P, x: [P.all(x), P.all(x, axis=1),
                             P.all(x, axis=[0, 1], keepdim=True)],
     lambda r: [r.uniform(size=(2, 3, 4)) > 0.2])
case(M, "any", lambda P, x: [P.any(x), P.any(x, axis=1),
                             P.any(x, axis=[0, 1], keepdim=True)],
     lambda r: [r.uniform(size=(2, 3, 4)) > 0.8])
case(M, "count_nonzero", lambda P, x: [P.count_nonzero(x),
                                       P.count_nonzero(x, axis=1)],
     lambda r: [I(r, 3, 4, hi=3)])
case(M, "cumsum", lambda P, x: [P.cumsum(x), P.cumsum(x, axis=1)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "cumprod", lambda P, x: P.cumprod(x, dim=1),
     lambda r: [U(r, 3, 4, lo=0.5, hi=1.5)], grad=(0,))


def _np_cum(a, axis, better):
    vals = np.array(a)
    idx = np.zeros(a.shape, np.int64)
    moved_v, moved_i = np.moveaxis(vals, axis, 0), np.moveaxis(idx, axis, 0)
    for t in range(1, moved_v.shape[0]):
        take = better(moved_v[t], moved_v[t - 1]) | (moved_v[t] ==
                                                     moved_v[t - 1])
        moved_i[t] = np.where(take, t, moved_i[t - 1])
        moved_v[t] = np.where(take, moved_v[t], moved_v[t - 1])
    return [vals, idx]


case(M, "cummax", lambda P, x: P.cummax(x, axis=1), lambda r: [U(r, 3, 5)],
     fd_grad=(0,), ref_fixed=lambda a: _np_cum(a, 1, np.greater),
     fixed_outputs=(1,),
     note="the JAX package's cummax indices are 0s; the port's are the "
          "running argmax (Paddle's)")
case(M, "cummin", lambda P, x: P.cummin(x, axis=1), lambda r: [U(r, 3, 5)],
     fd_grad=(0,), ref_fixed=lambda a: _np_cum(a, 1, np.less),
     fixed_outputs=(1,),
     note="the JAX package's cummin indices are 0s; the port's are the "
          "running argmin (Paddle's)")
case(M, "logcumsumexp", lambda P, x: [P.logcumsumexp(x, axis=1),
                                      P.logcumsumexp(x)],
     lambda r: [U(r, 3, 4)], fd_grad=(0,))
case(M, "median", lambda P, x: [P.median(x), P.median(x, axis=1),
                                P.median(x, axis=0, keepdim=True)],
     lambda r: [U(r, 4, 6)], grad=(0,))
case(M, "nanmedian", lambda P, x: [P.nanmedian(x), P.nanmedian(x, axis=1)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "quantile", lambda P, x: [P.quantile(x, 0.3),
                                  P.quantile(x, [0.25, 0.5], axis=1),
                                  P.quantile(x, 0.7, axis=[0, 1],
                                             keepdim=True)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "std", lambda P, x: [P.std(x), P.std(x, axis=1, unbiased=False)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "var", lambda P, x: [P.var(x), P.var(x, axis=[0, 1],
                                               keepdim=True)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "trace", lambda P, x: [P.trace(x), P.trace(x, offset=1)],
     lambda r: [U(r, 4, 4)], grad=(0,))
case(M, "diff", lambda P, x, p: [P.diff(x), P.diff(x, n=2, axis=0),
                                 P.diff(x, axis=1, prepend=p)],
     lambda r: [U(r, 4, 5), U(r, 4, 1)], grad=(0,), fd_grad=(1,))
case(M, "increment", lambda P, x: P.increment(x, 2.0), lambda r: [U(r, 3)])
case(M, "accuracy_check", lambda P, x: P.accuracy_check(x, x * 1.0, "mul"),
     lambda r: [U(r, 3)])
case(M, "gammainc", lambda P, a, x: P.gammainc(a, x),
     lambda r: [U(r, 3, 4, lo=.5, hi=3.), U(r, 3, 4, lo=.5, hi=3.)],
     grad=(1,))
case(M, "gammaincc", lambda P, a, x: P.gammaincc(a, x),
     lambda r: [U(r, 3, 4, lo=.5, hi=3.), U(r, 3, 4, lo=.5, hi=3.)],
     grad=(1,))
case(M, "polygamma", lambda P, x: [P.polygamma(x, 1), P.polygamma(x, 2)],
     lambda r: [U(r, 3, 4, lo=.5, hi=3.)], grad=(0,))
case(M, "add_n", lambda P, a, b, c: P.add_n([a, b, c]),
     lambda r: [U(r, 3), U(r, 3), U(r, 3)], grad=(0, 1, 2))
case(M, "reduce_as", lambda P, x, t: P.reduce_as(x, t),
     lambda r: [U(r, 2, 3, 4), U(r, 3, 1)], grad=(0,))
case(M, "clip_by_norm", lambda P, x: [P.clip_by_norm(x, 1.0),
                                      P.clip_by_norm(x, 100.0)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "renorm", lambda P, x: P.renorm(x, 2.0, 0, 1.0),
     lambda r: [U(r, 3, 4, lo=-2, hi=2)], grad=(0,))
case(M, "diagonal", lambda P, x: [P.diagonal(x), P.diagonal(
    x, offset=1, axis1=1, axis2=2)], lambda r: [U(r, 3, 4, 4)], grad=(0,))
case(M, "diag_embed", lambda P, x: [P.diag_embed(x),
                                    P.diag_embed(x, offset=1, dim1=0,
                                                 dim2=2)],
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "fill_diagonal", lambda P, x, t: [
    P.fill_diagonal(x, 7.0), P.fill_diagonal(x, 5.0, offset=1),
    P.fill_diagonal(t, 2.0, wrap=True)],
    lambda r: [U(r, 3, 4), U(r, 7, 3)], grad=(0, 1))
case(M, "fill_diagonal_tensor", lambda P, x, y:
     P.fill_diagonal_tensor(x, y, offset=1, dim1=1, dim2=2),
     lambda r: [U(r, 2, 4, 4), U(r, 2, 3)], grad=(0, 1))
case(M, "affine_channel", lambda P, x, s, b: [
    P.affine_channel(x, s, b), P.affine_channel(
        P.transpose(x, [0, 2, 3, 1]), s, b, data_layout="NHWC")],
    lambda r: [U(r, 2, 3, 2, 2), U(r, 3), U(r, 3)], grad=(0, 1, 2))
case(M, "add_position_encoding", lambda P, x: P.add_position_encoding(
    x, 0.5, 2.0), lambda r: [U(r, 2, 5, 6)], grad=(0,))
case(M, "cvm", lambda P, x, c: [P.cvm(x, c), P.cvm(x, c, use_cvm=False)],
     lambda r: [U(r, 3, 5), U(r, 3, 2, lo=0, hi=9)], grad=(0,))
case(M, "dgc_clip_by_norm", lambda P, x: P.dgc_clip_by_norm(x,
                                                            max_norm=0.5),
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "dgc_momentum", lambda P, p, g, v: [
    *P.dgc_momentum(p, g, v, 0.1, rampup_begin_step=5.0, current_step=1.0),
    *P.dgc_momentum(p, g, v, 0.1, use_nesterov=True,
                    rampup_begin_step=5.0, current_step=6.0)],
    lambda r: [U(r, 3, 4), U(r, 3, 4), U(r, 3, 4)])
case(M, "dgc", lambda P, u, v, g: list(P.dgc(u, v, g, ratio=0.25)),
     lambda r: [U(r, 4, 4), U(r, 4, 4), U(r, 4, 4)])
case(M, "dpsgd", None, check="random")

# --------------------------------------------------------------------------
# manipulation
# --------------------------------------------------------------------------
M = "manipulation"
case(M, "reshape", lambda P, x: [P.reshape(x, [4, 3]),
                                 P.reshape(x, [-1, 2])],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "reshape_", lambda P, x: P.reshape_(x * 1.0, [2, 6]),
     lambda r: [U(r, 3, 4)], fd_grad=(0,))
case(M, "cast", lambda P, x: [P.cast(x, "int32"), P.cast(x, "float32")],
     lambda r: [U(r, 3, 4, lo=-5, hi=5)], grad=(0,))
case(M, "cast_", lambda P, x: P.cast_(x * 1.0, "float32"),
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "view", lambda P, x: [P.view(x, [2, 6]), P.view(x, "int32")],
     lambda r: [U(r, 3, 4, lo=-5, hi=5)])
case(M, "transpose", lambda P, x: P.transpose(x, [2, 0, 1]),
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "t", lambda P, x, v: [P.t(x), P.t(v)], lambda r: [U(r, 2, 3),
                                                          U(r, 3)],
     grad=(0, 1))
case(M, "moveaxis", lambda P, x: P.moveaxis(x, 0, 2),
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "swapaxes", lambda P, x: P.swapaxes(x, 0, 2),
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "concat", lambda P, a, b: [P.concat([a, b], axis=1),
                                   P.concat([a, a])],
     lambda r: [U(r, 2, 3), U(r, 2, 2)], grad=(0, 1))
case(M, "stack", lambda P, a, b: [P.stack([a, b]), P.stack([a, b], axis=-1)],
     lambda r: [U(r, 2, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "hstack", lambda P, a, b: P.hstack([a, b]),
     lambda r: [U(r, 2, 3), U(r, 2, 2)], grad=(0, 1))
case(M, "vstack", lambda P, a, b: P.vstack([a, b]),
     lambda r: [U(r, 2, 3), U(r, 1, 3)], grad=(0, 1))
case(M, "dstack", lambda P, a, b: P.dstack([a, b]),
     lambda r: [U(r, 2, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "split", lambda P, x: [*P.split(x, 2, axis=1),
                               *P.split(x, [1, -1, 1], axis=1)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "chunk", lambda P, x: P.chunk(x, 3), lambda r: [U(r, 6, 2)],
     grad=(0,))
case(M, "unbind", lambda P, x: P.unbind(x, axis=1), lambda r: [U(r, 2, 3)],
     grad=(0,))
case(M, "squeeze", lambda P, x: [P.squeeze(x), P.squeeze(x, axis=[0, 1]),
                                 P.squeeze(x, axis=-1)],
     lambda r: [U(r, 1, 3, 1)], grad=(0,))
case(M, "squeeze_", lambda P, x: P.squeeze_(x * 1.0, axis=0),
     lambda r: [U(r, 1, 3)], fd_grad=(0,))
case(M, "unsqueeze", lambda P, x: [P.unsqueeze(x, 0),
                                   P.unsqueeze(x, [0, 3]),
                                   P.unsqueeze(x, -1)],
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "unsqueeze_", lambda P, x: P.unsqueeze_(x * 1.0, 1),
     lambda r: [U(r, 2, 3)], fd_grad=(0,))
case(M, "flatten", lambda P, x: [P.flatten(x), P.flatten(x, 1, 2)],
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "expand", lambda P, x: P.expand(x, [2, 3, 4]),
     lambda r: [U(r, 3, 1)], grad=(0,))
case(M, "broadcast_to", lambda P, x: P.broadcast_to(x, [2, 3, 4]),
     lambda r: [U(r, 1, 4)], grad=(0,))
case(M, "expand_as", lambda P, x, y: P.expand_as(x, y),
     lambda r: [U(r, 3, 1), U(r, 2, 3, 4)], grad=(0,))
case(M, "broadcast_tensors", lambda P, a, b: P.broadcast_tensors([a, b]),
     lambda r: [U(r, 3, 1), U(r, 1, 4)], grad=(0, 1))
case(M, "broadcast_shape", lambda P: P.broadcast_shape([3, 1], [2, 1, 4]))
case(M, "tile", lambda P, x: [P.tile(x, [2, 1]), P.tile(x, [2, 1, 3])],
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "repeat_interleave", lambda P, x: [P.repeat_interleave(x, 2),
                                           P.repeat_interleave(x, 3,
                                                               axis=1)],
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "flip", lambda P, x: [P.flip(x, 0), P.flip(x, [0, 1])],
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "rot90", lambda P, x: [P.rot90(x), P.rot90(x, k=3, axes=(1, 2))],
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "roll", lambda P, x: [P.roll(x, 1), P.roll(x, [1, -2], [0, 1])],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "gather", lambda P, x, i: [P.gather(x, i), P.gather(x, i, axis=1)],
     lambda r: [U(r, 4, 5), np.array([3, 0, 2], np.int64)], grad=(0,))
case(M, "gather_nd", lambda P, x, i: P.gather_nd(x, i),
     lambda r: [U(r, 3, 4, 2), np.array([[0, 1], [2, 3]], np.int64)],
     grad=(0,))
case(M, "take_along_axis", lambda P, x, i: P.take_along_axis(x, i, 1),
     lambda r: [U(r, 3, 5), I(r, 3, 2, hi=5)], grad=(0,))
case(M, "put_along_axis", lambda P, x, i, v: [
    P.put_along_axis(x, i, v, 1), P.put_along_axis(x, i, v, 1, "add"),
    P.put_along_axis(x, i, 2.0, 1, "mul"),
    P.put_along_axis(x, i, v, 1, "amax")],
    lambda r: [U(r, 3, 5), np.array([[0, 3], [1, 4], [2, 0]], np.int64),
               U(r, 3, 2)], grad=(0, 2))
case(M, "scatter", lambda P, x, i, u: [P.scatter(x, i, u),
                                       P.scatter(x, i, u, overwrite=False)],
     lambda r: [U(r, 5, 3), np.array([3, 0, 1], np.int64), U(r, 3, 3)],
     grad=(0, 2))
case(M, "scatter_nd_add", lambda P, x, i, u: P.scatter_nd_add(x, i, u),
     lambda r: [U(r, 4, 3), np.array([[1], [3], [1]], np.int64), U(r, 3, 3)],
     grad=(0, 2))
case(M, "scatter_nd", lambda P, i, u: P.scatter_nd(i, u, [4, 3]),
     lambda r: [np.array([[1], [3], [1]], np.int64), U(r, 3, 3)], grad=(1,))
case(M, "index_select", lambda P, x, i: [P.index_select(x, i),
                                         P.index_select(x, i, axis=1)],
     lambda r: [U(r, 4, 5), np.array([3, 0, 3], np.int64)], grad=(0,))
case(M, "index_sample", lambda P, x, i: P.index_sample(x, i),
     lambda r: [U(r, 3, 5), I(r, 3, 4, hi=5)], grad=(0,))
case(M, "index_add", lambda P, x, i, v: P.index_add(x, i, 1, v),
     lambda r: [U(r, 3, 5), np.array([4, 0, 4], np.int64), U(r, 3, 3)],
     grad=(0, 2))
case(M, "index_put", lambda P, x, a, b, v: [
    P.index_put(x, (a, b), v), P.index_put(x, (a, b), v, accumulate=True)],
    lambda r: [U(r, 3, 4), np.array([0, 2], np.int64),
               np.array([1, 3], np.int64), U(r, 2)], grad=(0, 3))
case(M, "masked_select", lambda P, x, m: P.masked_select(x, m),
     lambda r: [U(r, 3, 4), r.uniform(size=(3, 4)) > 0.5], fd_grad=(0,))
case(M, "masked_fill", lambda P, x, m: P.masked_fill(x, m, 3.0),
     lambda r: [U(r, 3, 4), r.uniform(size=(3, 4)) > 0.5], grad=(0,))
case(M, "masked_scatter", lambda P, x, m, v: P.masked_scatter(x, m, v),
     lambda r: [U(r, 3, 4), r.uniform(size=(3, 4)) > 0.5, U(r, 12)],
     grad=(0,))
case(M, "where", lambda P, c, x, y: [P.where(c, x, y), P.where(c, x, 0.5),
                                     *P.where(c)],
     lambda r: [r.uniform(size=(3, 4)) > 0.5, U(r, 3, 4), U(r, 3, 4)],
     grad=(1, 2))
def _np_select_scatter(x, v):
    out = x.copy()
    out[:, 2] = v
    return [out]


case(M, "select_scatter", lambda P, x, v: P.select_scatter(x, v, 1, 2),
     lambda r: [U(r, 3, 4), U(r, 3)], fd_grad=(0, 1), ref_raises=True,
     ref_fixed=_np_select_scatter, fixed_outputs=(0,),
     note="the JAX package's select_scatter calls the module's own `slice` "
          "op where it means the builtin, and raises TypeError")
case(M, "slice", lambda P, x: P.slice(x, [0, 2], [1, 0], [3, 2]),
     lambda r: [U(r, 4, 3, 5)], grad=(0,))
case(M, "strided_slice", lambda P, x: [
    P.strided_slice(x, [0, 1], [0, 1], [4, 5], [2, 2]),
    P.strided_slice(x, [1], [4], [0], [-2])],
    lambda r: [U(r, 4, 5)], grad=(0,))
case(M, "crop", lambda P, x: P.crop(x, [2, 2], [1, 2]),
     lambda r: [U(r, 4, 5)], grad=(0,))
case(M, "unique", lambda P, x: [P.unique(x), *P.unique(
    x, return_index=True, return_inverse=True, return_counts=True)],
    lambda r: [I(r, 12, hi=6)])
case(M, "unique_consecutive", lambda P, x: list(P.unique_consecutive(
    x, return_inverse=True, return_counts=True)),
    lambda r: [np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64)])
case(M, "as_complex", lambda P, x: P.as_real(P.as_complex(x)) * 2.0,
     lambda r: [U(r, 3, 2)], grad=(0,))
case(M, "as_real", lambda P, x: P.as_real(P.as_complex(x)),
     lambda r: [U(r, 4, 2)], grad=(0,))
case(M, "numel", lambda P, x: P.numel(x), lambda r: [U(r, 3, 4)])
case(M, "shard_index", lambda P, x: P.shard_index(x, 20, 2, 1),
     lambda r: [I(r, 4, 1, hi=20)])
case(M, "tensordot", lambda P, a, b: [P.tensordot(a, b, 1),
                                      P.tensordot(a, b, [[1], [0]])],
     lambda r: [U(r, 2, 3), U(r, 3, 4)], grad=(0, 1))
case(M, "atleast_1d", lambda P, a, b: P.atleast_1d(a, b),
     lambda r: [np.float32(2.0), U(r, 2, 3)], grad=(1,))
case(M, "atleast_2d", lambda P, a, b: P.atleast_2d(a, b),
     lambda r: [U(r, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "atleast_3d", lambda P, a, b: P.atleast_3d(a, b),
     lambda r: [U(r, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "unstack", lambda P, x: P.unstack(x, axis=1), lambda r: [U(r, 2, 3)],
     grad=(0,))
case(M, "shape", lambda P, x: P.shape(x), lambda r: [U(r, 2, 3, 4)])
case(M, "sequence_pool", lambda P, x, ln: [
    P.sequence_pool(x, t, lengths=ln) for t in
    ("SUM", "MEAN", "SQRT", "MAX", "MIN", "LAST", "FIRST")],
    lambda r: [U(r, 3, 5, 2), np.array([5, 2, 3], np.int64)])
case(M, "sequence_conv", lambda P, x, w, b: [
    P.sequence_conv(x, w, b), P.sequence_conv(x, w, context_start=0)],
    lambda r: [U(r, 2, 5, 3), U(r, 9, 4), U(r, 4)], fd_grad=(0, 1, 2))
case(M, "im2sequence", lambda P, x: [P.im2sequence(x, (2, 2)),
                                     P.im2sequence(x, (3, 2), (2, 1),
                                                   (1, 0, 0, 1))],
     lambda r: [U(r, 2, 3, 5, 4)])

# --------------------------------------------------------------------------
# logic
# --------------------------------------------------------------------------
M = "logic"
for _name in ("equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal"):
    case(M, _name, (lambda n: lambda P, a, b: [getattr(P, n)(a, b),
                                               getattr(P, n)(a, 0)])(_name),
         lambda r: [I(r, 3, 4, hi=3).astype(np.float32),
                    I(r, 3, 4, hi=3).astype(np.float32)])
for _name in ("logical_and", "logical_or", "logical_xor"):
    case(M, _name, (lambda n: lambda P, a, b: getattr(P, n)(a, b))(_name),
         lambda r: [r.uniform(size=(3, 4)) > .5,
                    r.uniform(size=(3, 4)) > .5])
case(M, "logical_not", lambda P, a: P.logical_not(a),
     lambda r: [r.uniform(size=(3, 4)) > .5])
case(M, "equal_all", lambda P, a, b: [P.equal_all(a, a), P.equal_all(a, b)],
     lambda r: [U(r, 3), U(r, 3)])
case(M, "allclose", lambda P, a, b: [P.allclose(a, a + 1e-9),
                                     P.allclose(a, b)],
     lambda r: [U(r, 3), U(r, 3)])
case(M, "isclose", lambda P, a, b: [P.isclose(a, b, atol=0.5),
                                    P.isclose(a, a)],
     lambda r: [U(r, 3, 4), U(r, 3, 4)])
case(M, "is_tensor", lambda P, a: [P.is_tensor(a), P.is_tensor(1.0)],
     lambda r: [U(r, 3)])
case(M, "is_empty", lambda P, a: [P.is_empty(a), P.is_empty(a[0:0])],
     lambda r: [U(r, 3)])
case(M, "isreal", lambda P, a: P.isreal(a), lambda r: [U(r, 3)])

# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------
M = "search"
case(M, "argmax", lambda P, x: [P.argmax(x), P.argmax(x, axis=1),
                                P.argmax(x, axis=0, keepdim=True)],
     lambda r: [U(r, 3, 5)])
case(M, "argmin", lambda P, x: [P.argmin(x), P.argmin(x, axis=1)],
     lambda r: [U(r, 3, 5)])
case(M, "argsort", lambda P, x: [P.argsort(x), P.argsort(
    x, axis=0, descending=True)], lambda r: [U(r, 3, 5)])
case(M, "sort", lambda P, x: [P.sort(x), P.sort(x, axis=0,
                                                descending=True)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "topk", lambda P, x: [*P.topk(x, 2), *P.topk(x, 2, axis=0,
                                                     largest=False)],
     lambda r: [U(r, 3, 5)], grad=(0,))
case(M, "nonzero", lambda P, x: [P.nonzero(x), *P.nonzero(x,
                                                          as_tuple=True)],
     lambda r: [I(r, 3, 4, hi=2)])
case(M, "searchsorted", lambda P, s, v: [
    P.searchsorted(s, v), P.searchsorted(s, v, right=True),
    P.searchsorted(s, v, out_int32=True)],
    lambda r: [np.array([0., 1., 2., 3.], np.float32),
               np.array([[1.0, 2.5], [-1.0, 3.0]], np.float32)])
case(M, "bucketize", lambda P, x, s: P.bucketize(x, s),
     lambda r: [np.array([0.5, 2.0, 4.0], np.float32),
                np.array([0., 1., 2., 3.], np.float32)])
case(M, "mode", lambda P, x: list(P.mode(x)),
     lambda r: [np.array([[1., 2., 2., 3.], [4., 4., 1., 1.]], np.float32)])
case(M, "kthvalue", lambda P, x: list(P.kthvalue(x, 2)) + list(
    P.kthvalue(x, 1, axis=0, keepdim=True)), lambda r: [U(r, 3, 5)],
    fd_grad=(0,))
case(M, "index_sample", lambda P, x, i: P.index_sample(x, i),
     lambda r: [U(r, 3, 5), I(r, 3, 2, hi=5)], grad=(0,))
case(M, "top_p_sampling", None, check="random")
case(M, "edit_distance", lambda P, a, b: list(P.edit_distance(a, b)) + list(
    P.edit_distance(a, b, normalized=False, ignored_tokens=[0])),
    lambda r: [I(r, 3, 6, hi=4), I(r, 3, 5, hi=4)])
case(M, "beam_search", lambda P, ids, sc, s: list(P.beam_search(
    ids, sc, None, s, beam_size=2, end_id=0)),
    lambda r: [np.array([[1, 0], [2, 3]], np.int64), U(r, 2, 2),
               U(r, 2, 2, 5)])
case(M, "beam_search_decode", lambda P, ids, par: P.beam_search_decode(
    ids, par), lambda r: [I(r, 4, 2, 3, hi=9), I(r, 4, 2, 3, hi=3)])
case(M, "chunk_eval", lambda P, a, b: list(P.chunk_eval(
    a, b, "IOB", 2)), lambda r: [np.array([[0, 1, 4, 2, 3, 3]], np.int64),
                                 np.array([[0, 1, 4, 2, 3, 4]], np.int64)])
case(M, "crf_decoding", lambda P, e, w: P.crf_decoding(e, w),
     lambda r: [U(r, 2, 5, 3), U(r, 5, 3)])
case(M, "ctc_align", lambda P, x: list(P.ctc_align(x, blank=0)),
     lambda r: [np.array([[0, 1, 1, 0, 2, 2, 3], [4, 4, 0, 0, 1, 0, 1]],
                         np.int64)])

# --------------------------------------------------------------------------
# linalg
# --------------------------------------------------------------------------
M = "linalg"
case(M, "matmul", lambda P, a, b, v: [
    P.matmul(a, b), P.matmul(a, a, transpose_y=True),
    P.matmul(b, b, transpose_x=True), P.matmul(a, v)],
    lambda r: [U(r, 2, 3, 4), U(r, 2, 4, 5), U(r, 4)], grad=(0, 1, 2))
case(M, "mm", lambda P, a, b: P.mm(a, b), lambda r: [U(r, 3, 4),
                                                     U(r, 4, 2)],
     grad=(0, 1))
case(M, "bmm", lambda P, a, b: P.bmm(a, b), lambda r: [U(r, 2, 3, 4),
                                                       U(r, 2, 4, 2)],
     grad=(0, 1))
case(M, "dot", lambda P, a, b: P.dot(a, b), lambda r: [U(r, 2, 4),
                                                       U(r, 2, 4)],
     grad=(0, 1))
case(M, "mv", lambda P, a, v: P.mv(a, v), lambda r: [U(r, 3, 4), U(r, 4)],
     grad=(0, 1))
case(M, "outer", lambda P, a, b: P.outer(a, b), lambda r: [U(r, 2, 2),
                                                           U(r, 3)],
     grad=(0, 1))
case(M, "cross", lambda P, a, b: [P.cross(a, b), P.cross(a, b, axis=1)],
     lambda r: [U(r, 2, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "addmm", lambda P, i, a, b: P.addmm(i, a, b, beta=0.5, alpha=2.0),
     lambda r: [U(r, 3, 2), U(r, 3, 4), U(r, 4, 2)], grad=(0, 1, 2))
case(M, "einsum", lambda P, a, b: [P.einsum("ij,jk->ik", a, b),
                                   P.einsum("ij,jk->", [a, b])],
     lambda r: [U(r, 2, 3), U(r, 3, 4)], grad=(0, 1))
case(M, "norm", lambda P, x: [P.norm(x), P.norm(x, p=1), P.norm(x, p=3),
                              P.norm(x, p=np.inf, axis=1),
                              P.norm(x, p="fro", axis=[0, 1]),
                              P.norm(x, p=2, axis=0, keepdim=True)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "vector_norm", lambda P, x: [P.vector_norm(x), P.vector_norm(
    x, p=1.0, axis=1)], lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "matrix_norm", lambda P, x: P.matrix_norm(x),
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "dist", lambda P, a, b: [P.dist(a, b), P.dist(a, b, p=1)],
     lambda r: [U(r, 3, 4), U(r, 3, 4)], grad=(0, 1))
case(M, "cond", lambda P, x: P.cond(x), lambda r: [spd(r, 3)])
case(M, "det", lambda P, x: P.det(x), lambda r: [spd(r, 3)], grad=(0,))
case(M, "slogdet", lambda P, x: P.slogdet(x), lambda r: [spd(r, 3)])
case(M, "inverse", lambda P, x: P.inverse(x), lambda r: [spd(r, 3)],
     grad=(0,))
case(M, "inv", lambda P, x: P.inv(x), lambda r: [spd(r, 3)], grad=(0,))
case(M, "pinv", lambda P, x: P.pinv(x), lambda r: [U(r, 4, 3)], grad=(0,))
case(M, "cholesky", lambda P, x: [P.cholesky(x), P.cholesky(x, upper=True)],
     lambda r: [spd(r, 3)], grad=(0,))
case(M, "cholesky_solve", lambda P, b, x: P.cholesky_solve(
    b, P.cholesky(x)), lambda r: [U(r, 3, 2), spd(r, 3)], grad=(0,))
case(M, "triangular_solve", lambda P, a, b: [
    P.triangular_solve(a, b), P.triangular_solve(a, b, upper=False,
                                                 transpose=True)],
    lambda r: [spd(r, 3), U(r, 3, 2)], grad=(0, 1))
case(M, "solve", lambda P, a, b: P.solve(a, b), lambda r: [spd(r, 3),
                                                           U(r, 3, 2)],
     grad=(0, 1))
case(M, "lstsq", lambda P, a, b: list(P.lstsq(a, b)),
     lambda r: [U(r, 5, 3), U(r, 5, 2)])
case(M, "qr", lambda P, x: list(P.qr(x)), lambda r: [U(r, 4, 3)],
     check="sign")
case(M, "svd", lambda P, x: list(P.svd(x)), lambda r: [U(r, 4, 3)],
     check="sign")
case(M, "eig", lambda P, x: list(P.eig(x)), lambda r: [spd(r, 3)],
     check="sign")
case(M, "eigh", lambda P, x: list(P.eigh(x)), lambda r: [spd(r, 3)],
     check="sign")
case(M, "eigvals", lambda P, x: P.eigvals(x), lambda r: [spd(r, 3)],
     check="sign")
# symmetrised in the case, so that a perturbation of one entry is one of a
# symmetric matrix (the gradient torch gives eigvalsh assumes symmetry)
case(M, "eigvalsh", lambda P, x: P.eigvalsh((x + P.t(x)) * 0.5),
     lambda r: [spd(r, 3)], fd_grad=(0,))
case(M, "matrix_power", lambda P, x: [P.matrix_power(x, 3),
                                      P.matrix_power(x, 0)],
     lambda r: [U(r, 3, 3)], grad=(0,))
case(M, "matrix_rank", lambda P, x, y: [P.matrix_rank(x),
                                        P.matrix_rank(y)],
     lambda r: [U(r, 4, 3), np.ones((3, 3), np.float32)])
case(M, "multi_dot", lambda P, a, b, c: P.multi_dot([a, b, c]),
     lambda r: [U(r, 2, 3), U(r, 3, 4), U(r, 4, 2)], grad=(0, 1, 2))
case(M, "histogram", lambda P, x, w: [P.histogram(x, bins=5),
                                      P.histogram(x, 4, -0.5, 0.5),
                                      P.histogram(x, 3, weight=w),
                                      P.histogram(x, 3, density=True)],
     lambda r: [U(r, 20), U(r, 20, lo=0, hi=1)])
case(M, "histogramdd", lambda P, x: (lambda h: [h[0], *h[1]])(
    P.histogramdd(x, bins=3)), lambda r: [U(r, 10, 2)])
case(M, "bincount", lambda P, x, w: [P.bincount(x), P.bincount(
    x, weights=w, minlength=8)], lambda r: [I(r, 12, hi=6), U(r, 12)])
case(M, "corrcoef", lambda P, x: [P.corrcoef(x), P.corrcoef(x,
                                                            rowvar=False)],
     lambda r: [U(r, 3, 5)], fd_grad=(0,))
case(M, "cov", lambda P, x: [P.cov(x), P.cov(x, rowvar=False, ddof=False)],
     lambda r: [U(r, 3, 5)], fd_grad=(0,))
case(M, "lu", lambda P, x: list(P.lu(x)), lambda r: [U(r, 4, 4)])
case(M, "matrix_exp", lambda P, x: P.matrix_exp(x),
     lambda r: [U(r, 3, 3, lo=-.5, hi=.5)], grad=(0,))
case(M, "householder_product", lambda P, x, t: P.householder_product(x, t),
     lambda r: [U(r, 4, 3), U(r, 3)], grad=(0, 1))
case(M, "pca_lowrank", lambda P, x: list(P.pca_lowrank(x, q=2)),
     lambda r: [U(r, 5, 4)], check="sign")
case(M, "baddbmm", lambda P, i, a, b: P.baddbmm(i, a, b, beta=0.5,
                                                alpha=2.0),
     lambda r: [U(r, 2, 3, 2), U(r, 2, 3, 4), U(r, 2, 4, 2)], grad=(0, 1, 2))
case(M, "svdvals", lambda P, x: P.svdvals(x), lambda r: [U(r, 4, 3)],
     grad=(0,))
case(M, "lu_unpack", lambda P, x: list(P.lu_unpack(*P.lu(x))),
     lambda r: [U(r, 4, 4)])


BY_MODULE = {}
for _c in CASES:
    BY_MODULE.setdefault(_c.module, []).append(_c)


def cases(*modules):
    return [c for c in CASES if c.module in modules]


# --------------------------------------------------------------------------
# running a case
# --------------------------------------------------------------------------


def _flatten(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flatten(o)]
    return [out]


def to_numpy(v):
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, list):
        return np.asarray(v)
    return np.asarray(v.numpy())


def run(P, c, with_grad=True):
    """(outputs as numpy, gradients as numpy or None) of case `c` through
    module `P`."""
    arrays = c.make_inputs()
    ts = [P.to_tensor(a, stop_gradient=not (with_grad and i in c.grad))
          for i, a in enumerate(arrays)]
    outs = _flatten(c.fn(P, *ts))
    vals = [to_numpy(o) for o in outs]
    if not (with_grad and c.grad):
        return vals, None
    rng = np.random.default_rng(zlib.crc32(c.id.encode()) + 1)
    loss = None
    for o in outs:
        if not hasattr(o, "stop_gradient") or o.stop_gradient or \
                "float" not in str(o.dtype):
            continue
        w = P.to_tensor(rng.uniform(-1, 1, o.shape).astype(np.float32))
        term = P.sum(o * w)
        loss = term if loss is None else loss + term
    loss.backward()
    return vals, [None if ts[i].grad is None else ts[i].grad.numpy()
                  for i in c.grad]


# dtypes the port gives where the JAX package (x64 off) narrows
WIDER = {"int32": ("int64",), "float32": ("float64",), "uint32": ("int64",)}


def check_dtype(ref, got, what):
    if ref is None or not hasattr(ref, "dtype"):
        return
    r, g = np.asarray(ref).dtype.name, np.asarray(got).dtype.name
    assert g == r or g in WIDER.get(r, ()), (what, r, g)


def close(ref, got, rtol, atol, what):
    if ref is None or isinstance(ref, (bool, int, float)):
        assert ref == got or (isinstance(ref, float) and abs(ref - got) <= atol
                              + rtol * abs(ref)), (what, ref, got)
        return
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    check_dtype(ref, got, what)
    if ref.dtype == bool or got.dtype == bool:
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    np.testing.assert_allclose(got.astype(np.complex128 if
                                          np.iscomplexobj(got) else
                                          np.float64),
                               ref, rtol=rtol, atol=atol, err_msg=what)


def _eig_order(vals):
    return np.lexsort((np.round(np.imag(vals), 5), np.round(np.real(vals),
                                                            5)))


def _eig_outputs(outs):
    """eig/eigvals outputs in a fixed order of eigenvalues; numpy hands
    back a real array when every eigenvalue is real (the JAX package's
    eigvals), torch keeps complex (Paddle's)."""
    outs = [np.asarray(o) for o in outs]
    vals = np.real_if_close(outs[0])
    if np.isrealobj(vals):
        outs[0] = vals.astype(np.float32)
    order = _eig_order(outs[0])
    outs[0] = outs[0][order]
    if len(outs) > 1:
        outs[1] = outs[1][:, order]
    return outs


def _column_units(got, ref):
    """Per column j, the unit scalar u_j (a sign, or a phase when complex)
    that turns got's column j closest to ref's: u_j = <got_j, ref_j> /
    |<got_j, ref_j>|."""
    dot = np.sum(np.conj(got) * ref, axis=-2)
    mag = np.abs(dot)
    return np.where(mag > 0, dot / np.where(mag > 0, mag, 1.0), 1.0)


def _up_to_sign(name, ref, got):
    """(ref, got) made comparable where a decomposition fixes its vectors
    only up to a sign (or phase) of each whole vector and, for eig, their
    order: each vector of got is multiplied by the one unit scalar that
    best matches ref's, and the factor it pairs with flips with it. A
    vector with a single wrongly signed entry still differs."""
    ref = [np.asarray(o) for o in ref]
    got = [np.asarray(o) for o in got]
    if name in ("eig", "eigvals"):
        ref, got = _eig_outputs(ref), _eig_outputs(got)
        if len(got) > 1:
            got[1] = got[1] * _column_units(got[1], ref[1])[..., None, :]
        return ref, got
    # the vectors: qr's q [m, k], svd's and pca_lowrank's u [m, k], eigh's
    # v [n, n]; their partners: qr's r rows, svd's / pca_lowrank's v columns
    vec = {"qr": 0, "svd": 0, "pca_lowrank": 0, "eigh": 1}[name]
    u = _column_units(got[vec], ref[vec])
    got[vec] = got[vec] * u[..., None, :]
    if name == "qr":
        got[1] = got[1] * u[..., :, None]
    elif name in ("svd", "pca_lowrank"):
        got[2] = got[2] * u[..., None, :]
    return ref, got


def compare(c, ref, got, rtol=None, atol=None):
    """Hold the port's outputs `got` to the JAX package's `ref` (both as
    `run` gives them) under the dtype map, up to sign where the case says
    so; `ref_fixed` replaces the reference outputs it names."""
    rtol = FWD_RTOL if rtol is None else rtol
    atol = FWD_ATOL if atol is None else atol
    ref = list(ref)
    assert len(ref) == len(got), (c.id, len(ref), len(got))
    if c.ref_fixed is not None:
        fixed = c.ref_fixed(*c.make_inputs())
        for i in c.fixed_outputs:
            ref[i] = fixed[i]
    if c.check == "sign":
        ref, got = _up_to_sign(c.name, ref, got)
    for i, (r, g) in enumerate(zip(ref, got)):
        close(r, g, rtol, atol, f"{c.id} output {i}")


def compare_grads(c, ref, got):
    assert len(ref) == len(got), c.id
    for i, (r, g) in zip(c.grad, zip(ref, got)):
        assert (r is None) == (g is None), (c.id, i, r, g)
        if r is not None:
            np.testing.assert_allclose(np.asarray(g, np.float64), r,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"{c.id} grad of input {i}")


def check_against(ref_module, port_module, c):
    """The parity check of one case: the port's outputs (and gradients)
    against the JAX package's, or against `ref_fixed` where the JAX
    package's op raises."""
    got, got_grads = run(port_module, c)
    if c.ref_raises:
        try:
            run(ref_module, c, with_grad=False)
        except Exception:
            pass
        else:
            raise AssertionError(f"{c.id}: the JAX package's op no longer "
                                 "raises; compare with it again")
        expect = c.ref_fixed(*c.make_inputs())
        compare(Case(c.module, c.name, c.fn), expect, got)
        return
    ref, ref_grads = run(ref_module, c)
    compare(c, ref, got)
    if c.grad:
        compare_grads(c, ref_grads, got_grads)
