"""The op table the eager-surface parity tests share: one case per public
callable of the op modules (`creation`, `math`, `manipulation`, `logic`,
`search`, `linalg`, `extras`, `legacy_ps`), of `fft` and of the seven
`nn.functional` files (`functional.activation`, ...), and a second case
(`variant`) where one op needs two.

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
    ref_departs: bool = False     # the JAX package departs from Paddle's
    #                               formula here: the port is held to
    #                               `ref_fixed` (numpy, every output) and
    #                               the JAX package's outputs must differ
    variant: str = ""             # a second case of the same op

    @property
    def id(self):
        tail = f".{self.variant}" if self.variant else ""
        return f"{self.module}.{self.name}{tail}"

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


# --------------------------------------------------------------------------
# extras (`ops/extras.py`): the rest of the top-level namespace. The four
# names that reach unported subsystems (enable_static, disable_static,
# flops, summary) have no case: `test_torch_surface.LATER` holds that they
# raise, naming their slice.
# --------------------------------------------------------------------------
M = "extras"


def _with_inf(r):
    a = U(r, 3, 4)
    a[0, 1], a[2, 3], a[1, 0] = np.inf, -np.inf, np.inf
    return a


def _with_nan(r):
    a = U(r, 3, 5)
    a[0, 1] = a[2, 4] = np.nan
    return a


case(M, "CPUPlace", lambda P: str(P.CPUPlace()) == "Place(cpu)")
case(M, "CUDAPlace", lambda P: P.CUDAPlace(1).device_id)
case(M, "CUDAPinnedPlace",
     lambda P: isinstance(P.CUDAPinnedPlace(), P.CUDAPinnedPlace))
case(M, "LazyGuard", lambda P, x: _in_lazy_guard(P, x),
     lambda r: [U(r, 2, 3)], grad=(0,))
case(M, "as_strided", lambda P, x: P.as_strided(x, [2, 3], [4, 1], 1),
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "batch", lambda P: [len(b) for b in P.batch(
    lambda: iter(range(7)), 3)()])
case(M, "bitwise_invert", lambda P, x: P.bitwise_invert(x),
     lambda r: [I(r, 3, 4, lo=-9, hi=9)])
case(M, "block_diag", lambda P, a, b: P.block_diag([a, b]),
     lambda r: [U(r, 2, 3), U(r, 1, 2)], grad=(0, 1))
case(M, "cartesian_prod", lambda P, a, b: P.cartesian_prod([a, b]),
     lambda r: [U(r, 3), U(r, 2)], grad=(0, 1))
case(M, "cdist", lambda P, a, b: [P.cdist(a, b), P.cdist(a, b, p=1.5)],
     lambda r: [U(r, 3, 4), U(r, 5, 4)], grad=(0, 1))
case(M, "check_shape", lambda P: P.check_shape([2, -1, 3]) is None)
case(M, "column_stack", lambda P, a, b: P.column_stack([a, b]),
     lambda r: [U(r, 3), U(r, 3, 2)], grad=(0, 1))
case(M, "combinations", lambda P, x: [P.combinations(x),
                                      P.combinations(x, 3, True)],
     lambda r: [U(r, 4)], fd_grad=(0,),
     note="the JAX package drops combinations' gradient")
case(M, "cumulative_trapezoid", lambda P, y, x: [
    P.cumulative_trapezoid(y, dx=0.5), P.cumulative_trapezoid(y, x, axis=1)],
    lambda r: [U(r, 3, 5), np.sort(U(r, 3, 5), axis=1)], grad=(0, 1))
case(M, "diagonal_scatter", lambda P, x, y: P.diagonal_scatter(x, y, 1),
     lambda r: [U(r, 4, 5), U(r, 4)], grad=(0, 1))
case(M, "disable_signal_handler",
     lambda P: P.disable_signal_handler() is None)
case(M, "dsplit", lambda P, x: P.dsplit(x, 2), lambda r: [U(r, 2, 3, 4)],
     grad=(0,))
case(M, "dtype", lambda P: P.dtype("float32") == P.float32)
case(M, "finfo", lambda P: [float(P.finfo("float32").eps),
                            float(P.finfo("float32").max),
                            float(P.finfo("bfloat16").eps),
                            P.finfo("float16").bits])
case(M, "iinfo", lambda P: [int(P.iinfo("int32").max),
                            int(P.iinfo("int8").min)])
case(M, "frexp", lambda P, x: list(P.frexp(x)),
     lambda r: [U(r, 3, 4, lo=-9, hi=9)])
case(M, "from_dlpack", lambda P, x: P.from_dlpack(P.to_dlpack(x)),
     lambda r: [U(r, 3, 4)], ref_raises=True, ref_fixed=lambda x: [x],
     note="the JAX package hands a DLPack capsule to jnp.from_dlpack, "
          "which takes only arrays (ROADMAP §C)")
case(M, "to_dlpack", lambda P, x: P.from_dlpack(P.to_dlpack(x * 2.0)),
     lambda r: [U(r, 2, 3)], ref_raises=True, ref_fixed=lambda x: [x * 2],
     note="as from_dlpack")
case(M, "histogram_bin_edges", lambda P, x: [
    P.histogram_bin_edges(x, bins=5), P.histogram_bin_edges(x, 4, -2, 3)],
    lambda r: [U(r, 10)])
case(M, "hsplit", lambda P, x: P.hsplit(x, 2), lambda r: [U(r, 3, 4)],
     grad=(0,))
case(M, "vsplit", lambda P, x: P.vsplit(x, [1, 3]), lambda r: [U(r, 4, 3)],
     grad=(0,))
case(M, "tensor_split", lambda P, x: P.tensor_split(x, 3, axis=1)
     + P.tensor_split(x, [1, 4], axis=1), lambda r: [U(r, 2, 7)],
     fd_grad=(0,), note="the JAX package drops tensor_split's gradient")
case(M, "in_dynamic_mode", lambda P: P.in_dynamic_mode())
case(M, "index_fill", lambda P, x, i: P.index_fill(x, i, 1, 9.0),
     lambda r: [U(r, 3, 4), np.array([0, 2], np.int64)], grad=(0,))
case(M, "is_complex", lambda P, x: [P.is_complex(x),
                                    P.is_complex(P.complex(x, x))],
     lambda r: [U(r, 2)])
case(M, "is_floating_point", lambda P, x, i: [P.is_floating_point(x),
                                              P.is_floating_point(i)],
     lambda r: [U(r, 2), I(r, 2)])
case(M, "is_integer", lambda P, x, i: [P.is_integer(x), P.is_integer(i)],
     lambda r: [U(r, 2), I(r, 2)])
case(M, "isin", lambda P, x, t: [P.isin(x, t), P.isin(x, t, invert=True)],
     lambda r: [I(r, 3, 4), I(r, 5)])
case(M, "isneginf", lambda P, x: P.isneginf(x), lambda r: [_with_inf(r)])
case(M, "isposinf", lambda P, x: P.isposinf(x), lambda r: [_with_inf(r)])
case(M, "less", lambda P, a, b: P.less(a, b),
     lambda r: [U(r, 3, 4), U(r, 3, 4)])
case(M, "matrix_transpose", lambda P, x: P.matrix_transpose(x),
     lambda r: [U(r, 2, 3, 4)], grad=(0,))
case(M, "multigammaln", lambda P, x: P.multigammaln(x, 3),
     lambda r: [U(r, 3, 4, lo=2.0, hi=4.0)], grad=(0,))
case(M, "nanquantile", lambda P, x: [P.nanquantile(x, 0.3, axis=1),
                                     P.nanquantile(x, np.array([.25, .75])),
                                     P.nanquantile(x, 0.5, axis=0,
                                                   keepdim=True)],
     lambda r: [_with_nan(r)], grad=(0,))
case(M, "pdist", lambda P, x: [P.pdist(x), P.pdist(x, p=3.0)],
     lambda r: [U(r, 4, 3)], grad=(0,))
case(M, "polar", lambda P, a, t: P.polar(a, t),
     lambda r: [U(r, 3, lo=0.5, hi=2.0), U(r, 3)])
case(M, "positive", lambda P, x: P.positive(x), lambda r: [U(r, 3)],
     grad=(0,))
case(M, "rank", lambda P, x: P.rank(x), lambda r: [U(r, 2, 3, 4)])
case(M, "reverse", lambda P, x: P.reverse(x, [0, 1]), lambda r: [U(r, 3, 4)],
     grad=(0,))
case(M, "row_stack", lambda P, a, b: P.row_stack([a, b]),
     lambda r: [U(r, 2, 3), U(r, 3)], grad=(0, 1))
case(M, "set_printoptions", lambda P: P.set_printoptions(precision=8)
     is None)
case(M, "sgn", lambda P, x: P.sgn(x), lambda r: [U(r, 3, 4)])
case(M, "signbit", lambda P, x: P.signbit(x), lambda r: [U(r, 3, 4)])
case(M, "sinc", lambda P, x: P.sinc(x), lambda r: [U(r, 3, 4, lo=-3, hi=3)],
     grad=(0,))
case(M, "slice_scatter", lambda P, x, v: P.slice_scatter(
    x, v, axes=[0], starts=[1], ends=[5], strides=[2]),
    lambda r: [U(r, 5, 3), U(r, 2, 3)], grad=(0, 1))
case(M, "t_alias", lambda P, x: P.ops.extras.t_alias(x),
     lambda r: [U(r, 2, 3, 4)],
     grad=(0,))
case(M, "take", lambda P, x, i, j: [P.take(x, i), P.take(x, j, mode="wrap"),
                                    P.take(x, j, mode="clip")],
     lambda r: [U(r, 3, 4), np.array([[0, 5], [11, 2]], np.int64),
                np.array([13, -1, 30, -20], np.int64)], grad=(0,))
case(M, "tolist", lambda P, x: P.tolist(x), lambda r: [U(r, 2, 3)])


def _lenet_like(P):
    return P.nn.Sequential(P.nn.Conv2D(1, 4, 3), P.nn.ReLU(),
                           P.nn.Flatten(), P.nn.Linear(4 * 6 * 6, 5))


case(M, "flops", lambda P: P.flops(_lenet_like(P), [2, 1, 8, 8]))
case(M, "summary", lambda P: [P.summary(_lenet_like(P))[k] for k in
                              ("total_params", "trainable_params")])
case(M, "trapezoid", lambda P, y, x: [P.trapezoid(y, dx=0.5),
                                      P.trapezoid(y, x, axis=0)],
     lambda r: [U(r, 4, 3), np.sort(U(r, 4, 3), axis=0)], grad=(0, 1))
case(M, "unflatten", lambda P, x: P.unflatten(x, 1, [2, 3]),
     lambda r: [U(r, 4, 6)], grad=(0,))
case(M, "unfold", lambda P, x: P.unfold(x, 1, 3, 2), lambda r: [U(r, 2, 7)],
     grad=(0,))
case(M, "vander", lambda P, x: [P.vander(x), P.vander(x, 3, True)],
     lambda r: [U(r, 4)], grad=(0,))
case(M, "vecdot", lambda P, a, b: P.vecdot(a, b, axis=0),
     lambda r: [U(r, 3, 4), U(r, 3, 4)], grad=(0, 1))
case(M, "view_as", lambda P, x, o: P.view_as(x, o),
     lambda r: [U(r, 2, 6), U(r, 3, 4)], grad=(0,))


def _in_lazy_guard(P, x):
    with P.LazyGuard():
        return x * 2.0


# --------------------------------------------------------------------------
# legacy_ps (`ops/legacy_ps.py`): the sampling ops draw from numpy's
# RandomState(seed) in both packages, so they are compared value for value
# --------------------------------------------------------------------------
M = "legacy_ps"


def _rank_offset(r):
    # B = 4, max_rank = 2: [own rank, (rank_k, row_k) for k < 2]; rank 0
    # marks an invalid instance or neighbour
    return np.array([[1, 1, 0, 2, 3], [2, 1, 2, 0, 0], [0, 1, 1, 2, 2],
                     [2, 2, 3, 1, 1]], np.int64)


def _tree():
    # rows [item_id, layer_id, parent_id, child_0, child_1]
    return np.array([[0, 0, 0, 1, 2], [0, 1, 0, 3, 4], [0, 1, 0, 5, 0],
                     [7, 2, 1, 0, 0], [8, 2, 1, 0, 0], [9, 2, 2, 0, 0]],
                    np.int64)


case(M, "batch_fc", lambda P, x, w, b: P.batch_fc(x, w, b),
     lambda r: [U(r, 2, 3, 4), U(r, 2, 4, 5), U(r, 2, 5)], grad=(0, 1, 2))
case(M, "rank_attention", lambda P, x, ro, p: P.rank_attention(
    x, ro, p, max_rank=2), lambda r: [U(r, 4, 3), _rank_offset(r),
                                      U(r, 12, 5)], grad=(0, 2))
case(M, "match_matrix_tensor", lambda P, x, y, w: list(
    P.match_matrix_tensor(x, y, w, dim_t=2)),
    lambda r: [U(r, 2, 3, 4), U(r, 2, 5, 4), U(r, 4, 2, 4)], grad=(0, 1, 2))
case(M, "tdm_child", lambda P, x, t: list(P.tdm_child(x, t, 2)),
     lambda r: [np.array([[0, 1], [2, 1]], np.int64), _tree()])
case(M, "tdm_sampler", lambda P, x, tr, ly: list(P.tdm_sampler(
    x, tr, ly, neg_samples_num_list=[1, 2], layer_offset=[0, 3, 7],
    seed=5, dtype=3)),
    lambda r: [I(r, 3, 1), np.array([[1, 4], [2, 0], [3, 6]], np.int64),
               np.arange(1, 8, dtype=np.int64)])
case(M, "class_center_sample", lambda P, lab: list(P.class_center_sample(
    lab, 20, 8, fix_seed=True, seed=3)), lambda r: [I(r, 6, hi=20)])
case(M, "SelectedRows", lambda P, v: [P.SelectedRows([3, 1], v).value,
                                      P.SelectedRows([3, 1], v).height],
     lambda r: [U(r, 2, 3)])
case(M, "merge_selected_rows", lambda P, v: P.merge_selected_rows(
    P.SelectedRows([0, 2, 0, 5], v)).value, lambda r: [U(r, 4, 3)],
    fd_grad=(0,), note="the JAX package drops merge_selected_rows' "
    "gradient")
case(M, "pyramid_hash", lambda P, x, w: [
    P.pyramid_hash(x, w, num_emb=4, space_len=16, rand_len=2),
    P.pyramid_hash(x, w, num_emb=4, space_len=16, rand_len=2,
                   pyramid_layer=3, black_list=np.array([5], np.int64))],
    lambda r: [I(r, 2, 6, hi=9), U(r, 18, 1)])

# --------------------------------------------------------------------------
# fft (`fft.py`): complex outputs are compared as complex; gradients only
# through real outputs (irfft, hfft, ...)
# --------------------------------------------------------------------------
M = "fft"
_C2C = {"fft": {}, "ifft": {"norm": "ortho"}, "rfft": {"n": 8},
        "ihfft": {"norm": "forward"}}
for _name, _kw in _C2C.items():
    case(M, _name, (lambda n, kw: lambda P, x: getattr(P.fft, n)(x, **kw))(
        _name, _kw), lambda r: [U(r, 3, 6)])
for _name, _kw in {"irfft": {"n": 8}, "hfft": {"norm": "ortho"}}.items():
    case(M, _name, (lambda n, kw: lambda P, x: getattr(P.fft, n)(x, **kw))(
        _name, _kw), lambda r: [U(r, 3, 5)], grad=(0,))
for _name in ("fft2", "ifft2", "rfft2", "fftn", "ifftn", "rfftn"):
    case(M, _name, (lambda n: lambda P, x: getattr(P.fft, n)(
        x, norm="ortho"))(_name), lambda r: [U(r, 2, 4, 6)])
for _name in ("irfft2", "irfftn"):
    case(M, _name, (lambda n: lambda P, x: getattr(P.fft, n)(x, s=[4, 6]))(
        _name), lambda r: [U(r, 2, 4, 4)], grad=(0,))
case(M, "fftfreq", lambda P: [P.fft.fftfreq(8, 0.5), P.fft.fftfreq(5)])
case(M, "rfftfreq", lambda P: [P.fft.rfftfreq(8, 0.5), P.fft.rfftfreq(5)])
case(M, "fftshift", lambda P, x: P.fft.fftshift(x), lambda r: [U(r, 4, 5)],
     grad=(0,))
case(M, "ifftshift", lambda P, x: P.fft.ifftshift(x, axes=[1]),
     lambda r: [U(r, 4, 5)], grad=(0,))

# --------------------------------------------------------------------------
# nn.functional: activation, common, norm
# --------------------------------------------------------------------------


def _F(P):
    return P.nn.functional


M = "functional.activation"
_ACT = {
    "relu": {}, "relu6": {}, "sigmoid": {}, "tanh": {}, "silu": {},
    "swish": {}, "mish": {}, "leaky_relu": {"negative_slope": 0.2},
    "elu": {"alpha": 0.7}, "selu": {}, "celu": {"alpha": 1.5},
    "hardtanh": {"min": -0.5, "max": 0.7}, "hardshrink": {},
    "softshrink": {"threshold": 0.3}, "tanhshrink": {}, "hardsigmoid": {},
    "hardswish": {}, "softplus": {"beta": 2, "threshold": 3},
    "softsign": {}, "log_sigmoid": {}, "thresholded_relu": {
        "threshold": 0.2},
    "rrelu": {"training": False}, "glu": {"axis": 1},
    "softmax": {"axis": 1}, "log_softmax": {"axis": 0},
}
for _name, _kw in _ACT.items():
    case(M, _name, (lambda n, kw: lambda P, x: getattr(_F(P), n)(x, **kw))(
        _name, _kw), lambda r: [U(r, 3, 4, lo=-4, hi=4)], grad=(0,))
case(M, "gelu", lambda P, x: [_F(P).gelu(x), _F(P).gelu(x, True)],
     lambda r: [U(r, 3, 4, lo=-3, hi=3)], grad=(0,))
case(M, "prelu", lambda P, x, w: [_F(P).prelu(x, w),
                                  _F(P).prelu(x, w[:1])],
     lambda r: [U(r, 2, 3, 4, 4), U(r, 3)], grad=(0, 1))
case(M, "maxout", lambda P, x: _F(P).maxout(x, 2, axis=1),
     lambda r: [U(r, 2, 6, 3)], grad=(0,))
case(M, "swiglu", lambda P, x, y: [_F(P).swiglu(x), _F(P).swiglu(x, y)],
     lambda r: [U(r, 3, 8), U(r, 3, 8)], grad=(0, 1))
case(M, "relu_", lambda P, x: _F(P).relu_(x * 1.0), lambda r: [U(r, 3, 4)],
     fd_grad=(0,), note="the JAX package's in-place form keeps a stale node "
     "and drops the gradient (ROADMAP §C)")
case(M, "softmax_", lambda P, x: _F(P).softmax_(x * 1.0),
     lambda r: [U(r, 3, 4)], fd_grad=(0,), note="as relu_")
case(M, "gumbel_softmax", None, check="random")

M = "functional.common"
case(M, "linear", lambda P, x, w, b: [_F(P).linear(x, w, b),
                                      _F(P).linear(x, w)],
     lambda r: [U(r, 2, 3, 4), U(r, 4, 5), U(r, 5)], grad=(0, 1, 2))
for _name in ("dropout", "dropout2d", "dropout3d", "alpha_dropout"):
    case(M, _name, None, check="random")
case(M, "embedding", lambda P, i, w: _F(P).embedding(i, w, padding_idx=2),
     lambda r: [I(r, 2, 3, hi=6), U(r, 6, 4)], grad=(1,))
case(M, "one_hot", lambda P, i: _F(P).one_hot(i, 5),
     lambda r: [I(r, 2, 3, hi=5)])
case(M, "label_smooth", lambda P, x, p: [_F(P).label_smooth(x),
                                         _F(P).label_smooth(x, p, 0.2)],
     lambda r: [U(r, 2, 4, lo=0, hi=1), U(r, 1, 4, lo=0, hi=1)], grad=(0,))
case(M, "pad", lambda P, x: [
    _F(P).pad(x, [1, 2, 0, 1]),
    _F(P).pad(x, [1, 1, 2, 0], mode="reflect"),
    _F(P).pad(x, [2, 1], mode="replicate"),
    _F(P).pad(x, [1, 2, 2, 1], mode="circular", data_format="NHWC"),
    _F(P).pad(x, [0, 0, 1, 0, 0, 1, 2, 0], value=0.5)],
    lambda r: [U(r, 2, 3, 4, 5)], grad=(0,))
case(M, "zeropad2d", lambda P, x: _F(P).zeropad2d(x, [1, 0, 2, 1]),
     lambda r: [U(r, 1, 2, 3, 3)], grad=(0,))
case(M, "pad3d", lambda P, x: [
    _F(P).pad3d(x, [1, 0, 0, 1, 1, 1]),
    _F(P).pad3d(x, [1, 1, 1, 0, 0, 1], mode="reflect"),
    _F(P).pad3d(x, [0, 1, 1, 0, 1, 0], mode="replicate",
                data_format="NDHWC")],
    lambda r: [U(r, 1, 2, 3, 3, 4)], grad=(0,))
# interpolate: the modes where jax.image.resize computes Paddle's formula
# (upsampling by whole factors, half-pixel sources); `upsample` holds the
# rest to a numpy oracle of Paddle's formulas
case(M, "interpolate", lambda P, x, v: [
    _F(P).interpolate(x, scale_factor=2),
    _F(P).interpolate(x, size=[6, 10], mode="bilinear"),
    _F(P).interpolate(v, scale_factor=3, mode="linear", data_format="NCW"),
    _F(P).interpolate(x, scale_factor=[2, 3], data_format="NHWC")],
    lambda r: [U(r, 1, 2, 3, 5), U(r, 2, 3, 4)], grad=(0, 1))
case(M, "upsample", lambda P, x: _resize_cases(P, x),
     lambda r: [U(r, 1, 2, 5, 6)], ref_departs=True,
     ref_fixed=lambda x: _np_resize_cases(x), fd_grad=(0,),
     note="jax.image.resize ignores align_corners and align_mode, maps "
          "area to linear and antialiases when it shrinks (ROADMAP §C)")
case(M, "unfold", lambda P, x: [_F(P).unfold(x, 2), _F(P).unfold(
    x, [2, 3], strides=[1, 2], paddings=1, dilations=[2, 1])],
    lambda r: [U(r, 2, 3, 5, 6)], grad=(0,))
case(M, "unfold", lambda P, x: _F(P).unfold(x, [2, 2], paddings=[1, 0, 2,
                                                                 1]),
     lambda r: [U(r, 1, 2, 4, 5)], variant="paddings", ref_departs=True,
     ref_fixed=lambda x: [_np_unfold(x, (2, 2), (1, 0, 2, 1))],
     fd_grad=(0,), note="the JAX package reads four paddings as [top, "
     "bottom, left, right]; Paddle's order is [top, left, bottom, right]")
case(M, "fold", lambda P, x: [
    _F(P).fold(x, [4, 5], 2),
    _F(P).fold(x, [3, 5], [2, 2], strides=[1, 2], paddings=1)],
    lambda r: [U(r, 2, 12, 12)], grad=(0,))
case(M, "cosine_similarity", lambda P, a, b: _F(P).cosine_similarity(a, b),
     lambda r: [U(r, 3, 4), U(r, 3, 4)], grad=(0, 1))
case(M, "pixel_shuffle", lambda P, x, y: [
    _F(P).pixel_shuffle(x, 2), _F(P).pixel_shuffle(y, 2, "NHWC")],
    lambda r: [U(r, 1, 8, 2, 3), U(r, 1, 2, 3, 8)], grad=(0, 1))
case(M, "pixel_unshuffle", lambda P, x, y: [
    _F(P).pixel_unshuffle(x, 2), _F(P).pixel_unshuffle(y, 2, "NHWC")],
    lambda r: [U(r, 1, 2, 4, 6), U(r, 1, 4, 6, 2)], grad=(0, 1))
case(M, "channel_shuffle", lambda P, x, y: [
    _F(P).channel_shuffle(x, 2), _F(P).channel_shuffle(y, 3, "NHWC")],
    lambda r: [U(r, 1, 6, 2, 2), U(r, 1, 2, 2, 6)], grad=(0, 1))
case(M, "bilinear", lambda P, a, b, w, c: [_F(P).bilinear(a, b, w, c),
                                           _F(P).bilinear(a, b, w)],
     lambda r: [U(r, 3, 4), U(r, 3, 5), U(r, 2, 4, 5), U(r, 2)],
     grad=(0, 1, 2, 3))
case(M, "affine_grid", lambda P, t, u: [
    _F(P).affine_grid(t, [2, 3, 4, 5]),
    _F(P).affine_grid(t, [2, 3, 3, 4], align_corners=False),
    _F(P).affine_grid(u, [1, 2, 2, 3, 4])],
    lambda r: [U(r, 2, 2, 3), U(r, 1, 3, 4)], grad=(0, 1))
case(M, "grid_sample", lambda P, x, g: [
    _F(P).grid_sample(x, g),
    _F(P).grid_sample(x, g, padding_mode="border", align_corners=False),
    _F(P).grid_sample(x, g, mode="nearest"),
    _F(P).grid_sample(x, g * 1.5, padding_mode="reflection")],
    lambda r: [U(r, 2, 3, 4, 5), U(r, 2, 3, 2, 2, lo=-1.1, hi=1.1)],
    grad=(0, 1))
case(M, "sequence_mask", lambda P, x: [_F(P).sequence_mask(x),
                                       _F(P).sequence_mask(x, 6, "float32")],
     lambda r: [I(r, 2, 3, lo=1, hi=5)])
case(M, "temporal_shift", lambda P, x: [
    _F(P).temporal_shift(x, 2), _F(P).temporal_shift(
        x, 2, 0.25, data_format="NHWC")],
    lambda r: [U(r, 4, 8, 2, 2)], grad=(0,))
case(M, "gather_tree", lambda P, i, p: _F(P).gather_tree(i, p),
     lambda r: [I(r, 4, 2, 3, hi=9), I(r, 4, 2, 3, hi=3)])

M = "functional.norm"
case(M, "layer_norm", lambda P, x, w, b: [
    _F(P).layer_norm(x, 5, w, b), _F(P).layer_norm(x, [4, 5])],
    lambda r: [U(r, 2, 4, 5), U(r, 5), U(r, 5)], grad=(0, 1, 2))
case(M, "rms_norm", lambda P, x, w: [_F(P).rms_norm(x, w),
                                     _F(P).rms_norm(x, epsilon=1e-5)],
     lambda r: [U(r, 2, 3, 8), U(r, 8)], grad=(0, 1))
case(M, "batch_norm", lambda P, x, m, v, w, b: _batch_norm(P, x, m, v, w, b),
     lambda r: [U(r, 4, 3, 2, 2), U(r, 3), U(r, 3, lo=0.5, hi=1.5), U(r, 3),
                U(r, 3)], grad=(0, 3, 4))
case(M, "instance_norm", lambda P, x, w, b: [
    _F(P).instance_norm(x, weight=w, bias=b),
    _F(P).instance_norm(x, data_format="NHWC")],
    lambda r: [U(r, 2, 3, 4, 4), U(r, 3), U(r, 3)], grad=(0, 1, 2))
case(M, "group_norm", lambda P, x, w, b: [
    _F(P).group_norm(x, 2, weight=w, bias=b),
    _F(P).group_norm(x, 3, data_format="NHWC")],
    lambda r: [U(r, 2, 6, 3, 6), U(r, 6), U(r, 6)], grad=(0, 1, 2))
case(M, "local_response_norm", lambda P, x: [
    _F(P).local_response_norm(x, 3), _F(P).local_response_norm(
        x, 4, alpha=0.1, k=2.0, data_format="NHWC")],
    lambda r: [U(r, 2, 5, 3, 4)], grad=(0,))
case(M, "normalize", lambda P, x: [_F(P).normalize(x),
                                   _F(P).normalize(x, p=1, axis=0)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "spectral_norm", lambda P, w, u, v: _F(P).spectral_norm(
    w, u, v, dim=1, power_iters=2),
    lambda r: [U(r, 4, 3, 2), U(r, 3), U(r, 8)], grad=(0,))


def _batch_norm(P, x, m, v, w, b):
    """Inference with the running statistics, then training (the running
    statistics updated in place: compared after the call)."""
    F = _F(P)
    out = [F.batch_norm(x, m, v, w, b)]
    rm, rv = m * 1.0, v * 1.0
    out.append(F.batch_norm(x, rm, rv, w, b, training=True, momentum=0.8))
    return out + [rm, rv, F.batch_norm(x, None, None, data_format="NHWC",
                                       training=True)]


# -- numpy oracles of Paddle's formulas (`phi/kernels/funcs/
#    interpolate_function.h`, the interpolate kernels) ---------------------


def _np_axis_weights(n_in, n_out, mode, align_corners, align_mode,
                     scale=None):
    """The [n_out, n_in] matrix of one axis's interpolation, computed per
    output position the way Paddle's kernels do (f32 coordinates)."""
    f32 = np.float32
    if align_corners:
        ratio = f32((n_in - 1) / (n_out - 1)) if n_out > 1 else f32(0)
    elif scale:
        ratio = f32(1.0 / scale)
    else:
        ratio = f32(n_in / n_out)
    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        if mode == "nearest":
            src = ratio * f32(o) + (f32(0.5) if align_corners else f32(0))
            m[o, min(int(src), n_in - 1)] = 1.0
        elif mode == "linear":
            if align_mode == 0 and not align_corners:
                src = max(ratio * (f32(o) + f32(0.5)) - f32(0.5), f32(0))
            else:
                src = ratio * f32(o)
            i0 = min(int(src), n_in - 1)
            i1 = min(i0 + 1, n_in - 1)
            lam = float(src) - i0
            m[o, i0] += 1 - lam
            m[o, i1] += lam
        elif mode == "cubic":
            src = ratio * f32(o) if align_corners else \
                ratio * (f32(o) + f32(0.5)) - f32(0.5)
            base = int(np.floor(src))
            t = float(src) - base
            a = -0.75
            ws = [((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
                  ((a + 2) * t - (a + 3)) * t * t + 1,
                  ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1,
                  ((a * (2 - t) - 5 * a) * (2 - t) + 8 * a) * (2 - t)
                  - 4 * a]
            for j, w in enumerate(ws):
                m[o, min(max(base - 1 + j, 0), n_in - 1)] += w
        else:   # area: adaptive average pooling
            lo, hi = (o * n_in) // n_out, -(-((o + 1) * n_in) // n_out)
            m[o, lo:hi] = 1.0 / (hi - lo)
    return m


def _np_resize(x, out, mode, align_corners=False, align_mode=0,
               scales=None):
    y = x.astype(np.float64)
    for d, n_out in enumerate(out):
        m = _np_axis_weights(x.shape[2 + d], n_out, mode, align_corners,
                             align_mode, scales[d] if scales else None)
        y = np.moveaxis(np.tensordot(y, m, axes=([2 + d], [1])), -1, 2 + d)
    return y.astype(x.dtype)


def _resize_cases(P, x):
    F = _F(P)
    return [F.upsample(x, size=[8, 9], mode="bilinear", align_corners=True),
            F.upsample(x, size=[3, 4], mode="bilinear"),
            F.upsample(x, scale_factor=1.5, mode="bilinear", align_mode=1),
            F.upsample(x, size=[7, 8], mode="bicubic"),
            F.upsample(x, size=[4, 9], mode="bicubic", align_corners=True),
            F.upsample(x, size=[3, 4]),
            F.upsample(x, size=[8, 9], mode="nearest", align_corners=True),
            F.upsample(x, size=[3, 4], mode="area")]


def _np_resize_cases(x):
    return [_np_resize(x, [8, 9], "linear", True),
            _np_resize(x, [3, 4], "linear"),
            _np_resize(x, [7, 9], "linear", align_mode=1,
                       scales=[1.5, 1.5]),
            _np_resize(x, [7, 8], "cubic"),
            _np_resize(x, [4, 9], "cubic", True),
            _np_resize(x, [3, 4], "nearest"),
            _np_resize(x, [8, 9], "nearest", True),
            _np_resize(x, [3, 4], "area")]


def _np_unfold(x, k, pads):
    """im2col with Paddle's four paddings [top, left, bottom, right]."""
    top, left, bottom, right = pads
    xp = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)))
    n, c, h, w = xp.shape
    oh, ow = h - k[0] + 1, w - k[1] + 1
    cols = np.zeros((n, c, k[0], k[1], oh, ow), x.dtype)
    for i in range(k[0]):
        for j in range(k[1]):
            cols[:, :, i, j] = xp[:, :, i:i + oh, j:j + ow]
    return cols.reshape(n, c * k[0] * k[1], oh * ow)

# --------------------------------------------------------------------------
# nn.functional: loss, conv, pooling, extra_fns, the rest of flash attention
# --------------------------------------------------------------------------
M = "functional.loss"


def _p(r, *shape):
    return r.uniform(0.05, 0.95, shape).astype(np.float32)


def _pm1(r, *shape):
    return np.where(r.uniform(size=shape) > 0.5, 1.0, -1.0).astype(
        np.float32)


case(M, "cross_entropy", lambda P, x, lab, w, soft: [
    _F(P).cross_entropy(x, lab),
    _F(P).cross_entropy(x, lab, weight=w, reduction="sum"),
    _F(P).cross_entropy(x, lab, ignore_index=2, label_smoothing=0.1),
    _F(P).cross_entropy(x, soft, soft_label=True, reduction="none")],
    lambda r: [U(r, 5, 4, lo=-3, hi=3), I(r, 5, hi=4), U(r, 4, lo=.5, hi=2),
               _p(r, 5, 4)], grad=(0, 2))
case(M, "softmax_with_cross_entropy", lambda P, x, lab: list(
    _F(P).softmax_with_cross_entropy(x, lab, return_softmax=True)),
    lambda r: [U(r, 5, 4), I(r, 5, 1, hi=4)], grad=(0,))
case(M, "nll_loss", lambda P, x, lab, w: [
    _F(P).nll_loss(x, lab), _F(P).nll_loss(x, lab, w, ignore_index=1),
    _F(P).nll_loss(x, lab, reduction="none")],
    lambda r: [U(r, 5, 4), I(r, 5, hi=4), U(r, 4, lo=.5, hi=2)],
    grad=(0, 2))
for _name in ("mse_loss", "l1_loss", "smooth_l1_loss", "huber_loss"):
    case(M, _name, (lambda n: lambda P, a, b: [
        getattr(_F(P), n)(a, b), getattr(_F(P), n)(a, b, reduction="sum"),
        getattr(_F(P), n)(a, b, reduction="none")])(_name),
        lambda r: [U(r, 3, 4, lo=-2, hi=2), U(r, 3, 4, lo=-2, hi=2)],
        grad=(0, 1))
case(M, "binary_cross_entropy", lambda P, p, t, w: [
    _F(P).binary_cross_entropy(p, t), _F(P).binary_cross_entropy(
        p, t, w, reduction="none")],
    lambda r: [_p(r, 3, 4), _p(r, 3, 4), U(r, 4)], grad=(0, 1, 2))
case(M, "binary_cross_entropy_with_logits", lambda P, z, t, w, pw: [
    _F(P).binary_cross_entropy_with_logits(z, t),
    _F(P).binary_cross_entropy_with_logits(z, t, w, pos_weight=pw,
                                           reduction="sum")],
    lambda r: [U(r, 3, 4, lo=-3, hi=3), _p(r, 3, 4), U(r, 4),
               U(r, 4, lo=.5, hi=2)], grad=(0, 1, 2, 3))
case(M, "kl_div", lambda P, lp, t: [
    _F(P).kl_div(lp, t), _F(P).kl_div(lp, t, reduction="batchmean"),
    _F(P).kl_div(lp, P.log(t), log_target=True, reduction="sum")],
    lambda r: [U(r, 3, 4, lo=-3, hi=0), _p(r, 3, 4)], grad=(0, 1))
case(M, "margin_ranking_loss", lambda P, a, b, t: [
    _F(P).margin_ranking_loss(a, b, t, margin=0.1),
    _F(P).margin_ranking_loss(a, b, t, reduction="none")],
    lambda r: [U(r, 6), U(r, 6), _pm1(r, 6)], grad=(0, 1))
case(M, "hinge_embedding_loss", lambda P, a, t: _F(P).hinge_embedding_loss(
    a, t, margin=0.5, reduction="none"),
    lambda r: [U(r, 3, 4, lo=-2, hi=2), _pm1(r, 3, 4)], grad=(0,))
case(M, "cosine_embedding_loss", lambda P, a, b, t: [
    _F(P).cosine_embedding_loss(a, b, t, margin=0.2),
    _F(P).cosine_embedding_loss(a, b, t, reduction="none")],
    lambda r: [U(r, 4, 5), U(r, 4, 5), _pm1(r, 4)], grad=(0, 1))
case(M, "triplet_margin_loss", lambda P, a, p, n: [
    _F(P).triplet_margin_loss(a, p, n),
    _F(P).triplet_margin_loss(a, p, n, p=1.5, swap=True, reduction="none")],
    lambda r: [U(r, 4, 5), U(r, 4, 5), U(r, 4, 5)], grad=(0, 1, 2))
case(M, "sigmoid_focal_loss", lambda P, z, t, n: [
    _F(P).sigmoid_focal_loss(z, t), _F(P).sigmoid_focal_loss(
        z, t, n, gamma=1.5, reduction="mean")],
    lambda r: [U(r, 3, 4, lo=-3, hi=3), _p(r, 3, 4).round(),
               np.array([3.0], np.float32)], grad=(0,))
case(M, "log_loss", lambda P, p, t: _F(P).log_loss(p, t),
     lambda r: [_p(r, 4, 1), _p(r, 4, 1).round()], grad=(0,))
case(M, "square_error_cost", lambda P, a, b: _F(P).square_error_cost(a, b),
     lambda r: [U(r, 3, 4), U(r, 3, 4)], grad=(0, 1))
case(M, "ctc_loss", lambda P, lp, lab, il, ll: [
    _F(P).ctc_loss(lp, lab, il, ll),
    _F(P).ctc_loss(lp, lab, il, ll, reduction="none")],
    lambda r: [U(r, 6, 2, 5, lo=-2, hi=2),
               np.array([[1, 2], [3, 3]], np.int64),
               np.array([6, 5], np.int64), np.array([2, 2], np.int64)],
    grad=(0,))
case(M, "npair_loss", lambda P, a, p, lab: _F(P).npair_loss(a, p, lab),
     lambda r: [U(r, 4, 5), U(r, 4, 5), np.array([0, 1, 0, 2], np.int64)],
     grad=(0, 1))
case(M, "dice_loss", lambda P, p, lab: _F(P).dice_loss(p, lab),
     lambda r: [_p(r, 2, 3, 4), I(r, 2, 3, 1, hi=4)], grad=(0,))
case(M, "identity_loss", lambda P, x: [_F(P).identity_loss(x, "sum"),
                                       _F(P).identity_loss(x, 1),
                                       _F(P).identity_loss(x)],
     lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "margin_cross_entropy", lambda P, c, lab: list(
    _F(P).margin_cross_entropy(c, lab, scale=8.0, return_softmax=True)),
    lambda r: [U(r, 4, 6, lo=-.9, hi=.9), I(r, 4, hi=6)], grad=(0,))
case(M, "hsigmoid_loss", lambda P, x, lab, w, b: [
    _F(P).hsigmoid_loss(x, lab, 6, w, b), _F(P).hsigmoid_loss(x, lab, 6, w)],
    lambda r: [U(r, 4, 5), I(r, 4, hi=6), U(r, 5, 5), U(r, 5, 1)],
    grad=(0, 2, 3))
_RNNT = lambda r: [U(r, 2, 3, 3, 4, lo=-2, hi=2),                # noqa: E731
                   np.array([[1, 2], [3, 1]], np.int64),
                   np.array([3, 2], np.int64), np.array([2, 1], np.int64)]
case(M, "warprnnt", lambda P, x, lab, il, ll: [
    _F(P).warprnnt(x, lab, il, ll), _F(P).warprnnt(
        x, lab, il, ll, fastemit_lambda=0.01)], _RNNT, grad=(0,))
case(M, "rnnt_loss", lambda P, x, lab, il, ll: [
    _F(P).rnnt_loss(x, lab, il, ll), _F(P).rnnt_loss(
        x, lab, il, ll, reduction="none")], _RNNT, grad=(0,))

# convolutions: f32 on the CPU in both packages, at the f32 bars
M = "functional.conv"
case(M, "conv1d", lambda P, x, w, b, w2: [
    _F(P).conv1d(x, w, b, stride=2, padding=1, dilation=2, groups=2),
    _F(P).conv1d(x, w2, padding="SAME", stride=2),
    _F(P).conv1d(x, w2, padding=[1, 2])],
    lambda r: [U(r, 2, 4, 9), U(r, 6, 2, 3), U(r, 6), U(r, 3, 4, 3)],
    grad=(0, 1, 2, 3))
case(M, "conv2d", lambda P, x, w, b, xh: [
    _F(P).conv2d(x, w, b, padding=[1, 0, 2, 1]),
    _F(P).conv2d(xh, w, padding="SAME", stride=[2, 1], data_format="NHWC"),
    _F(P).conv2d(x, w, padding="VALID", dilation=2)],
    lambda r: [U(r, 2, 3, 6, 7), U(r, 4, 3, 3, 2), U(r, 4), U(r, 2, 6, 7, 3)],
    grad=(0, 1, 2, 3))
case(M, "conv3d", lambda P, x, w: _F(P).conv3d(x, w, padding=1,
                                                stride=[1, 2, 1]),
     lambda r: [U(r, 1, 2, 4, 5, 4), U(r, 3, 2, 2, 3, 2)], grad=(0, 1))
case(M, "conv1d_transpose", lambda P, x, w, b: [
    _F(P).conv1d_transpose(x, w, b, stride=2, padding=1, output_padding=1),
    _F(P).conv1d_transpose(x, w, dilation=2)],
    lambda r: [U(r, 2, 4, 5), U(r, 4, 3, 3), U(r, 3)], grad=(0, 1, 2))
case(M, "conv1d_transpose", lambda P, x, w, wg: [
    _F(P).conv1d_transpose(x, w, stride=2, padding="SAME"),
    _F(P).conv1d_transpose(x, w, stride=2, padding="VALID"),
    _F(P).conv1d_transpose(x, wg, stride=2, padding=1, groups=2,
                           dilation=2)],
    lambda r: [U(r, 2, 4, 5), U(r, 4, 3, 3), U(r, 4, 2, 3)],
    variant="paddle", ref_raises=True, fd_grad=(0, 1, 2),
    ref_fixed=lambda x, w, wg: [
        _np_conv_t1d(x, w, 2, "SAME"), _np_conv_t1d(x, w, 2, "VALID"),
        _np_conv_t1d(x, wg, 2, 1, groups=2, dilation=2)],
    note="the JAX package's transposed convolution raises on 'SAME' / "
         "'VALID' and on groups > 1 (ROADMAP §C)")
case(M, "conv2d_transpose", lambda P, x, w, b, xh: [
    _F(P).conv2d_transpose(x, w, b, stride=2, padding=[1, 0]),
    _F(P).conv2d_transpose(xh, w, stride=[1, 2], dilation=2,
                           data_format="NHWC")],
    lambda r: [U(r, 1, 3, 4, 5), U(r, 3, 2, 3, 3), U(r, 2), U(r, 1, 4, 5, 3)],
    grad=(0, 1, 2, 3))
case(M, "conv3d_transpose", lambda P, x, w: _F(P).conv3d_transpose(
    x, w, stride=2), lambda r: [U(r, 1, 2, 3, 3, 2), U(r, 2, 3, 2, 2, 2)],
    grad=(0, 1))

M = "functional.pooling"
case(M, "max_pool1d", lambda P, x: [_F(P).max_pool1d(x, 3, 2, 1)] + list(
    _F(P).max_pool1d(x, 2, return_mask=True)),
    lambda r: [U(r, 2, 3, 9)], grad=(0,))
_MASK_NOTE = ("with padding, the JAX package's return_mask indices come "
              "from patches of a -inf padded input, whose NaNs make argmax "
              "give 0 (ROADMAP §C); the indices are held to numpy")
case(M, "max_pool2d", lambda P, x, xh: [
    _F(P).max_pool2d(x, 3, 2, 1), _F(P).max_pool2d(x, [2, 3]),
    _F(P).max_pool2d(xh, 2, data_format="NHWC")] + list(
    _F(P).max_pool2d(x, 3, 2, 1, return_mask=True)),
    lambda r: [U(r, 2, 3, 7, 8), U(r, 2, 6, 4, 3)], grad=(0, 1),
    ref_fixed=lambda x, xh: [None] * 4 + [_np_pool_index(
        x, (3, 3), (2, 2), ((1, 1), (1, 1)))], fixed_outputs=(4,),
    note=_MASK_NOTE)
case(M, "max_pool3d", lambda P, x: [_F(P).max_pool3d(x, 2, 2)] + list(
    _F(P).max_pool3d(x, [2, 3, 2], 1, 1, return_mask=True)),
    lambda r: [U(r, 1, 2, 5, 6, 5)], grad=(0,),
    ref_fixed=lambda x: [None] * 2 + [_np_pool_index(
        x, (2, 3, 2), (1, 1, 1), ((1, 1),) * 3)], fixed_outputs=(2,),
    note=_MASK_NOTE)
case(M, "avg_pool1d", lambda P, x: [
    _F(P).avg_pool1d(x, 3, 2, 1), _F(P).avg_pool1d(x, 3, 2, 1,
                                                   exclusive=False)],
    lambda r: [U(r, 2, 3, 9)], grad=(0,))
case(M, "avg_pool2d", lambda P, x, xh: [
    _F(P).avg_pool2d(x, 3, 2, 1), _F(P).avg_pool2d(x, 3, 2, 1,
                                                   exclusive=False),
    _F(P).avg_pool2d(xh, 2, data_format="NHWC")],
    lambda r: [U(r, 2, 3, 7, 8), U(r, 2, 6, 4, 3)], grad=(0, 1))
case(M, "avg_pool3d", lambda P, x: _F(P).avg_pool3d(x, 2, [1, 2, 2], 1),
     lambda r: [U(r, 1, 2, 4, 5, 4)], grad=(0,))
case(M, "max_pool2d", lambda P, x: [
    _F(P).max_pool2d(x, 2, 2, ceil_mode=True),
    _F(P).max_pool2d(x, 3, 2, [1, 0, 0, 1], ceil_mode=True)],
    lambda r: [U(r, 1, 2, 5, 7)], variant="ceil_mode", ref_departs=True,
    fd_grad=(0,), ref_fixed=lambda x: [
        _np_pool(x, (2, 2), (2, 2), ((0, 0), (0, 0)), True, "max"),
        _np_pool(x, (3, 3), (2, 2), ((1, 0), (0, 1)), True, "max")],
    note="the JAX package ignores ceil_mode")
case(M, "avg_pool2d", lambda P, x: [
    _F(P).avg_pool2d(x, 2, 2, ceil_mode=True),
    _F(P).avg_pool2d(x, 3, 2, "SAME"),
    _F(P).avg_pool2d(x, 2, 1, 1, divisor_override=3)],
    lambda r: [U(r, 1, 2, 5, 7)], variant="paddle", ref_departs=True,
    fd_grad=(0,), ref_fixed=lambda x: [
        _np_pool(x, (2, 2), (2, 2), ((0, 0), (0, 0)), True, "avg"),
        _np_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1)), False, "avg"),
        _np_pool(x, (2, 2), (1, 1), ((1, 1), (1, 1)), False, "avg",
                 divisor=3)],
    note="the JAX package ignores ceil_mode and divisor_override and "
         "divides 'SAME' windows by the kernel's size, not their elements")
case(M, "avg_pool1d", lambda P, x: _F(P).avg_pool1d(x, 2, 2, ceil_mode=True),
     lambda r: [U(r, 1, 2, 7)], variant="ceil_mode", ref_departs=True,
     fd_grad=(0,), ref_fixed=lambda x: [
         _np_pool(x, (2,), (2,), ((0, 0),), True, "avg")],
     note="the JAX package ignores ceil_mode")
for _n in (1, 2, 3):
    _shape = (2, 3) + (7, 6, 5)[:_n]
    _even = (1, 3, 5)[:_n] if _n < 3 else (7, 3, 5)
    case(M, f"adaptive_avg_pool{_n}d", (lambda n: lambda P, x: [
        getattr(_F(P), f"adaptive_avg_pool{n}d")(x, (3, 4, 2)[:n] if n > 1
                                                  else 3),
        getattr(_F(P), f"adaptive_avg_pool{n}d")(x, 1)])(_n),
        (lambda s: lambda r: [U(r, *s)])(_shape), grad=(0,))
    case(M, f"adaptive_max_pool{_n}d", (lambda n, e: lambda P, x: [
        getattr(_F(P), f"adaptive_max_pool{n}d")(x, (3, 4, 2)[:n] if n > 1
                                                  else 3)] + list(
        getattr(_F(P), f"adaptive_max_pool{n}d")(x, e if n > 1 else 7,
                                                  return_mask=True)))(
        _n, _even), (lambda s: lambda r: [U(r, *s)])(_shape), grad=(0,))
case(M, "lp_pool2d", lambda P, x: [_F(P).lp_pool2d(x, 2, 2),
                                   _F(P).lp_pool2d(x, 3, 3, 1, 1)],
     lambda r: [U(r, 1, 2, 5, 6)], grad=(0,))
for _n, _shape in ((1, (2, 3, 8)), (2, (1, 2, 4, 6)), (3, (1, 2, 4, 4, 2))):
    case(M, f"max_unpool{_n}d", (lambda n: lambda P, x: getattr(
        _F(P), f"max_unpool{n}d")(*getattr(_F(P), f"max_pool{n}d")(
            x, 2, return_mask=True), 2))(_n),
        (lambda s: lambda r: [U(r, *s)])(_shape), grad=(0,))
case(M, "fractional_max_pool2d", lambda P, x: [
    _F(P).fractional_max_pool2d(x, [3, 4], random_u=0.3),
    _F(P).fractional_max_pool2d(x, 3, kernel_size=3, random_u=0.7)],
    lambda r: [U(r, 1, 2, 7, 9)], fd_grad=(0,),
    note="the JAX package drops fractional_max_pool's gradient")
case(M, "fractional_max_pool3d", lambda P, x: _F(P).fractional_max_pool3d(
    x, [2, 3, 2], random_u=0.45), lambda r: [U(r, 1, 2, 5, 6, 4)],
    fd_grad=(0,), note="the JAX package drops fractional_max_pool's "
    "gradient")

M = "functional.extra_fns"
case(M, "pairwise_distance", lambda P, a, b: [
    _F(P).pairwise_distance(a, b), _F(P).pairwise_distance(
        a, b, p=1.0, keepdim=True)],
    lambda r: [U(r, 3, 4), U(r, 3, 4)], grad=(0, 1))
case(M, "poisson_nll_loss", lambda P, a, lab: [
    _F(P).poisson_nll_loss(a, lab), _F(P).poisson_nll_loss(
        P.exp(a), lab, log_input=False, full=True, reduction="none")],
    lambda r: [U(r, 3, 4), r.integers(0, 5, (3, 4)).astype(np.float32)],
    grad=(0,))
case(M, "gaussian_nll_loss", lambda P, mu, lab, var: [
    _F(P).gaussian_nll_loss(mu, lab, var), _F(P).gaussian_nll_loss(
        mu, lab, var, full=True, reduction="sum")],
    lambda r: [U(r, 3, 4), U(r, 3, 4), U(r, 3, 4, lo=.1, hi=2)],
    grad=(0, 1, 2))
case(M, "soft_margin_loss", lambda P, a, t: _F(P).soft_margin_loss(a, t),
     lambda r: [U(r, 3, 4), _pm1(r, 3, 4)], grad=(0,))
case(M, "multi_label_soft_margin_loss", lambda P, a, t, w: [
    _F(P).multi_label_soft_margin_loss(a, t),
    _F(P).multi_label_soft_margin_loss(a, t, w, reduction="none")],
    lambda r: [U(r, 3, 4), _p(r, 3, 4).round(), U(r, 4)], grad=(0, 2))
case(M, "multi_margin_loss", lambda P, a, t, w: [
    _F(P).multi_margin_loss(a, t), _F(P).multi_margin_loss(
        a, t, p=2, margin=0.5, weight=w, reduction="none")],
    lambda r: [U(r, 4, 5), I(r, 4, hi=5), U(r, 5)], grad=(0, 2))
case(M, "triplet_margin_with_distance_loss", lambda P, a, p, n: [
    _F(P).triplet_margin_with_distance_loss(a, p, n),
    _F(P).triplet_margin_with_distance_loss(a, p, n, swap=True,
                                            reduction="none")],
    lambda r: [U(r, 4, 5), U(r, 4, 5), U(r, 4, 5)], grad=(0, 1, 2))
case(M, "adaptive_log_softmax_with_loss",
     lambda P, x, lab, hw, hb, a1, b1, a2, b2: list(
         _F(P).adaptive_log_softmax_with_loss(
             x, lab, hw, [[a1, b1], [a2, b2]], [4, 7, 10], head_bias=hb)),
     lambda r: [U(r, 6, 4), np.array([0, 3, 4, 6, 8, 9], np.int64),
                U(r, 4, 6), U(r, 6), U(r, 4, 2), U(r, 2, 3), U(r, 4, 2),
                U(r, 2, 3)], grad=(0, 2, 3, 4, 5, 6, 7))
case(M, "feature_alpha_dropout", None, check="random")
case(M, "lp_pool1d", lambda P, x: [_F(P).lp_pool1d(x, 2, 3),
                                   _F(P).lp_pool1d(x, 3, 2, 1, 1)],
     lambda r: [U(r, 2, 3, 8)], grad=(0,))
for _name, _kw in (("elu_", {}), ("hardtanh_", {"min": -.3}),
                   ("leaky_relu_", {"negative_slope": .1}), ("tanh_", {}),
                   ("thresholded_relu_", {"threshold": .2})):
    case(M, _name, (lambda n, kw: lambda P, x: getattr(_F(P), n)(
        x * 1.0, **kw))(_name, _kw), lambda r: [U(r, 3, 4)], grad=(0,))
case(M, "class_center_sample", lambda P, lab: list(
    _F(P).class_center_sample(lab, 20, 4)),
    lambda r: [np.array([3, 7, 3, 12, 19, 7], np.int64)])
case(M, "flashmask_attention", lambda P, q, k, v, s1, s2: [
    _F(P).flashmask_attention(q, k, v, s1, causal=True),
    _F(P).flashmask_attention(q, k, v, s2)],
    lambda r: [U(r, 1, 8, 2, 16), U(r, 1, 8, 2, 16), U(r, 1, 8, 2, 16),
               _startend(1), _startend(2)], grad=(0, 1, 2))
case(M, "sparse_attention", lambda P, q, k, v, off, col: _F(
    P).sparse_attention(q, k, v, off, col),
    lambda r: [U(r, 1, 2, 4, 8), U(r, 1, 2, 4, 8), U(r, 1, 2, 4, 8),
               np.tile(np.array([0, 1, 3, 5, 7], np.int64), (1, 2, 1)),
               np.tile(np.array([0, 0, 1, 1, 2, 0, 3], np.int64),
                       (1, 2, 1))], grad=(0, 1, 2))


def _startend(k):
    """[1, 2, 8, k] FlashMask row bounds per key column j: rows >= start
    masked (k = 1: start 8 for even j, j + 2 for odd), or rows in [j + 3,
    j + 5) (k = 2); no query row loses its own key."""
    j = np.arange(8)
    if k == 1:
        b = np.where(j % 2 == 0, 8, j + 2)[..., None]
    else:
        b = np.stack([j + 3, j + 5], -1)
    return np.broadcast_to(b, (1, 2, 8, k)).astype(np.int64).copy()


M = "functional.flash_attention"
case(M, "flash_attn_unpadded", lambda P, q, k, v: [
    _F(P).flash_attn_unpadded(q, k, v, [0, 3, 7], [0, 3, 7], 4, 4)[0],
    _F(P).flash_attn_unpadded(q, k, v, [0, 3, 7], [0, 3, 7], 4, 4,
                              causal=True, scale=0.2)[0]],
    lambda r: [U(r, 7, 2, 16), U(r, 7, 2, 16), U(r, 7, 2, 16)],
    grad=(0, 1, 2))
case(M, "flash_attn_varlen_qkvpacked", lambda P, qkv: _F(
    P).flash_attn_varlen_qkvpacked(qkv, [0, 2, 5], [0, 2, 5], 3, 3)[0],
    lambda r: [U(r, 5, 3, 2, 16)], grad=(0,))
case(M, "sdp_kernel", lambda P, q, k, v: _in_sdp_kernel(P, q, k, v),
     lambda r: [U(r, 1, 4, 2, 16), U(r, 1, 4, 2, 16), U(r, 1, 4, 2, 16)],
     grad=(0, 1, 2))


def _in_sdp_kernel(P, q, k, v):
    with _F(P).sdp_kernel():
        return _F(P).scaled_dot_product_attention(q, k, v, is_causal=True)


def _np_pool(x, k, s, pairs, ceil_mode, kind, divisor=None,
             exclusive=True):
    """Paddle's pooling: out = ceil or floor((in + pads - k) / s) + 1 per
    dim; each window [o s - before, o s - before + k) meets the input;
    max over that part, the average over its elements (or / divisor)."""
    dtype, x = x.dtype, x.astype(np.float64)
    sp = x.shape[2:]
    outs = []
    for size, kk, ss, (lo, hi) in zip(sp, k, s, pairs):
        span = size + lo + hi - kk
        outs.append((-(-span // ss) if ceil_mode else span // ss) + 1)
    out = np.zeros(x.shape[:2] + tuple(outs))
    for o in np.ndindex(*outs):
        sl = []
        for d, od in enumerate(o):
            st = od * s[d] - pairs[d][0]
            sl.append(slice(max(st, 0), min(st + k[d], sp[d])))
        win = x[(Ellipsis,) + tuple(sl)].reshape(x.shape[:2] + (-1,))
        if kind == "max":
            out[(Ellipsis,) + o] = win.max(-1)
        else:
            count = divisor or (win.shape[-1] if exclusive
                                else int(np.prod(k)))
            out[(Ellipsis,) + o] = win.sum(-1) / count
    return out.astype(dtype)


def _np_conv_t1d(x, w, s, padding, groups=1, dilation=1):
    """Paddle's 1-D transposed convolution, w [in, out / groups, k]: input
    position i adds x[i] w[:, :, j] at output i s + j d (channel groups
    apart); the full output, (in - 1) s + d (k - 1) + 1 long, is cropped
    by an int p on each side, 'VALID' (nothing) or 'SAME' (to in s, the
    extra crop after)."""
    n, cin, length = x.shape
    k, og = w.shape[2], w.shape[1]
    ig = cin // groups
    full = (length - 1) * s + dilation * (k - 1) + 1
    out = np.zeros((n, og * groups, full))
    for g in range(groups):
        xs, ws = x[:, g * ig:(g + 1) * ig], w[g * ig:(g + 1) * ig]
        for i in range(length):
            for j in range(k):
                out[:, g * og:(g + 1) * og, i * s + j * dilation] += \
                    xs[:, :, i] @ ws[:, :, j]
    if padding == "SAME":
        total = max(full - length * s, 0)
        out = out[:, :, total // 2:full - (total - total // 2)]
    elif isinstance(padding, int) and padding:
        out = out[:, :, padding:full - padding]
    return out.astype(x.dtype)


def _np_pool_index(x, k, s, pairs):
    """The flat index, in its (N, C) spatial slab, of each window's first
    maximum over the window's part inside the input."""
    sp = x.shape[2:]
    outs = [(size + lo + hi - kk) // ss + 1
            for size, kk, ss, (lo, hi) in zip(sp, k, s, pairs)]
    out = np.zeros(x.shape[:2] + tuple(outs), np.int64)
    for b, c in np.ndindex(*x.shape[:2]):
        for o in np.ndindex(*outs):
            best, arg = -np.inf, 0
            starts = [od * s[d] - pairs[d][0] for d, od in enumerate(o)]
            for off in np.ndindex(*k):
                pos = [st + of for st, of in zip(starts, off)]
                if all(0 <= p < n for p, n in zip(pos, sp)) and \
                        x[(b, c) + tuple(pos)] > best:
                    best = x[(b, c) + tuple(pos)]
                    arg = int(np.ravel_multi_index(pos, sp))
            out[(b, c) + o] = arg
    return out


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


def _departs(c, ref, expect):
    """True when the JAX package's outputs `ref` differ from the oracle's
    `expect` somewhere (shape or value)."""
    for r, e in zip(ref, expect):
        r, e = np.asarray(r, np.float64), np.asarray(e, np.float64)
        if r.shape != e.shape or not np.allclose(r, e, rtol=FWD_RTOL,
                                                 atol=FWD_ATOL):
            return True
    return False


def check_against(ref_module, port_module, c):
    """The parity check of one case: the port's outputs (and gradients)
    against the JAX package's, or against `ref_fixed` where the JAX
    package's op raises or departs from Paddle's formula (then the JAX
    package's outputs must differ from the oracle's, which confirms the
    departure on every run)."""
    got, got_grads = run(port_module, c)
    if c.ref_departs:
        expect = c.ref_fixed(*c.make_inputs())
        ref, _ = run(ref_module, c, with_grad=False)
        assert _departs(c, ref, expect), (
            f"{c.id}: the JAX package now agrees with the oracle; compare "
            "with it again")
        compare(Case(c.module, c.name, c.fn), expect, got)
        return
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
