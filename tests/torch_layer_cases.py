"""The layer table the nn parity tests share: one case per layer class of
the JAX package's `paddle_tpu.nn` (139), each building its layer and
calling it through a module argument `P`: `paddle_tpu` (the JAX package)
or `paddle_tpu_torch` (the port), so one function drives both.

`run` builds the layer, loads a state dict into it when given one (the
JAX layer's, carried across as numpy), calls it on inputs made with numpy
from the case's own seed, and gives the outputs, the gradients of
sum_i sum(out_i * w_i) with respect to the chosen inputs and to every
parameter, and the buffers after the call, all as numpy.

Random layers (the dropout family, RReLU) are `check="random"`: their
training forms are held to seed reproducibility and to their statistics
(`RANDOM_STATS`), their inference forms to the JAX package.

This module imports neither JAX nor any package under test: the card test
(`test_torch_eager_cuda.py`) runs the same table on the card.
"""

import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

RTOL, ATOL = 1e-5, 1e-6      # f32 bars, forward and gradients


@dataclass
class LCase:
    name: str                     # the nn class the case covers
    make: Callable                # make(P) -> layer
    inputs: Callable = lambda r: []   # inputs(rng) -> numpy arrays
    grad: tuple = ()              # indices of inputs to differentiate
    call: Callable = None         # call(P, layer, *tensors) -> output(s)
    check: str = "value"          # value | random
    train: bool = True            # the layer's mode during the call
    ref_fixed: Callable = None    # numpy oracle where the JAX package
    #                               departs from Paddle's formula
    note: str = ""
    group: str = ""               # the test file that runs the case

    @property
    def id(self):
        return self.name

    def make_inputs(self):
        rng = np.random.default_rng(zlib.crc32(self.id.encode()))
        return self.inputs(rng)


def U(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def I(r, *shape, lo=0, hi=10):
    return r.integers(lo, hi, shape).astype(np.int64)


def f(*shape, lo=-1.0, hi=1.0):
    return lambda r: [U(r, *shape, lo=lo, hi=hi)]


def pm1(r, *shape):
    return np.where(r.uniform(size=shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def log_probs(r, *shape):
    x = U(r, *shape, lo=-2, hi=2)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


CASES = []
# the case groups, one test file each, so that xdist spreads them
GROUPS = ("common", "conv_norm", "pool_loss", "loss_rnn", "transformer")
_group = GROUPS[0]


def case(name, make, inputs=lambda r: [], grad=(0,), **kw):
    kw.setdefault("group", _group)
    CASES.append(LCase(name, make, inputs, grad, **kw))


def group(name):
    assert name in GROUPS, name
    return [c for c in CASES if c.group == name]


# -- activations ------------------------------------------------------------
for _name, _args in (("ReLU", ()), ("ReLU6", ()), ("Sigmoid", ()),
                     ("Tanh", ()), ("GELU", (True,)), ("SiLU", ()),
                     ("Swish", ()), ("Mish", ()), ("LeakyReLU", (0.1,)),
                     ("ELU", (0.5,)), ("SELU", ()), ("CELU", (0.7,)),
                     ("Hardtanh", (-0.5, 0.5)), ("Hardshrink", (0.3,)),
                     ("Softshrink", (0.3,)), ("Tanhshrink", ()),
                     ("Hardsigmoid", ()), ("Hardswish", ()),
                     ("Softplus", (2, 10)), ("Softsign", ()),
                     ("LogSigmoid", ()), ("Softmax", (1,)),
                     ("LogSoftmax", ()), ("ThresholdedReLU", (0.2,)),
                     ("Maxout", (2, 1)), ("GLU", ()), ("Silu", ()),
                     ("Softmax2D", ())):
    case(_name, lambda P, n=_name, a=_args: getattr(P.nn, n)(*a),
         f(2, 6, 4, lo=-2, hi=2))
case("PReLU", lambda P: P.nn.PReLU(6, 0.2), f(2, 6, 4, lo=-2, hi=2))
case("RReLU", lambda P: P.nn.RReLU(0.1, 0.3), f(2, 6, 4, lo=-2, hi=2),
     note="the JAX package's layer calls F.rrelu without `training`, so "
     "its slope is (lower + upper) / 2 in both modes; the port keeps that")

# -- common -----------------------------------------------------------------
case("Identity", lambda P: P.nn.Identity(), f(2, 3))
case("Linear", lambda P: P.nn.Linear(4, 3), f(2, 5, 4))
case("Embedding", lambda P: P.nn.Embedding(10, 4, padding_idx=0),
     lambda r: [I(r, 2, 5)], grad=())
def normal(*shape):
    return lambda r: [r.standard_normal(shape).astype(np.float32)]


for _name, _inputs in (("Dropout", f(40, 50)),
                       ("Dropout2D", f(4, 50, 4, 5)),
                       ("Dropout3D", f(4, 50, 2, 2, 5)),
                       ("AlphaDropout", normal(100, 100)),
                       ("FeatureAlphaDropout", normal(4, 50, 4, 5))):
    case(_name, lambda P, n=_name: getattr(P.nn, n)(0.3), _inputs,
         check="random")
case("Flatten", lambda P: P.nn.Flatten(), f(2, 3, 2, 2))
case("Upsample", lambda P: P.nn.Upsample(scale_factor=2), f(1, 2, 3, 3))
case("UpsamplingNearest2D", lambda P: P.nn.UpsamplingNearest2D(
    scale_factor=2), f(1, 2, 3, 3))


def _bilinear_corners(x):
    from torch_op_cases import _np_resize

    return [_np_resize(x, [6, 6], "linear", True)]


case("UpsamplingBilinear2D", lambda P: P.nn.UpsamplingBilinear2D(
    scale_factor=2), f(1, 2, 3, 3), grad=(), ref_fixed=_bilinear_corners,
    note="jax.image.resize ignores align_corners (ROADMAP §C): the port "
    "is held to Paddle's formula")
case("Pad1D", lambda P: P.nn.Pad1D([1, 2]), f(2, 3, 5))
case("Pad2D", lambda P: P.nn.Pad2D([1, 1, 2, 0], mode="reflect"),
     f(1, 2, 3, 4))
case("Pad3D", lambda P: P.nn.Pad3D([1, 0, 1, 1, 0, 2]), f(1, 2, 2, 3, 3))
case("ZeroPad1D", lambda P: P.nn.ZeroPad1D(2), f(2, 3, 5))
case("ZeroPad2D", lambda P: P.nn.ZeroPad2D([1, 0, 2, 1]), f(1, 2, 3, 3))
case("ZeroPad3D", lambda P: P.nn.ZeroPad3D(1), f(1, 2, 2, 3, 3))
case("CosineSimilarity", lambda P: P.nn.CosineSimilarity(axis=1),
     lambda r: [U(r, 3, 5), U(r, 3, 5)], grad=(0, 1))
case("Bilinear", lambda P: P.nn.Bilinear(3, 4, 5),
     lambda r: [U(r, 2, 3), U(r, 2, 4)], grad=(0, 1))
case("PixelShuffle", lambda P: P.nn.PixelShuffle(2), f(1, 8, 2, 2))
case("PixelUnshuffle", lambda P: P.nn.PixelUnshuffle(2), f(1, 2, 4, 4))
case("ChannelShuffle", lambda P: P.nn.ChannelShuffle(2), f(1, 4, 2, 2))
case("Unfold", lambda P: P.nn.Unfold(2), f(1, 2, 4, 4))
case("Fold", lambda P: P.nn.Fold([4, 4], 2), f(1, 8, 9))
case("Unflatten", lambda P: P.nn.Unflatten(1, [2, 3]), f(2, 6, 4))
case("PairwiseDistance", lambda P: P.nn.PairwiseDistance(),
     lambda r: [U(r, 3, 5), U(r, 3, 5)], grad=(0, 1))

# -- convolutions -------------------------------------------------------------
_group = "conv_norm"
case("Conv1D", lambda P: P.nn.Conv1D(2, 4, 3, padding=1), f(2, 2, 8))
case("Conv2D", lambda P: P.nn.Conv2D(2, 4, 3, padding=1), f(2, 2, 5, 5))
case("Conv3D", lambda P: P.nn.Conv3D(2, 4, 3), f(1, 2, 4, 4, 4))
case("Conv1DTranspose", lambda P: P.nn.Conv1DTranspose(2, 4, 3, stride=2),
     f(2, 2, 5))
case("Conv2DTranspose", lambda P: P.nn.Conv2DTranspose(2, 4, 3, stride=2),
     f(1, 2, 3, 3))
case("Conv3DTranspose", lambda P: P.nn.Conv3DTranspose(2, 3, 2),
     f(1, 2, 3, 3, 3))

# -- norms (training mode: batch statistics, the running ones updated) -------
case("BatchNorm", lambda P: P.nn.BatchNorm(4), f(3, 4, 5))
case("BatchNorm1D", lambda P: P.nn.BatchNorm1D(4), f(3, 4, 5))
case("BatchNorm2D", lambda P: P.nn.BatchNorm2D(4), f(3, 4, 2, 2))
case("BatchNorm3D", lambda P: P.nn.BatchNorm3D(4), f(2, 4, 2, 2, 2))
case("SyncBatchNorm", lambda P: P.nn.SyncBatchNorm(4), f(3, 4, 2, 2))
case("LayerNorm", lambda P: P.nn.LayerNorm(6), f(2, 3, 6))
case("RMSNorm", lambda P: P.nn.RMSNorm(8), f(2, 3, 8))
case("GroupNorm", lambda P: P.nn.GroupNorm(2, 4), f(2, 4, 3, 3))
case("InstanceNorm1D", lambda P: P.nn.InstanceNorm1D(4), f(2, 4, 6))
case("InstanceNorm2D", lambda P: P.nn.InstanceNorm2D(4), f(2, 4, 3, 3))
case("InstanceNorm3D", lambda P: P.nn.InstanceNorm3D(4), f(2, 4, 2, 2, 2))
case("LocalResponseNorm", lambda P: P.nn.LocalResponseNorm(3),
     f(2, 4, 3, 3))
case("SpectralNorm", lambda P: P.nn.SpectralNorm([4, 6]), f(4, 6))

# -- pooling ------------------------------------------------------------------
_group = "pool_loss"
for _n, _a, _shape in (("MaxPool1D", (2,), (2, 3, 8)),
                       ("MaxPool2D", (2, 2), (2, 3, 4, 4)),
                       ("MaxPool3D", (2,), (1, 2, 4, 4, 4)),
                       ("AvgPool1D", (2,), (2, 3, 8)),
                       ("AvgPool2D", (3, 2, 1), (2, 3, 5, 5)),
                       ("AvgPool3D", (2,), (1, 2, 4, 4, 4)),
                       ("AdaptiveAvgPool1D", (3,), (2, 3, 8)),
                       ("AdaptiveAvgPool2D", ([2, 3],), (2, 3, 6, 7)),
                       ("AdaptiveAvgPool3D", (2,), (1, 2, 4, 5, 4)),
                       ("AdaptiveMaxPool1D", (3,), (2, 3, 8)),
                       ("AdaptiveMaxPool2D", ([2, 3],), (2, 3, 6, 7)),
                       ("AdaptiveMaxPool3D", (2,), (1, 2, 4, 5, 4)),
                       ("LPPool1D", (2, 2), (2, 3, 8)),
                       ("LPPool2D", (2, 2), (2, 3, 4, 4))):
    case(_n, lambda P, n=_n, a=_a: getattr(P.nn, n)(*a), f(*_shape))


def _unpool(fn, k):
    def call(P, layer, x):
        y, idx = getattr(P.nn.functional, fn)(x, k, return_mask=True)
        return layer(y, idx)
    return call


case("MaxUnPool1D", lambda P: P.nn.MaxUnPool1D(2), f(2, 3, 8),
     call=_unpool("max_pool1d", 2))
case("MaxUnPool2D", lambda P: P.nn.MaxUnPool2D(2), f(1, 2, 4, 4),
     call=_unpool("max_pool2d", 2))
case("MaxUnPool3D", lambda P: P.nn.MaxUnPool3D(2), f(1, 2, 4, 4, 4),
     call=_unpool("max_pool3d", 2))
case("FractionalMaxPool2D", lambda P: P.nn.FractionalMaxPool2D(
    3, random_u=0.3), f(1, 2, 6, 6), grad=(),
    note="the JAX package drops fractional_max_pool's gradient")
case("FractionalMaxPool3D", lambda P: P.nn.FractionalMaxPool3D(
    2, random_u=0.3), f(1, 2, 4, 4, 4), grad=(),
    note="the JAX package drops fractional_max_pool's gradient")

# -- losses -------------------------------------------------------------------
case("CrossEntropyLoss", lambda P: P.nn.CrossEntropyLoss(),
     lambda r: [U(r, 4, 5), I(r, 4, hi=5)])
case("NLLLoss", lambda P: P.nn.NLLLoss(),
     lambda r: [log_probs(r, 4, 5), I(r, 4, hi=5)])
for _n in ("MSELoss", "L1Loss", "SmoothL1Loss", "HuberLoss"):
    case(_n, lambda P, n=_n: getattr(P.nn, n)(),
         lambda r: [U(r, 3, 4, lo=-2, hi=2), U(r, 3, 4)], grad=(0, 1))
case("BCELoss", lambda P: P.nn.BCELoss(),
     lambda r: [U(r, 3, 4, lo=0.05, hi=0.95),
                (U(r, 3, 4) > 0).astype(np.float32)])
case("BCEWithLogitsLoss", lambda P: P.nn.BCEWithLogitsLoss(),
     lambda r: [U(r, 3, 4, lo=-2, hi=2), (U(r, 3, 4) > 0).astype(np.float32)])
case("KLDivLoss", lambda P: P.nn.KLDivLoss(reduction="batchmean"),
     lambda r: [log_probs(r, 3, 4), np.exp(log_probs(r, 3, 4))],
     grad=(0, 1))
case("MarginRankingLoss", lambda P: P.nn.MarginRankingLoss(0.1),
     lambda r: [U(r, 5), U(r, 5), pm1(r, 5)], grad=(0, 1))
case("HingeEmbeddingLoss", lambda P: P.nn.HingeEmbeddingLoss(0.5),
     lambda r: [U(r, 3, 4, lo=0, hi=1), pm1(r, 3, 4)])
case("CosineEmbeddingLoss", lambda P: P.nn.CosineEmbeddingLoss(0.1),
     lambda r: [U(r, 3, 5), U(r, 3, 5), pm1(r, 3)], grad=(0, 1))
case("TripletMarginLoss", lambda P: P.nn.TripletMarginLoss(),
     lambda r: [U(r, 3, 5), U(r, 3, 5), U(r, 3, 5)], grad=(0, 1, 2))
case("TripletMarginWithDistanceLoss",
     lambda P: P.nn.TripletMarginWithDistanceLoss(margin=0.5),
     lambda r: [U(r, 3, 5), U(r, 3, 5), U(r, 3, 5)], grad=(0, 1, 2))
_group = "loss_rnn"
case("CTCLoss", lambda P: P.nn.CTCLoss(),
     lambda r: [log_probs(r, 6, 2, 5), np.array([[1, 2], [3, 3]], np.int64),
                np.array([6, 5], np.int64), np.array([2, 2], np.int64)])
case("RNNTLoss", lambda P: P.nn.RNNTLoss(),
     lambda r: [U(r, 2, 3, 3, 4, lo=-2, hi=2),
                np.array([[1, 2], [3, 1]], np.int64),
                np.array([3, 2], np.int64), np.array([2, 1], np.int64)])
case("GaussianNLLLoss", lambda P: P.nn.GaussianNLLLoss(),
     lambda r: [U(r, 3, 4), U(r, 3, 4), U(r, 3, 4, lo=0.2, hi=1.0)],
     grad=(0, 1, 2))
case("PoissonNLLLoss", lambda P: P.nn.PoissonNLLLoss(),
     lambda r: [U(r, 3, 4), U(r, 3, 4, lo=0.0, hi=3.0)])
case("SoftMarginLoss", lambda P: P.nn.SoftMarginLoss(),
     lambda r: [U(r, 3, 4), pm1(r, 3, 4)])
case("MultiLabelSoftMarginLoss", lambda P: P.nn.MultiLabelSoftMarginLoss(),
     lambda r: [U(r, 3, 4), (U(r, 3, 4) > 0).astype(np.float32)])
case("MultiMarginLoss", lambda P: P.nn.MultiMarginLoss(),
     lambda r: [U(r, 3, 4), I(r, 3, hi=4)])
case("HSigmoidLoss", lambda P: P.nn.HSigmoidLoss(5, 6),
     lambda r: [U(r, 4, 5), I(r, 4, hi=6)])
case("AdaptiveLogSoftmaxWithLoss",
     lambda P: P.nn.AdaptiveLogSoftmaxWithLoss(8, 10, [4, 7],
                                               head_bias=True),
     lambda r: [U(r, 6, 8), np.array([0, 3, 4, 6, 8, 9], np.int64)],
     group="transformer")

# -- transformer (dropout 0, head_dim 4: the plain attention path) -----------
_group = "transformer"
case("MultiHeadAttention", lambda P: P.nn.MultiHeadAttention(8, 2),
     f(2, 3, 8))
case("TransformerEncoderLayer", lambda P: P.nn.TransformerEncoderLayer(
    8, 2, 16, dropout=0.0), f(2, 3, 8))
case("TransformerEncoder", lambda P: P.nn.TransformerEncoder(
    P.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2), f(2, 3, 8))
case("TransformerDecoderLayer", lambda P: P.nn.TransformerDecoderLayer(
    8, 2, 16, dropout=0.0, normalize_before=True),
    lambda r: [U(r, 2, 3, 8), U(r, 2, 4, 8)], grad=(0, 1))
case("TransformerDecoder", lambda P: P.nn.TransformerDecoder(
    P.nn.TransformerDecoderLayer(8, 2, 16, dropout=0.0), 2),
    lambda r: [U(r, 2, 3, 8), U(r, 2, 4, 8)], grad=(0, 1))
case("Transformer", lambda P: P.nn.Transformer(
    8, 2, 1, 1, 16, dropout=0.0),
    lambda r: [U(r, 2, 4, 8), U(r, 2, 3, 8)], grad=(0, 1))

# -- recurrent ----------------------------------------------------------------
_group = "loss_rnn"
case("SimpleRNN", lambda P: P.nn.SimpleRNN(4, 5, num_layers=2), f(2, 3, 4))
case("LSTM", lambda P: P.nn.LSTM(4, 5, direction="bidirect"), f(2, 3, 4))
case("GRU", lambda P: P.nn.GRU(4, 5), f(2, 3, 4))
case("SimpleRNNCell", lambda P: P.nn.SimpleRNNCell(4, 5), f(2, 4))
case("LSTMCell", lambda P: P.nn.LSTMCell(4, 5), f(2, 4))
case("GRUCell", lambda P: P.nn.GRUCell(4, 5), f(2, 4))
case("RNN", lambda P: P.nn.RNN(P.nn.GRUCell(4, 5)), f(2, 3, 4))
case("BiRNN", lambda P: P.nn.BiRNN(P.nn.LSTMCell(4, 5),
                                   P.nn.LSTMCell(4, 5)), f(2, 3, 4))


def _user_cell(P):
    class Cell(P.nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.lin = P.nn.Linear(9, 5)

        @property
        def state_shape(self):
            return [5]

        def forward(self, x, h):
            h = P.tanh(self.lin(P.concat([x, h], axis=-1)))
            return h, h

    return P.nn.RNN(Cell())


case("RNNCellBase", _user_cell, f(2, 3, 4))

# -- containers and the base class -------------------------------------------
_group = "common"
case("Sequential", lambda P: P.nn.Sequential(
    P.nn.Linear(4, 3), P.nn.ReLU(), P.nn.Linear(3, 2)), f(2, 4))


def _each(P, layer, x):
    for sub in layer:
        x = sub(x)
    return x


case("LayerList", lambda P: P.nn.LayerList(
    [P.nn.Linear(4, 4), P.nn.Tanh(), P.nn.Linear(4, 2)]), f(2, 4),
    call=_each)
case("LayerDict", lambda P: P.nn.LayerDict(
    {"a": P.nn.Linear(4, 3), "b": P.nn.Linear(3, 2)}), f(2, 4),
    call=lambda P, layer, x: layer["b"](layer["a"](x)))


def _params(P, n):
    maker = P.nn.Layer()
    return [maker.create_parameter([4, 4]),
            maker.create_parameter([4], is_bias=True)][:n]


case("ParameterList", lambda P: P.nn.ParameterList(_params(P, 2)), f(2, 4),
     call=lambda P, pl, x: P.matmul(x, pl[0]) + pl[1])
case("ParameterDict", lambda P: P.nn.ParameterDict(
    dict(zip(("w", "b"), _params(P, 2)))), f(2, 4),
    call=lambda P, pd, x: P.matmul(x, pd["w"]) + pd["b"])


def _user_layer(P):
    class Net(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 3)
            self.scale = self.create_parameter([3], default_initializer=
                                               P.nn.initializer.Constant(2.0))
            self.register_buffer("shift", P.to_tensor(
                np.arange(3, dtype=np.float32)))

        def forward(self, x):
            return self.fc(x) * self.scale + self.shift

    return Net()


case("Layer", _user_layer, f(2, 4))

# the statistics the random layers' training forms are held to: a function
# of (input, output) numpy arrays that asserts
RANDOM_STATS = {}


def _share(mask, p, n):
    assert abs(mask.mean() - p) <= 6 * np.sqrt(p * (1 - p) / n), \
        (mask.mean(), p)


def _dropout_stats(x, y):
    kept = y != 0
    np.testing.assert_allclose(y[kept], x[kept] / 0.7, rtol=1e-6)
    _share(~kept, 0.3, x.size)


def _channel_stats(x, y):
    z = (y == 0).reshape(y.shape[0] * y.shape[1], -1)
    assert np.all(z.all(1) | ~z.any(1))   # a whole channel kept or dropped
    _dropout_stats(x, y)


def _alpha_stats(x, y):
    # alpha dropout keeps a standard normal input's mean 0 and variance 1;
    # every dropped element takes one value, a * alpha' + b
    n = y.size
    assert abs(y.mean()) <= 6 / np.sqrt(n) and \
        abs(y.var() - 1) <= 6 * np.sqrt(2 / n), (y.mean(), y.var())
    vals, counts = np.unique(y, return_counts=True)
    _share(y == vals[counts.argmax()], 0.3, y.size)


RANDOM_STATS.update(Dropout=_dropout_stats, Dropout2D=_channel_stats,
                    Dropout3D=_channel_stats, AlphaDropout=_alpha_stats,
                    FeatureAlphaDropout=_alpha_stats)


def by_name():
    return {c.name: c for c in CASES}


def _flatten(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flatten(o)]
    return [out]


def to_numpy(t):
    return np.asarray(t.numpy())


def _is_float(t):
    return "float" in str(t.dtype)


def run(P, c, state=None, train=None, with_grad=True):
    """(layer, outputs, input grads, {param name: grad}, {buffer: value})
    of case `c` through module `P`, all numpy. `state`: numpy arrays to
    load first (structured names); `train`: the mode (default c.train)."""
    layer = c.make(P)
    if state is not None:
        missing, unexpected = layer.set_state_dict(state)
        assert not missing and not unexpected, (c.id, missing, unexpected)
    if not (c.train if train is None else train):
        layer.eval()
    arrays = c.make_inputs()
    ts = [P.to_tensor(a, stop_gradient=not (with_grad and i in c.grad))
          for i, a in enumerate(arrays)]
    out = c.call(P, layer, *ts) if c.call else layer(*ts)
    outs = _flatten(out)
    vals = [to_numpy(o) for o in outs]
    params = dict(layer.named_parameters())
    in_grads, p_grads = [], {}
    if with_grad:
        rng = np.random.default_rng(zlib.crc32(c.id.encode()) + 1)
        loss = None
        for o in outs:
            if o.stop_gradient or not _is_float(o):
                continue
            w = P.to_tensor(rng.uniform(-1, 1, o.shape).astype(np.float32))
            term = P.sum(o * w)
            loss = term if loss is None else loss + term
        if loss is not None:
            loss.backward()
        in_grads = [None if ts[i].grad is None else to_numpy(ts[i].grad)
                    for i in c.grad]
        p_grads = {n: None if p.grad is None else to_numpy(p.grad)
                   for n, p in params.items()}
    buffers = {n: to_numpy(b) for n, b in layer.named_buffers()}
    return layer, vals, in_grads, p_grads, buffers


def close(ref, got, what, rtol=RTOL, atol=ATOL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    if ref.dtype.kind in "iub" or got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    np.testing.assert_allclose(got.astype(np.float64), ref, rtol=rtol,
                               atol=atol, err_msg=what)


def _close_grad(r, g, what, rtol, atol):
    """A gradient that never arrived (None) counts as zeros: JAX's vjp
    gives zeros for an input the function ignores, torch gives none."""
    if r is None and g is None:
        return
    if r is None or g is None:
        have = g if r is None else r
        np.testing.assert_array_equal(have, np.zeros_like(have),
                                      err_msg=what)
        return
    close(r, g, what, rtol, atol)


def compare(c, ref, got, rtol=RTOL, atol=ATOL):
    """Hold one run (`run`'s tuple minus the layer) to another: outputs,
    input gradients, every parameter's gradient and the buffers."""
    (r_vals, r_in, r_p, r_buf), (g_vals, g_in, g_p, g_buf) = ref, got
    assert len(r_vals) == len(g_vals), (c.id, len(r_vals), len(g_vals))
    for i, (r, g) in enumerate(zip(r_vals, g_vals)):
        close(r, g, f"{c.id} output {i}", rtol, atol)
    for i, (r, g) in zip(c.grad, zip(r_in, g_in)):
        _close_grad(r, g, f"{c.id} grad of input {i}", rtol, atol)
    assert list(r_p) == list(g_p), (c.id, list(r_p), list(g_p))
    for n in r_p:
        _close_grad(r_p[n], g_p[n], f"{c.id} grad of {n}", rtol, atol)
    assert list(r_buf) == list(g_buf), (c.id, list(r_buf), list(g_buf))
    for n in r_buf:
        close(r_buf[n], g_buf[n], f"{c.id} buffer {n}", rtol, atol)
